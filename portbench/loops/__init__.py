"""The traffic loops, one file a kind, found by the ``kind`` of a traffic
file (``portbench.manifest.loop``). Each holds a ``Work`` (built from the
configuration's model, the traffic, the seed and the device), with
``set_up()``, ``window(seconds, trace, log)``, ``answers()`` and
``release()``, and the module functions ``reference`` and ``compare``
that decide ``correct``."""
