"""Model families: how to build the port's model of a configuration, and
which reference forward computes the same. A configuration file names its
family; ``portbench.manifest.family`` loads ``families/<family>.py``."""
