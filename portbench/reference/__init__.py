"""The plain float32 reference that decides ``correct``.

Plain PyTorch, written apart from the port: it imports nothing of
``siss_tpu_torch`` and takes nothing the port has made. Parameters are a
dict of tensors under the diffusers names, which the harness makes from the
seed and hands to both sides.
"""
