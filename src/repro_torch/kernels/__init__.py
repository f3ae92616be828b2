"""Hand-written Hopper kernels (``csrc/``), their ctypes wrappers, their
plain PyTorch versions, and the device dispatch in ``ops``."""
