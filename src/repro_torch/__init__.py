"""PyTorch/CUDA port of the ODCL server round (``src/repro`` is the JAX
reference).  Imports ``torch`` and never ``jax`` or ``repro``; the
sub-packages mirror ``repro``'s paths."""
