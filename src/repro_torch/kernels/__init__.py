"""Hand-written Hopper kernels of the port, each beside its plain torch
version (``ref.py``) and its public wrapper (``ops.py``)."""
