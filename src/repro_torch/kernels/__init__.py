"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (``ref.py``); ``ops.py`` is the public surface."""
