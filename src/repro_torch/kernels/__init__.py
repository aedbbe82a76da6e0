"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (see ``build`` for how they are compiled and loaded)."""
