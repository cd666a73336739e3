"""Hand-written CUDA kernels and their plain PyTorch versions."""
