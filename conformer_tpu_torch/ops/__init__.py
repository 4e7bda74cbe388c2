"""Hand-written CUDA kernels with their plain PyTorch versions, and host ops."""
