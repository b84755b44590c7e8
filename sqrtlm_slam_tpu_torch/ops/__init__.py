"""Hand-written CUDA kernel wrappers and their plain PyTorch twins."""
