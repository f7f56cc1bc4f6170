"""Attention operators: the flash forward and backward, each a CUDA kernel
behind a wrapper with a plain PyTorch version beside it."""
