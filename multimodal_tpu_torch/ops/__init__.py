"""Operators of the port: each hand-written CUDA kernel beside its plain PyTorch version."""
