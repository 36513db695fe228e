"""Tensor ops of the port: plain-torch composites and the CUDA kernel
wrappers beside them."""
