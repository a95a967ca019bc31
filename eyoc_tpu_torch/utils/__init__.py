"""Device policy and the CUDA kernel loader."""
