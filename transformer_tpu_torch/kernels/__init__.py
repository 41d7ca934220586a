"""Kernels of the port and what addresses them: the paged-attention CUDA
kernel, the KV block pool, and the build/load of csrc/."""
