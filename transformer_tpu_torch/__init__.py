"""PyTorch/CUDA port of transformer_tpu: the decoder-only LM serving path
(paged KV pool, continuous batching) on hand-written CUDA kernels for an
NVIDIA H100. Imports torch, numpy and the standard library only."""
