"""PyTorch/CUDA port of transformer_tpu: decoder-only LM serving (paged KV
pool, continuous batching) and training (single card, and sequence
parallel over a ring), and the seq2seq translator's training, decoding
and scoring, on hand-written CUDA kernels for an NVIDIA H100. Imports
torch, numpy and the standard library only."""
