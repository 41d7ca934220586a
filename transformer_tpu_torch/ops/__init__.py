"""Tensor ops of the port: dense/embedding/layernorm, positions, masks,
attention and the FFN (with the fused FFN-sublayer kernel)."""
