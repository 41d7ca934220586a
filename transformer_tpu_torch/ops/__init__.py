"""Tensor ops of the port: dense/embedding/layernorm, positions, masks,
attention, the FFN (with the fused FFN-sublayer kernel) and the
Mixture-of-Experts FFN."""

from transformer_tpu_torch.ops.moe import expert_capacity, moe_apply, moe_init

__all__ = ["expert_capacity", "moe_apply", "moe_init"]
