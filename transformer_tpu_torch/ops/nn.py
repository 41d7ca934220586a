"""Primitive building blocks: dense, embedding, layernorm, dropout, remat.

Functions over plain parameter dicts in the JAX package's layouts
(``kernel`` is ``(d_in, d_out)``). Parameters stay in their stored dtype;
compute casts to the caller's dtype exactly where the JAX twin does.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools

import numpy as np
import torch
import torch.utils.checkpoint
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

Params = dict


def dense_apply(params: Params, x: torch.Tensor, dtype=None) -> torch.Tensor:
    dtype = dtype or x.dtype
    kernel = params["kernel"].to(dtype)
    bias = params["bias"].to(dtype)
    return torch.matmul(x.to(dtype), kernel) + bias


def embedding_lookup(
    params: Params, ids: torch.Tensor, dtype=torch.bfloat16
) -> torch.Tensor:
    return params["table"].to(dtype)[ids]


def embedding_attend(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied output projection: logits = x @ table.T."""
    return torch.matmul(x, params["table"].to(x.dtype).T)


def layernorm_apply(
    params: Params, x: torch.Tensor, epsilon: float = 1e-6
) -> torch.Tensor:
    """LayerNorm with fp32 statistics whatever the compute dtype, then the
    affine in fp32, then a cast back."""
    orig_dtype = x.dtype
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = torch.square(x32 - mean).mean(dim=-1, keepdim=True)
    normed = (x32 - mean) * torch.rsqrt(var + epsilon)
    out = normed * params["scale"].float() + params["bias"].float()
    return out.to(orig_dtype)


def key_seed(key: tuple[int, ...]) -> int:
    """The 63-bit generator seed of an integer dropout key."""
    return int(np.random.SeedSequence(list(key)).generate_state(1, np.uint64)[0]) >> 1


class DropoutTape:
    """The dropout generators of one train step under CUDA-graph capture.

    A capture records the kernels of the step but not the host's seeds: a
    generator made and seeded on the host while capturing would draw the
    capture step's masks at every replay. So the step runs once with the
    tape recording (a real, eager step: the key of each
    ``dropout_generator`` call, in call order, the recompute of a
    rematerialized layer included), then ``arm`` makes one generator per
    call and registers it with the graph, the capture takes them in the
    same order (checking each key against the recorded one), and
    ``reseed`` seeds each from the real key before every replay. Keys
    must start with ``base`` (the trainer's (seed, step)); ``reseed``
    swaps that prefix for the replayed step's. The replay then draws the
    masks the eager step draws for the same key, bit for bit."""

    def __init__(self, base: tuple[int, ...]) -> None:
        self.base = tuple(base)
        self.suffixes: list[tuple[int, ...]] = []
        self.generators: list[torch.Generator] | None = None
        self._next = 0

    def generator(self, key: tuple[int, ...], device) -> torch.Generator:
        key = tuple(key)
        if key[: len(self.base)] != self.base:
            raise ValueError(f"dropout key {key} does not extend the step's key {self.base}")
        suffix = key[len(self.base) :]
        if self.generators is None:
            self.suffixes.append(suffix)
            return torch.Generator(device=device).manual_seed(key_seed(key))
        i, self._next = self._next, self._next + 1
        if i >= len(self.suffixes) or self.suffixes[i] != suffix:
            raise RuntimeError(
                f"the captured step's dropout call {i} has key suffix {suffix}, its warm-up "
                f"run's {self.suffixes[i] if i < len(self.suffixes) else 'none'}"
            )
        return self.generators[i]

    def arm(self, graph, device) -> None:
        """One generator per recorded call, registered with ``graph``
        (before its capture begins)."""
        self.generators = [torch.Generator(device=device) for _ in self.suffixes]
        for g in self.generators:
            graph.register_generator_state(g)
        self.reseed(self.base)

    def check_complete(self) -> None:
        if self._next != len(self.suffixes):
            raise RuntimeError(
                f"the captured step made {self._next} dropout calls, its warm-up run "
                f"{len(self.suffixes)}"
            )

    def reseed(self, base: tuple[int, ...]) -> None:
        for g, suffix in zip(self.generators, self.suffixes):
            g.manual_seed(key_seed(tuple(base) + suffix))


_TAPE: contextvars.ContextVar[DropoutTape | None] = contextvars.ContextVar(
    "dropout_tape", default=None
)


@contextlib.contextmanager
def dropout_tape(tape: DropoutTape):
    """Route ``dropout_generator`` through ``tape`` inside the block."""
    token = _TAPE.set(tape)
    try:
        yield tape
    finally:
        _TAPE.reset(token)


def dropout_generator(key: tuple[int, ...], device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from an integer key, e.g.
    (seed, step, layer, site). A layer that seeds its dropout this way
    draws the same masks each time it runs, so the recompute of a
    checkpointed layer sees the forward's masks. Under a ``DropoutTape``
    (a train step being captured) the tape hands the generator out."""
    tape = _TAPE.get()
    if tape is not None:
        return tape.generator(key, device)
    return torch.Generator(device=device).manual_seed(key_seed(key))


@dataclasses.dataclass(frozen=True)
class GlobalSlice:
    """Where this process's (b, s, ...) activation sits in the global one
    of a data × sequence split: the global, unpadded batch and length, and
    the global index of its first row and first position. Positions past
    ``length`` are the sequence split's padding."""

    batch: int
    length: int
    row: int
    col: int


def dropout(
    generator: torch.Generator | None,
    x: torch.Tensor,
    rate: float,
    deterministic: bool,
    region: GlobalSlice | None = None,
) -> torch.Tensor:
    """Inverted dropout with masks drawn from ``generator``;
    ``deterministic`` (eval) or ``rate == 0`` is the identity. With a
    ``region``, the mask is drawn for the whole global (batch, length, ...)
    tensor and this process keeps its own rows and positions, so a split
    run draws exactly the masks of the unsplit one (``torch.rand`` fills in
    row-major order, so a draw over another shape would put other values
    at the same indices); padding positions past ``length`` keep their
    values, which nothing reads."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training mode requires a generator")
    keep = 1.0 - rate
    if region is None:
        mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    else:
        full = torch.rand(
            (region.batch, region.length) + tuple(x.shape[2:]), generator=generator,
            device=x.device,
        )
        part = full[region.row : region.row + x.shape[0], region.col : region.col + x.shape[1]]
        mask = torch.ones(x.shape, dtype=torch.bool, device=x.device)
        mask[:, : part.shape[1]] = part < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


_aten = torch.ops.aten


def dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """JAX's ``dots_with_no_batch_dims_saveable`` in torch's terms: keep
    the outputs of the products with no batch dimension (the dense layers'
    ``mm``/``addmm``, and the attention projections' einsums, which torch
    runs as a ``bmm`` over a batch of 1), recompute everything else:
    attention's batched products, the flash kernel calls, the elementwise
    ops and dropout's draws."""
    if op in (_aten.mm.default, _aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    if op is _aten.bmm.default and args[0].shape[0] == 1:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_layer(fn, cfg):
    """``fn`` under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are recomputed in the backward instead of kept; with
    ``remat_policy="dots"`` the outputs of the products ``dots_policy``
    picks are kept and only the rest is recomputed (the same gradients
    either way). Dropout inside
    ``fn`` must come from generators seeded per call (``dropout_generator``),
    since the global RNG state is not replayed. The recompute runs in a
    copy of the context variables of the forward call (the
    sequence-parallel context and the dropout tape among them), since the
    backward runs outside the ``with`` blocks that set them."""
    extra = {}
    if cfg.remat_policy == "dots":  # else "full" (ModelConfig allows no other)
        extra["context_fn"] = functools.partial(create_selective_checkpoint_contexts, dots_policy)

    def checkpointed(*args, **kwargs):
        ctx = contextvars.copy_context()
        return torch.utils.checkpoint.checkpoint(
            lambda *a, **k: ctx.run(fn, *a, **k), *args, use_reentrant=False,
            preserve_rng_state=False, **extra, **kwargs,
        )

    return checkpointed
