"""Partition rules: parameter-name regex -> the mesh axis of each dim.

The port's own copy of the rules of ``transformer_tpu/parallel/sharding.py``
(``_RULES``, ``_divisible``, ``param_partition_spec``, ``batch_spec``),
written over the port's flat parameter names (``param_spec``'s, which are
the JAX checkpoint's) and returning tuples of axis names where JAX returns
``PartitionSpec``s:

==========================================  =============================
name suffix                                  spec (dims of the array)
==========================================  =============================
embedding/table          (V, M)              ('fsdp', None)
query|key|value/kernel   (M, H, D)           ('fsdp', 'model', None)
out/kernel               (H, D, M)           ('model', None, 'fsdp')
ffn in|gate/kernel       (M, F)              ('fsdp', 'model')
ffn out/kernel           (F, M)              ('model', 'fsdp')
moe in/kernel            (E, M, F)           ('expert', 'fsdp', 'model')
final/kernel             (M, V)              ('fsdp', 'model')
layernorm scale/bias, router                 replicated
==========================================  =============================

Optimizer moments carry the parameter's name as a suffix
(``opt_state/0/mu/<name>``), so the same rules apply to them. Any dim
that does not divide its axis falls back to replicated. At rest each rank
holds its slice of every leaf along every dim its spec splits over an
axis of more than one rank (``leaf_split``, ``shard_leaf``): the ``fsdp``
dim is gathered when a layer reads the leaf (``GatheredView``), the
``model`` and ``expert`` dims never are (the ops run on their slices,
``parallel/collectives.py``).
"""

from __future__ import annotations

import re

import torch

Spec = tuple  # one entry per dim: an axis name, a tuple of names, or None

# (name-suffix regex, spec). First match wins.
_RULES: list[tuple[str, Spec]] = [
    (r"embedding/table$", ("fsdp", None)),
    (r"(query|key|value)/kernel$", ("fsdp", "model", None)),
    (r"(query|key|value)/bias$", ("model", None)),
    (r"moe/router/kernel$", (None, None)),
    (r"moe/in/kernel$", ("expert", "fsdp", "model")),
    (r"moe/in/bias$", ("expert", "model")),
    (r"moe/out/kernel$", ("expert", "model", "fsdp")),
    (r"moe/out/bias$", ("expert", None)),
    (r"out/kernel$", ("model", None, "fsdp")),
    (r"out/bias$", (None,)),
    (r"ffn/in/kernel$", ("fsdp", "model")),
    (r"ffn/in/bias$", ("model",)),
    (r"ffn/gate/kernel$", ("fsdp", "model")),
    (r"ffn/gate/bias$", ("model",)),
    (r"ffn/out/kernel$", ("model", "fsdp")),
    (r"ffn/out/bias$", (None,)),
    (r"final/kernel$", ("fsdp", "model")),
    (r"final/bias$", ("model",)),
    (r"(ln1|ln2|ln_ffn|final_ln)/(scale|bias)$", (None,)),
]


def _divisible(spec: Spec, shape: tuple[int, ...], mesh_shape: dict[str, int]) -> Spec:
    """Drop the axis of any dim that does not divide its mesh axis, or that
    names an axis the mesh lacks; () when the spec has more dims than the
    array."""
    if len(spec) > len(shape):
        return ()
    out = []
    for dim, axis in enumerate(spec):
        if axis is None:
            out.append(None)
            continue
        axes = axis if isinstance(axis, tuple) else (axis,)
        if any(a not in mesh_shape for a in axes):
            out.append(None)
            continue
        size = 1
        for a in axes:
            size *= mesh_shape[a]
        out.append(axis if shape[dim] % size == 0 else None)
    return tuple(out)


def param_partition_spec(name: str, shape, mesh_shape: dict[str, int]) -> Spec:
    """The spec of one leaf of the params or of the optimizer's state, by
    its flat name and shape; () for scalars and unmatched names
    (replicated)."""
    shape = tuple(shape)
    if not shape:
        return ()
    for pattern, spec in _RULES:
        if re.search(pattern, name):
            return _divisible(spec, shape, mesh_shape)
    return ()


def batch_spec(mesh_shape: dict[str, int], shard_seq: bool = False) -> Spec:
    """(B, S) token batches: the batch dim over data × fsdp × expert (the
    axes the mesh carries), the sequence over ``seq`` when asked."""
    axes = tuple(a for a in ("data", "fsdp", "expert") if a in mesh_shape)
    # PartitionSpec's normal form: one axis by its name, none as None
    batch = axes[0] if len(axes) == 1 else (axes or None)
    return (batch, "seq" if shard_seq else None)


def leaf_split(name: str, shape, mesh_shape: dict[str, int]) -> dict[int, str]:
    """dim -> mesh axis for every dim of the leaf that its spec splits over
    an axis of more than one rank; {} for a leaf every rank holds whole."""
    spec = param_partition_spec(name, shape, mesh_shape)
    return {d: a for d, a in enumerate(spec)
            if a is not None and mesh_shape.get(a, 1) > 1}


def leaf_bounds(shape, split: dict[int, str], mesh) -> tuple[tuple[int, int], ...]:
    """(start, stop) per dim of this rank's slice of a leaf of ``shape``
    split as ``split`` (``leaf_split``) over ``mesh``."""
    out = [(0, int(n)) for n in shape]
    for dim, axis in split.items():
        width = int(shape[dim]) // mesh.size((axis,))
        out[dim] = (mesh.group_index((axis,)) * width, (mesh.group_index((axis,)) + 1) * width)
    return tuple(out)


def shard_leaf(t, split: dict[int, str], mesh):
    """This rank's slice of the whole leaf ``t`` (a tensor, copied, or an
    array, viewed); ``t`` itself when nothing splits it."""
    if not split:
        return t
    region = tuple(slice(a, b) for a, b in leaf_bounds(t.shape, split, mesh))
    part = t[region]
    return part.detach().clone() if isinstance(t, torch.Tensor) else part


def gather_leaf(part: torch.Tensor, split: dict[int, str], mesh) -> torch.Tensor:
    """The whole leaf from every rank's slice ``part``: one all-gather per
    split dim over its axis (not differentiable). A collective: every rank
    of the mesh calls it."""
    for dim, axis in split.items():
        part = mesh.all_gather(part, (axis,), dim, kind="whole")
    return part


class _Gather(torch.autograd.Function):
    """All-gather of an fsdp slice; its backward reduce-scatters the
    gradient: the sum over the fsdp group (each rank took other rows),
    sliced back to this rank's part."""

    @staticmethod
    def forward(ctx, part, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return mesh.all_gather(part, "fsdp", dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.reduce_scatter(grad, "fsdp", ctx.dim), None, None


def gather(part: torch.Tensor, mesh, dim: int | None) -> torch.Tensor:
    """The whole leaf from this rank's fsdp slice ``part`` (differentiable);
    ``part`` itself when the leaf is not split."""
    if dim is None:
        return part
    return _Gather.apply(part, mesh, dim)


class GatheredView(dict):
    """Nested params whose fsdp-split leaves are gathered when read: a
    layer's weights are whole only while the layer uses them (ZeRO-3), one
    gather per read, each differentiable. ``dims`` maps flat names to the
    split dim (None: whole); ``whole`` holds leaves the caller gathered
    itself, read as they are. Reads by key and iteration over a list of
    layers go through the view; the model code reads nothing else."""

    def __init__(self, node: dict, mesh, dims: dict[str, int | None], prefix: str = "",
                 whole: dict[str, torch.Tensor] | None = None):
        super().__init__(node)
        self._mesh, self.dims, self._prefix = mesh, dims, prefix
        self._whole = {} if whole is None else whole

    def _wrap(self, key, value):
        name = f"{self._prefix}{key}"
        if isinstance(value, dict):
            return GatheredView(value, self._mesh, self.dims, name + "/", self._whole)
        if isinstance(value, list):
            return [self._wrap(f"{key}/{i}", v) if not isinstance(v, dict)
                    else GatheredView(v, self._mesh, self.dims, f"{name}/{i}/", self._whole)
                    for i, v in enumerate(value)]
        if name in self._whole:  # gathered once for the step by the caller
            return self._whole[name]
        return gather(value, self._mesh, self.dims.get(name))

    def with_whole(self, whole: dict[str, torch.Tensor]) -> "GatheredView":
        """The view with the leaves of ``whole`` (by flat name) read from
        it instead of gathered at each read."""
        return GatheredView(dict(self), self._mesh, self.dims, self._prefix, whole)

    def __getitem__(self, key):
        return self._wrap(key, super().__getitem__(key))

    def get(self, key, default=None):
        return self[key] if key in self else default

    def items(self):
        return [(k, self[k]) for k in self.keys()]

    def values(self):
        return [self[k] for k in self.keys()]
