"""Process mesh and multi-process bring-up.

Port of ``make_mesh`` and ``initialize_distributed`` from
``transformer_tpu/parallel/mesh.py``. Where the JAX package lays devices
out on a 6-axis ``Mesh`` and lets XLA place collectives, here each
process is one position of that mesh: ranks map to mesh coordinates in
the JAX package's row-major order, and the collectives XLA would insert
run on process groups of the ranks that differ along some axes: each
``seq`` ring; the ``fsdp`` group (a layer's weights gathered before use,
its gradients reduce-scattered back); the ``model`` group (the
tensor-parallel sums, ``parallel/collectives.py``); the ``expert`` group
(MoE's token all-to-alls); the batch group ``data × fsdp × expert``
(JAX's ``batch_spec`` axes); the ``pipe`` chain (activations and their
cotangents sent stage to stage); each axis alone; and, for the sets of
axes a trainer names (``Mesh.add_groups``), the ranks that differ only
along them: a leaf's gradient is summed over the axes that do not split
it, its norm over those that do.

With ``dcn_data`` > 1 the data axis spans that many granules, a granule
being a node as ``torch.distributed.run`` numbers them (``GROUP_RANK``;
one process per card makes JAX's ``process_is_granule`` rule mean a
host): granules in node order, each holding a block of the data axis,
every other axis inside one node, as JAX's ``_hybrid_mesh`` lays it.

The transport is decided once, at start-up, from the layout, and never
changes afterwards (no fallback after a failed call): NCCL when every
rank has a card of its own, gloo when ranks share a card or run on the
CPU. Gloo's collectives take host memory, so under gloo CUDA tensors are
copied to the host and back explicitly, and those bytes are counted.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from transformer_tpu_torch.config import MeshConfig
from transformer_tpu_torch.device import resolve_device


def choose_transport(device_type: str, local_ranks: int, local_cards: int) -> str:
    """"nccl" when each of the ``local_ranks`` processes on a host has one
    of its ``local_cards`` cards to itself; "gloo" on the CPU or when ranks
    share a card (NCCL refuses two ranks on one GPU)."""
    if device_type == "cuda" and local_ranks <= local_cards:
        return "nccl"
    return "gloo"


@dataclasses.dataclass(frozen=True)
class Process:
    """This process's place in the job: global rank, world size, device
    and the transport its collectives use ("none" in a world of one)."""

    rank: int
    world_size: int
    device: torch.device
    transport: str
    node: int = 0  # the launcher's node (``GROUP_RANK``): the dcn_data granule
    nodes: int = 1  # how many nodes the job spans (``GROUP_WORLD_SIZE``)


def initialize_distributed(device: str = "cuda", log_fn=print) -> Process:
    """Join the job that ``torch.distributed.run`` describes in the
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``, ``GROUP_RANK``, ``GROUP_WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``), or run as a
    world of one without them. The device is ``cuda:{LOCAL_RANK % cards}``
    (raising without a card) or the CPU when ``device="cpu"``. Rank 0 logs
    the transport."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    node, nodes = int(os.environ.get("GROUP_RANK", "0")), int(os.environ.get("GROUP_WORLD_SIZE", "1"))
    dev = resolve_device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
    if world == 1:
        return Process(0, 1, dev, "none")
    transport = choose_transport(dev.type, local_ranks, cards)
    if not dist.is_initialized():
        addr = os.environ.get("MASTER_ADDR", "localhost")
        port = os.environ["MASTER_PORT"]
        dist.init_process_group(
            transport, init_method=f"tcp://{addr}:{port}", world_size=world, rank=rank
        )
    if rank == 0:
        if transport == "gloo" and dev.type == "cuda":
            how = (f"{local_ranks} ranks share {cards} card(s); CUDA tensors staged through "
                   "host memory")
        elif transport == "gloo":
            how = "CPU tensors"
        else:
            how = "one card per rank"
        log_fn(f"transport: {transport} ({how}), world {world}")
    return Process(rank, world, dev, transport, node, nodes)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``cfg`` laid over the processes of the job: this rank's coordinates,
    the process group of its ``seq`` ring (None in a world of one) and of
    each set of its axes made so far (keyed by the tuple of axes of more
    than one rank, in mesh order; none in a world of one), and ``order``,
    the global rank at each mesh position in row-major order."""

    cfg: MeshConfig
    process: Process
    coords: tuple[int, ...]  # one index per axis of cfg.axis_names
    seq_group: Any
    groups: dict[tuple[str, ...], Any] = dataclasses.field(default_factory=dict)
    order: tuple[int, ...] = ()

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.cfg.axis_names, self.cfg.axis_sizes))

    @property
    def device(self) -> torch.device:
        return self.process.device

    def index(self, axis: str) -> int:
        return self.coords[self.cfg.axis_names.index(axis)]

    def _axes(self, group) -> tuple[str, ...]:
        """The mesh axes of ``group``: a key of ``GROUP_AXES`` or a tuple
        of axis names."""
        return GROUP_AXES[group] if isinstance(group, str) else tuple(group)

    def size(self, group) -> int:
        """How many ranks ``group`` (a key of ``GROUP_AXES`` or a tuple of
        axes) holds."""
        return int(np.prod([self.shape[a] for a in self._axes(group)]))

    def group_index(self, group) -> int:
        """This rank's place in ``group``, in row-major order of its axes."""
        axes = self._axes(group)
        return int(np.ravel_multi_index([self.index(a) for a in axes],
                                        [self.shape[a] for a in axes]))

    def rank_at(self, **coords: int) -> int:
        """The global rank at this rank's coordinates with ``coords``
        replaced (``mesh.rank_at(pipe=0)``)."""
        at = [coords.get(a, c) for a, c in zip(self.cfg.axis_names, self.coords)]
        pos = int(np.ravel_multi_index(at, self.cfg.axis_sizes))
        return self.order[pos] if self.order else pos

    def _group(self, group):
        """The process group to run on (None: the world), or "skip" when it
        has one rank. ``group`` is a key of ``GROUP_AXES``, a tuple of
        axes, or None for every process."""
        if group is None:
            return None if self.process.world_size > 1 else "skip"
        axes = tuple(a for a in self.cfg.axis_names
                     if a in self._axes(group) and self.shape[a] > 1)
        return self.groups[axes] if axes else "skip"

    def add_groups(self, sets) -> None:
        """Make the process groups of the axis ``sets`` (each a key of
        ``GROUP_AXES`` or a tuple of axes) that do not exist yet. A
        collective: every rank calls it with the same sets."""
        if self.process.world_size == 1:
            return
        grid = np.asarray(self.order).reshape(self.cfg.axis_sizes)
        names = self.cfg.axis_names
        live = {tuple(a for a in names if a in self._axes(g) and self.shape[a] > 1)
                for g in sets}
        for axes in sorted(live - set(self.groups) - {()},
                           key=lambda axes: [names.index(a) for a in axes]):
            idx = [names.index(a) for a in axes]
            rest = [i for i in range(len(names)) if i not in idx]
            for ranks in np.transpose(grid, rest + idx).reshape(-1, self.size(axes)):
                g = dist.new_group([int(r) for r in ranks])
                if self.process.rank in ranks:
                    self.groups[axes] = g

    def pg(self, group):
        """The process group of ``group`` for a caller's own collective, or
        None when it holds one rank."""
        pg = self._group(group)
        return None if pg == "skip" else pg

    def all_reduce_sum_(self, tensors: list[torch.Tensor], group=None,
                        op=dist.ReduceOp.SUM) -> None:
        """Sum (or reduce by ``op``) each tensor over every rank (or over
        ``group``), in place: one collective over the tensors packed into
        one fp32 buffer (staged through the host under gloo)."""
        pg = self._group(group)
        if pg == "skip" or not tensors:
            return
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        flat = _collective(flat, lambda buf: dist.all_reduce(buf, op=op, group=pg),
                           self.process.transport)
        _unpack_into(flat, tensors)

    def all_gather(self, t: torch.Tensor, group, dim: int, kind: str = "fsdp") -> torch.Tensor:
        """Every rank's ``t`` of ``group``, concatenated along ``dim`` in the
        group's order (staged through the host under gloo, counted under
        ``kind``)."""
        pg = self._group(group)
        if pg == "skip":
            return t
        stage = staged(t.device, pg)
        buf = t.detach().contiguous()
        buf = buf.cpu() if stage else buf
        parts = [torch.empty_like(buf) for _ in range(self.size(group))]
        dist.all_gather(parts, buf, group=pg)
        out = torch.cat(parts, dim=dim)
        if stage:
            staged_bytes[kind] += (buf.numel() + out.numel()) * buf.element_size()
            out = out.to(t.device)
        return out

    def reduce_scatter(self, t: torch.Tensor, group, dim: int) -> torch.Tensor:
        """This rank's slice along ``dim`` of ``t`` summed over ``group``:
        an all-reduce and a slice, since gloo has no reduce-scatter for CPU
        tensors."""
        if self._group(group) == "skip":
            return t
        full = t.detach().clone()
        self.all_reduce_sum_([full], group)
        n = self.size(group)
        width = full.shape[dim] // n
        return full.narrow(dim, self.group_index(group) * width, width).contiguous()

    def send(self, t: torch.Tensor, dst: int, tag: int):
        """Start sending ``t`` to global rank ``dst``; returns the request
        to wait on (and the host copy it reads, kept alive until then)."""
        buf = t.detach().contiguous()
        if staged(buf.device, None):
            buf = buf.cpu()
            staged_bytes["pipe"] += buf.numel() * buf.element_size()
        return dist.isend(buf, dst, tag=tag), buf

    def recv(self, shape, dtype, src: int, tag: int) -> torch.Tensor:
        """A tensor of ``shape`` and ``dtype`` received from global rank
        ``src``, on this rank's device."""
        device = self.device
        stage = staged(device, None)
        buf = torch.empty(shape, dtype=dtype, device="cpu" if stage else device)
        dist.recv(buf, src, tag=tag)
        if stage:
            staged_bytes["pipe"] += buf.numel() * buf.element_size()
            buf = buf.to(device)
        return buf

    def broadcast_(self, tensors: list[torch.Tensor], src: int = 0, group=None) -> None:
        """Overwrite each tensor with global rank ``src``'s (a member of
        ``group`` when one is named), in place."""
        pg = self._group(group)
        if pg == "skip" or not tensors:
            return
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        flat = _collective(flat, lambda buf: dist.broadcast(buf, src, group=pg),
                           self.process.transport)
        _unpack_into(flat, tensors)

    def barrier(self) -> None:
        if self.process.world_size > 1:
            dist.barrier()


def staged(device: torch.device, group) -> bool:
    """Whether a collective of ``group`` on ``device`` tensors goes through
    host memory: CUDA tensors under gloo."""
    return device.type == "cuda" and dist.get_backend(group) == "gloo"


def _collective(flat: torch.Tensor, op, transport: str) -> torch.Tensor:
    stage = transport == "gloo" and flat.device.type == "cuda"
    buf = flat.cpu() if stage else flat
    op(buf)
    if stage:
        staged_bytes["collectives"] += 2 * buf.numel() * buf.element_size()
        return buf.to(flat.device)
    return buf


def _unpack_into(flat: torch.Tensor, tensors: list[torch.Tensor]) -> None:
    off = 0
    with torch.no_grad():
        for t in tensors:
            n = t.numel()
            t.copy_(flat[off : off + n].reshape(t.shape))
            off += n


# Bytes copied device -> host and host -> device for gloo, by kind
# ("ring" for ring_attention.ring_shift, "ulysses" for its all-to-alls,
# "gather" for seq_context.gather_sequence, "collectives" for the sums and
# broadcasts above, "fsdp" for the weight gathers, "pipe" for the stage to
# stage sends, "tp" for the tensor-parallel sums and "ep" for MoE's token
# all-to-alls of ``parallel/collectives.py``, "whole" for split leaves
# gathered whole: the export, a checkpoint's gathered state), since the
# last reset.
staged_bytes = {"ring": 0, "ulysses": 0, "gather": 0, "collectives": 0, "fsdp": 0, "pipe": 0,
                "tp": 0, "ep": 0, "whole": 0}

# Named process groups: each holds the ranks that differ only along its
# axes. "batch" is JAX's ``batch_spec`` axes, the ranks that split the
# batch rows.
GROUP_AXES = {
    "seq": ("seq",),
    "fsdp": ("fsdp",),
    "pipe": ("pipe",),
    "model": ("model",),
    "expert": ("expert",),
    "batch": ("data", "fsdp", "expert"),
}


def _granule_order(cfg: MeshConfig, process: Process) -> list[int]:
    """The global ranks in mesh order under ``dcn_data``: JAX's
    ``_hybrid_mesh`` with the node as the granule (ranks sorted by node,
    then by rank), with its messages when ``dcn_data`` does not divide the
    data axis or differs from the number of nodes."""
    if cfg.data % cfg.dcn_data:
        raise ValueError(
            f"dcn_data={cfg.dcn_data} must divide the data axis ({cfg.data}): "
            "the data axis is the only one spanning DCN"
        )
    per_slice = (cfg.data // cfg.dcn_data, *cfg.axis_sizes[1:])
    dcn = (cfg.dcn_data, 1, 1, 1, 1, 1)
    nodes = [process.node] * process.world_size
    if process.world_size > 1:
        dist.all_gather_object(nodes, process.node)
    if len(set(nodes)) != cfg.dcn_data:
        raise ValueError(
            f"hybrid mesh {per_slice} x dcn {dcn} failed: Number of slices {len(set(nodes))} "
            f"must equal the product of dcn_mesh_shape {dcn}. Hint: dcn_data must equal "
            "the number of DCN granules (TPU slices, or processes off-TPU) the devices span."
        )
    return sorted(range(process.world_size), key=lambda r: (nodes[r], r))


def make_mesh(cfg: MeshConfig, process: Process) -> Mesh:
    """Lay ``cfg`` over the job: rank r sits at the row-major position r of
    ``cfg.axis_sizes`` (as ``np.reshape`` of the device list places it in
    the JAX package), or under ``dcn_data`` > 1 at its place in the
    granule order (``_granule_order``). For each axis of more than one
    rank and each set of ``GROUP_AXES``, the ranks that differ only along
    those axes form one process group, in row-major order of the axes (the
    ``seq`` rings in ``seq`` order); other sets come from ``add_groups``."""
    if cfg.num_devices != process.world_size:
        raise ValueError(
            f"mesh {cfg.axis_sizes} needs {cfg.num_devices} processes, have "
            f"{process.world_size}"
        )
    order = (_granule_order(cfg, process) if cfg.dcn_data > 1
             else list(range(process.world_size)))
    grid = np.asarray(order).reshape(cfg.axis_sizes)
    coords = tuple(int(i) for i in np.argwhere(grid == process.rank)[0])
    mesh = Mesh(cfg, process, coords, None, {}, tuple(order))
    if process.world_size == 1:
        return mesh
    mesh.add_groups([(a,) for a in cfg.axis_names] + list(GROUP_AXES))
    if cfg.seq > 1:
        seq_group = mesh.groups[("seq",)]
    else:  # a ring of one: its own group, as the sequence context expects
        for r in order:
            g = dist.new_group([int(r)])
            if r == process.rank:
                seq_group = g
    return dataclasses.replace(mesh, seq_group=seq_group)
