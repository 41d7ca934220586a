"""Process mesh and multi-process bring-up.

Port of ``make_mesh`` and ``initialize_distributed`` from
``transformer_tpu/parallel/mesh.py``. Where the JAX package lays devices
out on a 6-axis ``Mesh`` and lets XLA place collectives, here each
process is one position of that mesh: ranks map to mesh coordinates in
the JAX package's row-major order (``seq`` fastest of the axes the port
runs), each ``seq`` ring gets its own process group, and the sums over
``data × seq`` run on the world group.

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


def initialize_distributed(device: str = "cuda", log_fn=print) -> Process:
    """Join the job that ``torch.distributed.run`` describes in the
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), or run as a
    world of one without them. The device is ``cuda:{LOCAL_RANK % cards}``
    (raising without a card) or the CPU when ``device="cpu"``. Rank 0 logs
    the transport."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
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
    return Process(rank, world, dev, transport)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``cfg`` laid over the processes of the job: this rank's coordinates
    and the process group of its ``seq`` ring (None in a world of one)."""

    cfg: MeshConfig
    process: Process
    coords: tuple[int, ...]  # one index per axis of cfg.axis_names
    seq_group: Any

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.cfg.axis_names, self.cfg.axis_sizes))

    @property
    def device(self) -> torch.device:
        return self.process.device

    def index(self, axis: str) -> int:
        return self.coords[self.cfg.axis_names.index(axis)]

    def all_reduce_sum_(self, tensors: list[torch.Tensor]) -> None:
        """Sum each tensor over every rank, in place: one collective over
        the tensors packed into one fp32 buffer (staged through the host
        under gloo)."""
        if self.process.world_size == 1 or not tensors:
            return
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        flat = _collective(flat, lambda buf: dist.all_reduce(buf), self.process.transport)
        _unpack_into(flat, tensors)

    def broadcast_(self, tensors: list[torch.Tensor], src: int = 0) -> None:
        """Overwrite each tensor with rank ``src``'s, in place."""
        if self.process.world_size == 1 or not tensors:
            return
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        flat = _collective(flat, lambda buf: dist.broadcast(buf, src), self.process.transport)
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
# broadcasts above), since the last reset.
staged_bytes = {"ring": 0, "ulysses": 0, "gather": 0, "collectives": 0}


def make_mesh(cfg: MeshConfig, process: Process) -> Mesh:
    """Lay ``cfg`` over the job: rank r sits at the row-major position r of
    ``cfg.axis_sizes`` (as ``np.reshape`` of the device list places it in
    the JAX package), and the ranks that differ only in their ``seq``
    coordinate form a ring, in ``seq`` order, with a process group each.
    Every rank creates every ring's group, in the same order."""
    if cfg.num_devices != process.world_size:
        raise ValueError(
            f"mesh {cfg.axis_sizes} needs {cfg.num_devices} processes, have "
            f"{process.world_size}"
        )
    grid = np.arange(process.world_size).reshape(cfg.axis_sizes)
    coords = tuple(int(i) for i in np.unravel_index(process.rank, cfg.axis_sizes))
    seq_axis = cfg.axis_names.index("seq")
    rings = np.moveaxis(grid, seq_axis, -1).reshape(-1, cfg.seq)
    group = None
    if process.world_size > 1:
        for ring in rings:
            g = dist.new_group([int(r) for r in ring])
            if process.rank in ring:
                group = g
    return Mesh(cfg, process, coords, group)
