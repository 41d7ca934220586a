"""The distributed trainer: data × fsdp × tensor × sequence × pipeline ×
expert parallelism over processes.

Port of ``put_batch``, ``DistributedTrainer``, the sequence logic of
``_seq_parallel_forward``, the pipelined steps (``_pipelined_forward``,
``make_1f1b_train_step``) and the mesh checks from
``transformer_tpu/parallel/distributed.py``. The JAX package jits one step
over global arrays and lets GSPMD split them; here every process runs the
same step on its own part:

- every process reads the same global batch and keeps its slice: rows by
  its place in the batch group ``data × fsdp × expert`` (JAX's
  ``batch_spec``) and, with ``seq > 1``, one sequence chunk by its
  ``seq`` coordinate, after the teacher-forcing input (and a seq2seq
  model's source, on its own) is padded with PAD to a multiple of ``seq``
  (4095 -> 4096 at long4k); the padded positions' logits are dropped. An
  encoder-only model's masked-LM batch is masked on the whole global batch
  first, from the step's generator, so each process's rows carry the
  masks the one-process step draws for them (``seq`` > 1 is refused for
  it, as in JAX);
- the forward runs under the sequence-parallel context at the chunk's
  global offset, so ``mha_apply(impl="ring" | "ulysses")`` runs its core
  over the process group of this ``seq`` ring; a seq2seq decoder's
  cross-attention reads the encoder output gathered to the whole source
  under the whole source's padding mask; dropout draws the global masks
  (``ops.nn.GlobalSlice``), on the source and target sides each;
- with ``fsdp > 1`` each process holds, at rest, its slice of every leaf
  the partition rules split (``parallel/sharding.py``) and of the
  optimizer's moments on it; the forward reads the parameters through
  ``sharding.GatheredView``, which gathers a slice over the fsdp group when
  a layer reads it and reduce-scatters its gradient back (ZeRO-3); the
  update runs on the slice. Adafactor's statistics are the whole leaf's,
  summed over the processes holding its slices (``train/state.py``);
- with ``model > 1`` or ``expert > 1`` each process holds its slice of the
  leaves those axes split (attention heads, dff, the output vocabulary;
  experts) and the forward runs inside
  ``parallel.collectives.model_parallel``, which writes out the sums and
  all-to-alls GSPMD inserts in JAX (``parallel/collectives.py``);
- with ``pipe > 1`` the step is ``parallel.pipeline``'s GPipe or 1F1B
  schedule over the ``pipe`` chain (eval: GPipe's forward; GPipe under
  ``grad_accum_steps`` once per micro-step, JAX's accumulation); every
  process holds every layer at rest (the rules name no ``pipe`` dim, as in
  JAX), and a stage's gradients are its own layers', zero elsewhere;
- the loss is normalised by the global token count (or global batch);
  a MoE layer's first-choice counts and live-token count are summed over
  the batch group before its load-balance loss is formed
  (``ops.moe.moe_stats_reducer``; under ``seq`` each row is routed over
  its whole sequence), so the aux is the global batch's, as
  in the JAX package's single program, and each process's share of it
  (and of its gradient, through the router probabilities) sums to it;
  under ``pipe`` the aux is JAX's per-microbatch one instead;
- each gradient is summed over the axes of ``GRAD_AXES`` that do not
  split its leaf (never over ``model``, whose ranks compute equal
  gradients of the leaves they share; an fsdp slice's sum over fsdp is its
  gather's reduce-scatter), the metric sums over ``GRAD_AXES``;
  ``grad_norm`` (and clipping) adds each slice's squares once; so every
  process takes the same update on what it holds and reports the same
  metrics;
- the parameters are broadcast from rank 0 at start;
- with ``steps_per_dispatch`` = K > 1 the K steps of a dispatch are the
  single-process trainer's (one staged copy, metrics summed on the device,
  one synchronize a dispatch) but run uncaptured: over gloo the sums go
  through host memory, which a CUDA graph cannot capture, and capture over
  NCCL is not ported yet.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch

from transformer_tpu_torch.config import PAD_ID, ModelConfig, TrainConfig
from transformer_tpu_torch.models.transformer import (
    flatten,
    transformer_hidden_apply,
    unflatten,
)
from transformer_tpu_torch.ops.masks import make_padding_mask
from transformer_tpu_torch.ops.moe import moe_stats_reducer
from transformer_tpu_torch.ops.nn import GlobalSlice
from transformer_tpu_torch.parallel import collectives, sharding
from transformer_tpu_torch.parallel.collectives import model_parallel
from transformer_tpu_torch.parallel.mesh import Mesh
from transformer_tpu_torch.parallel.pipeline import pipeline_loss_and_grads
from transformer_tpu_torch.parallel.seq_context import SeqParallelContext, sequence_parallel
from transformer_tpu_torch.train.checkpoint import CheckpointManager
from transformer_tpu_torch.train.state import (
    TrainState,
    create_train_state,
    make_optimizer,
    state_to_flat,
)
from transformer_tpu_torch.train.trainer import (
    Trainer,
    _prepare_batch,
    loss_from_hidden,
    with_moe_aux,
)


def _pad_to(batch: torch.Tensor, multiple: int) -> torch.Tensor:
    extra = (-batch.shape[1]) % multiple
    return torch.nn.functional.pad(batch, (0, extra), value=PAD_ID) if extra else batch


def put_batch(batch: torch.Tensor, mesh: Mesh) -> tuple[torch.Tensor, int, int]:
    """This process's part of a global (B, S) batch: its rows (by its place
    in the batch group ``data × fsdp``), and with ``seq > 1`` its chunk of
    the sequence padded with PAD to a multiple of ``seq``. Returns (part,
    first global row, first global position)."""
    sp, nb = mesh.shape["seq"], mesh.size("batch")
    batch = _pad_to(batch, sp)
    b, s = batch.shape
    rows, chunk = b // nb, s // sp
    row, col = mesh.group_index("batch") * rows, mesh.index("seq") * chunk
    return batch[row : row + rows, col : col + chunk], row, col


def _seq_parallel_forward_loss(mesh: Mesh, dims: dict | None = None, mp=None) -> Callable:
    """The ``forward_loss`` hook of ``Trainer``: the teacher-forcing shift
    (or the MLM's masking) on the global batch, this process's part of it
    (and of a seq2seq source), the forward under the sequence-parallel
    context (when ``seq > 1``) and the model-parallel one (``mp``, when
    the model or expert axis holds more than one rank), and the masked CE
    (chunked with ``loss_chunks > 1``) over the part's real positions,
    normalised globally. With ``dims`` (fsdp) the parameters are read
    through a ``GatheredView``."""
    sp = mesh.shape["seq"]

    def forward_loss(params, tgt, model_cfg, train_cfg, key, reference=False, src=None,
                     prepared=None):
        if dims is not None:
            params = sharding.GatheredView(params, mesh, dims)
        inp, out, key = prepared or _prepare_batch(model_cfg, train_cfg, tgt, key)
        inp_part, row, col = put_batch(inp, mesh)
        out_part, _, _ = put_batch(out, mesh)
        rows = inp_part.shape[0]
        kw = dict(key=key, deterministic=key is None, reference=reference,
                  position_offset=col,
                  dropout_slice=GlobalSlice(inp.shape[0], inp.shape[1], row, col))
        src_part = None
        if src is not None:
            src_part, _, src_col = put_batch(src, mesh)
            kw.update(src_offset=src_col,
                      src_slice=GlobalSlice(src.shape[0], src.shape[1], row, src_col))
            if sp > 1:  # every process holds the whole batch: the whole source's mask
                kw["source_mask"] = make_padding_mask(_pad_to(src, sp)[row : row + rows])
        seq = (sequence_parallel(SeqParallelContext(mesh.seq_group, mesh.index("seq"), sp, col))
               if sp > 1 else contextlib.nullcontext())
        with seq, model_parallel(mp), moe_stats_reducer(_sum_over_batch(mesh)):
            hidden, aux = transformer_hidden_apply(params, src_part, inp_part, model_cfg,
                                                   return_aux=True, **kw)
            real = min(inp_part.shape[1], inp.shape[1] - col)  # drop the padded positions
            total = (out != PAD_ID).sum().float()  # every process holds the whole batch
            return with_moe_aux(loss_from_hidden(
                params, hidden[:, :real], out_part[:, :real], model_cfg, train_cfg,
                total_weight=total), aux, model_cfg)

    return forward_loss


def _sum_over_batch(mesh: Mesh) -> Callable[[torch.Tensor], torch.Tensor]:
    """The MoE statistics' sum over the batch group ``data × fsdp ×
    expert`` (``ops.moe``): the counts the JAX package's single program
    takes over the global batch (each row's counts are over its whole
    sequence, gathered over ``seq``). Outside autograd: the counts carry
    no gradient."""

    def reduce(stats: torch.Tensor) -> torch.Tensor:
        out = stats.detach().clone()
        mesh.all_reduce_sum_([out], group="batch")
        return out

    return reduce


def check_moe_mesh(model_cfg: ModelConfig, axes: dict[str, int]) -> None:
    """JAX's MoE mesh checks: a homogeneous stack (``moe_every`` 1) over
    ``pipe``, and experts the expert axis divides."""
    if not model_cfg.moe_experts:
        return
    if axes.get("pipe", 1) > 1 and model_cfg.moe_every > 1:
        raise ValueError(
            "pipe>1 requires a homogeneous layer stack: set moe_every=1 "
            "(every layer MoE) — mixed dense/MoE stacks cannot stack over "
            "the pipe axis"
        )
    ep = axes.get("expert", 1)
    if ep > 1 and model_cfg.moe_experts % ep:
        raise ValueError(
            f"moe_experts {model_cfg.moe_experts} must be divisible by the "
            f"expert mesh axis ({ep}) for expert weights to shard"
        )


def check_mesh(model_cfg: ModelConfig, train_cfg: TrainConfig, mesh: Mesh) -> None:
    """The JAX trainer's checks (``DistributedTrainer.__init__``,
    ``_raw_sharded_steps``, ``make_1f1b_train_step``), with their
    messages."""
    shape = mesh.shape
    check_moe_mesh(model_cfg, shape)
    if model_cfg.encoder_only and (shape["pipe"] > 1 or shape["seq"] > 1):
        raise ValueError(
            "encoder_only models support data/fsdp/model/expert mesh axes; "
            "pipe and seq are not wired for the encoder-only forward"
        )
    batch_axes = mesh.size("batch")
    if train_cfg.batch_size % batch_axes:
        raise ValueError(
            f"global batch size {train_cfg.batch_size} must be divisible "
            f"by data×fsdp×expert = {batch_axes} "
            "(reference check: distributed_train.py:154-158)"
        )
    micro = train_cfg.batch_size // max(1, train_cfg.grad_accum_steps)
    if train_cfg.grad_accum_steps > 1 and micro % batch_axes:
        raise ValueError(
            f"the micro-batch of {micro} rows (batch {train_cfg.batch_size} / grad_accum_steps "
            f"{train_cfg.grad_accum_steps}) must be divisible by data×fsdp×expert = "
            f"{batch_axes}"
        )
    n_stages = shape["pipe"]
    if n_stages > 1:
        unsupported = {a: shape[a] for a in ("seq", "expert") if shape[a] > 1}
        if unsupported:
            raise ValueError(
                f"pipe>1 composes with 'data', 'fsdp' and 'model' "
                f"(parallel/pipeline.py), but not with {unsupported}: "
                "sequence/expert sharding inside stages is not wired "
                "through the GPipe path (the seq/expert shard_map "
                "contexts cannot fire inside its manual region)."
            )
        if model_cfg.num_layers % n_stages:
            raise ValueError(
                f"pipe axis size {n_stages} must divide num_layers {model_cfg.num_layers}"
            )
        per_shard = train_cfg.batch_size // batch_axes
        num_mb = train_cfg.pp_microbatches or n_stages
        if per_shard % num_mb:
            raise ValueError(
                f"pp_microbatches {num_mb} must divide the per-data-shard batch {per_shard}"
            )
        if train_cfg.pp_schedule == "1f1b" and train_cfg.loss_chunks > 1:
            raise ValueError(
                "pp_schedule='1f1b' already bounds logits memory per microbatch; "
                "loss_chunks>1 is unsupported with it (use pp_schedule='gpipe')"
            )
        if train_cfg.pp_schedule == "1f1b" and train_cfg.grad_accum_steps > 1:
            raise ValueError(
                "pp_schedule='1f1b' accumulates per microbatch already; raise "
                "pp_microbatches instead of grad_accum_steps"
            )
    if shape["seq"] > 1:
        if model_cfg.attention_impl not in ("ring", "ulysses"):
            raise ValueError(
                f"MeshConfig(seq={shape['seq']}) needs a sequence-"
                "parallel attention impl: set ModelConfig(attention_impl="
                "'ring') (or 'ulysses'); plain "
                f"{model_cfg.attention_impl!r} attention would all-gather "
                "the sequence and defeat the axis"
            )
        heads = model_cfg.num_heads
        if heads % shape["model"] == 0:  # ulysses runs on each model rank's heads
            heads //= shape["model"]
        if model_cfg.attention_impl == "ulysses" and heads % shape["seq"]:
            raise ValueError(
                f"ulysses needs num_heads ({heads}) divisible by the seq axis "
                f"({shape['seq']})"
            )


# The axes a gradient (and a metric) is summed over: every axis that
# splits the batch or holds a share of the step's work; never ``model``,
# whose ranks compute equal gradients of the leaves they share.
GRAD_AXES = ("data", "fsdp", "seq", "pipe", "expert")


class ShardLayout:
    """Which leaves of the train state this process holds a slice of: by
    flat state name (``state_to_flat``'s), the dims split over an axis
    (``sharding.leaf_split``), the dim split over ``fsdp`` alone
    (``dims``, what ``GatheredView`` gathers) and the whole leaf's shape.
    A checkpoint manager given one writes JAX's ``sharded-v1`` layout
    (one writer per distinct slice) and slices what it restores."""

    def __init__(self, mesh: Mesh, full_flat: dict[str, torch.Tensor]):
        self.mesh = mesh
        shape = mesh.shape
        self.shapes = {k: tuple(getattr(v, "shape", ())) for k, v in full_flat.items()}
        self.splits = {k: sharding.leaf_split(k, s, shape) for k, s in self.shapes.items()}
        self.dims = {k: next((d for d, a in sp.items() if a == "fsdp"), None)
                     for k, sp in self.splits.items()}

    @property
    def sharded(self) -> bool:
        return any(self.splits.values())

    def writer(self, key: str) -> bool:
        """Whether this process writes its slice of ``key``: the one at
        index 0 of every axis that does not split the leaf."""
        split = set(self.splits[key].values())
        return all(self.mesh.index(a) == 0 for a in self.mesh.cfg.axis_names if a not in split)

    def bounds(self, key: str) -> tuple[tuple[int, int], ...]:
        return sharding.leaf_bounds(self.shapes[key], self.splits[key], self.mesh)

    def local(self, key: str, full):
        """This process's part of the whole leaf ``full`` (an array or a
        tensor)."""
        return sharding.shard_leaf(full, self.splits.get(key, {}), self.mesh)

    def group(self, key: str) -> tuple[str, ...]:
        """The axes that split ``key``: the ranks holding its other slices."""
        return tuple(sorted(set(self.splits[key].values())))

    def barrier(self) -> None:
        self.mesh.barrier()


class ParamSharding:
    """The optimizer's view of split leaves, by parameter name: the whole
    shape, this process's window of it, and sums over the processes that
    hold the leaf's other slices (Adafactor's statistics are the whole
    leaf's)."""

    def __init__(self, layout: ShardLayout):
        self.layout = layout

    def split(self, name: str) -> bool:
        return bool(self.layout.splits[f"params/{name}"])

    def shape(self, name: str) -> tuple[int, ...]:
        return self.layout.shapes[f"params/{name}"]

    def bounds(self, name: str) -> tuple[tuple[int, int], ...]:
        return self.layout.bounds(f"params/{name}")

    def sum_(self, name: str, tensors: list[torch.Tensor]) -> None:
        self.layout.mesh.all_reduce_sum_(tensors, group=self.layout.group(f"params/{name}"))


class DistributedTrainer(Trainer):
    """``Trainer`` whose steps run over the processes of ``mesh``: each
    process holds the train state (its fsdp slices of the split leaves, the
    rest whole) and its part of each batch; the sums over the processes
    holding each leaf make the update the same everywhere. ``state``
    defaults to a fresh one from ``train_cfg.seed`` on the mesh's device;
    rank 0's parameters are broadcast to every process before the state is
    split. With a ``checkpoint`` manager the state is written (under fsdp:
    each process its slices, in JAX's ``sharded-v1`` layout; else by rank
    0) and restored by every process at the start of ``fit``. ``log_dir``,
    ``profiler`` and ``telemetry`` are ``Trainer``'s
    (``cli.distributed_train`` gives them to rank 0 alone)."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        train_cfg: TrainConfig,
        mesh: Mesh,
        state: TrainState | None = None,
        log_fn: Callable[[str], None] = print,
        checkpoint: CheckpointManager | None = None,
        log_dir: str | None = None,
        profiler=None,
        telemetry=None,
    ) -> None:
        check_mesh(model_cfg, train_cfg, mesh)
        if state is None:
            state = create_train_state(model_cfg, train_cfg, device=mesh.device)
        mesh.broadcast_(list(flatten(state.params).values()))
        self.mesh = mesh
        self.mp = collectives.for_model(mesh, model_cfg)
        self.layout = ShardLayout(mesh, state_to_flat(state))
        names = list(flatten(state.params))
        self.dims = {n: self.layout.dims[f"params/{n}"] for n in names}
        self.splits = {n: self.layout.splits[f"params/{n}"] for n in names}
        mesh.add_groups([GRAD_AXES] + [axes for n in names for axes in (
            self._grad_axes(n), self.layout.group(f"params/{n}"), self.replica_axes[n])])
        if self.split:
            state = self._split(state)
        gathered = any(d is not None for d in self.dims.values())
        tx = make_optimizer(model_cfg, train_cfg)
        tx.norm = self._grad_norm
        if self.split:
            tx.sharding = ParamSharding(self.layout)
        hooks = dict(tx=tx)
        forward_loss = _seq_parallel_forward_loss(mesh, self.dims if gathered else None, self.mp)
        if mesh.shape["pipe"] > 1:
            hooks["grads_fn"] = self._pipeline_grads
            forward_loss = self._pipeline_eval
        if checkpoint is not None and self.split:
            checkpoint.layout = self.layout
        super().__init__(
            model_cfg, train_cfg, state, log_fn,
            forward_loss=forward_loss, sum_across=self._sum_across,
            checkpoint=checkpoint, log_dir=log_dir, profiler=profiler, telemetry=telemetry,
            step_hooks=hooks,
        )
        if train_cfg.steps_per_dispatch > 1:
            why = {
                "gloo": "its sums go through host memory, which a CUDA graph cannot capture",
                "nccl": "capture over NCCL is not ported yet",
            }.get(mesh.process.transport, "the distributed trainer does not capture its steps")
            log_fn(
                f"steps_per_dispatch {train_cfg.steps_per_dispatch}: the steps of a dispatch "
                f"run uncaptured (transport {mesh.process.transport}: {why})"
            )

    @property
    def split(self) -> bool:
        """Whether this process holds a slice of some leaf (fsdp, model or
        expert split it)."""
        return any(self.splits.values())

    @property
    def replica_axes(self) -> dict[str, tuple[str, ...]]:
        """By parameter name, the axes that do not split the leaf: the ranks
        holding the same slice of it."""
        names = self.mesh.cfg.axis_names
        return {n: tuple(a for a in names if a not in split.values())
                for n, split in self.splits.items()}

    # ------------------------------------------------------------ the state
    def _split(self, state: TrainState) -> TrainState:
        """The whole ``state`` cut to this process's slices: each split
        parameter and each optimizer leaf on it."""
        lay = self.layout

        params = {n: lay.local(f"params/{n}", p).requires_grad_(True)
                  for n, p in flatten(state.params).items()}
        opt = state.opt_state
        fields = {f: {n: lay.local(f"{opt.path}/{f}/{n}", t) for n, t in getattr(opt, f).items()}
                  for f in opt.FIELDS}
        return TrainState(state.step, unflatten(params), dataclasses.replace(opt, **fields))

    def full_params(self):
        """The whole parameters (nested) on every process: each slice
        gathered over the axes that split it. A collective: every process
        calls it."""
        with torch.no_grad():
            return unflatten({n: sharding.gather_leaf(p.detach(), self.splits[n], self.mesh)
                              for n, p in flatten(self.state.params).items()})

    # ------------------------------------------------------------ the hooks
    def _grad_axes(self, name: str) -> tuple[str, ...]:
        """The axes ``name``'s gradient is summed over: those of GRAD_AXES
        that do not split the leaf (an fsdp slice's sum over fsdp is its
        gather's reduce-scatter), and ``model`` for the one whole leaf read
        in slices over it (``collectives.summed_over_model``)."""
        split = set(self.splits[name].values())
        axes = tuple(a for a in GRAD_AXES if a not in split)
        return axes + ("model",) if collectives.summed_over_model(name, self.mp) else axes

    def _sum_across(self, grads: dict, metrics: dict) -> None:
        """Each gradient summed over the processes that hold the same slice
        of its leaf and split the step's work (never over ``model``), the
        metric sums over GRAD_AXES: one collective per set of axes."""
        by_axes: dict[tuple[str, ...], list] = {GRAD_AXES: list(metrics.values())}
        for n, g in grads.items():
            by_axes.setdefault(self._grad_axes(n), []).append(g)
        for axes in sorted(by_axes):
            self.mesh.all_reduce_sum_(by_axes[axes], group=axes)

    def _grad_norm(self, grads: dict) -> torch.Tensor:
        """The global norm of the whole gradients: each slice's squares
        summed over the axes that split its leaf, each whole leaf's counted
        once."""
        device = next(iter(grads.values())).device
        by_axes: dict[tuple[str, ...], torch.Tensor] = {}
        for n, g in grads.items():
            axes = self.layout.group(f"params/{n}")
            sq = torch.sum(g.float() * g.float())
            by_axes[axes] = sq if axes not in by_axes else by_axes[axes] + sq
        total = torch.zeros((), device=device)
        for axes in sorted(by_axes):
            self.mesh.all_reduce_sum_([by_axes[axes]], group=axes)
            total = total + by_axes[axes]
        return torch.sqrt(total)

    def _params_for_layers(self, params):
        if any(d is not None for d in self.dims.values()):
            return sharding.GatheredView(params, self.mesh, self.dims)
        return params

    def _pipeline_grads(self, params, tgt, src, key, prepared=None, accumulate=None):
        """The pipelined step's (metrics, grads); with ``accumulate`` (the
        micro-step's MoE aux scale, under ``grad_accum_steps``) the gradient
        of the loss *sum*, as JAX's accumulation takes it."""
        cfg, tcfg = self.model_cfg, self.train_cfg
        inp, labels, key = prepared or _prepare_batch(cfg, tcfg, tgt, key)
        kw = {}
        if accumulate is not None:
            tcfg = dataclasses.replace(tcfg, loss_normalization="tokens")
            kw = dict(total=torch.ones((), device=inp.device), aux_scale=accumulate)
        with model_parallel(self.mp):
            return pipeline_loss_and_grads(
                self.mesh, self._params_for_layers(params), flatten(params), inp, labels, src,
                cfg, tcfg, key, schedule=tcfg.pp_schedule, **kw,
            )

    def _pipeline_eval(self, params, tgt, model_cfg, train_cfg, key, reference=False, src=None,
                       prepared=None):
        """The eval forward under ``pipe``: GPipe's, as in JAX for either
        schedule; returns (loss, metric sums) like ``forward_loss``."""
        inp, labels, key = prepared or _prepare_batch(model_cfg, train_cfg, tgt, key)
        with model_parallel(self.mp):
            metrics, _ = pipeline_loss_and_grads(
                self.mesh, self._params_for_layers(params), flatten(params), inp, labels, src,
                model_cfg, train_cfg, key, reference=reference, grad=False,
            )
        return metrics.pop("loss"), metrics
