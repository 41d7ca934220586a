"""Pipeline parallelism over processes: GPipe and 1F1B along the ``pipe``
axis.

Port of ``transformer_tpu/parallel/pipeline.py``. The JAX package stacks
a tower's layers on a leading axis, splits it over ``pipe`` inside a
``shard_map`` and runs the schedule as a scan over ticks, every stage
computing every tick (SPMD cannot skip work) and ``ppermute`` moving the
activations. Here each process is one stage of the chain: stage s of P
runs the layers ``s·N/P … (s+1)·N/P - 1`` of each tower, and the
activations and their cotangents go to the next and previous stage by
``send``/``recv``, staged through the host under gloo. A stage computes
only what the schedule gives it, so the warm-up and drain ticks are idle
instead of computing garbage.

- **Microbatches.** This rank's rows of the batch (its ``data × fsdp``
  slice) split into M microbatches. Dropout in layer l of a tower is keyed
  on (tower key, l + 1, microbatch), the embedding's on (tower key, 0,
  microbatch): each (global layer, microbatch) pair gets its own key, as
  JAX folds them, so a pipelined run draws other masks than an unpipelined
  one (in JAX too) and GPipe draws the masks 1F1B draws.
- **GPipe** (``pp_schedule="gpipe"``, and every eval): every forward,
  then every backward. Stage 0 embeds; the last stage runs the final
  LayerNorm and the loss head (``loss_chunks`` included) on its rows and
  seeds the backward; a stage keeps each microbatch's graph (an O(M)
  stash) until its cotangent comes back.
- **1F1B** (``pp_schedule="1f1b"``, ``pipeline_train_1f1b``): JAX's tick
  schedule, M + 2(P - 1) ticks: at tick t stage s runs the forward of
  microbatch t - s without a graph, keeping only its input in a ring of
  ``2P - 1`` slots, and the backward of microbatch t - 2(P - 1) + s, which
  reruns the stage forward from the stashed input and calls
  ``torch.autograd.grad`` on its output's cotangent. Activation memory is
  O(P), independent of M; the stage forward runs twice.
- **Seq2seq.** The encoder stack runs GPipe; its output (after the pre-LN
  final LayerNorm, on the last stage) is broadcast to every stage, where
  the decoder layers' cross-attention reads it. The decoder's cotangent of
  it is summed over the stages and seeds the encoder's backward (under
  1F1B only the decoder stack runs 1F1B, as in JAX's hybrid step).
- **Where the output lands.** JAX psum-broadcasts the last stage's output
  so every stage runs the head; here only the last stage does, and the
  loss, its metric sums and the gradients are summed over the processes
  afterwards, so the metrics are JAX's.
- **MoE.** A homogeneous MoE stack's load-balance loss is each layer's,
  from its microbatch's own routing statistics, summed over layers and
  averaged over microbatches and batch shards (JAX ``pipeline_apply``'s
  ``with_aux``): each layer call's aux enters the objective with weight
  ``moe_aux_weight / (M · batch shards)``.
- **fsdp.** Parameters are read through ``sharding.GatheredView``: a
  stage gathers a layer's fsdp slices when the layer reads them and
  reduce-scatters their gradients back (ZeRO-3, once per layer and
  microbatch, as JAX's ``_gather_layer`` inside the stage scan); the
  split leaves outside the stacks (the embeddings, the output layer) are
  gathered once a step and their gradients summed over the microbatches
  before one reduce-scatter, as JAX runs its prologue and head outside
  the schedule.

``stack_layer_params`` / ``unstack_layer_params`` and the tick arithmetic
(``gpipe_ticks``, ``one_f1b_ticks``, ``one_f1b_stash_slots``) are JAX's.
The train and eval steps run ``pipeline_loss_and_grads`` alone: the
stacking pair and ``pipelined_transformer_apply`` (the GPipe forward to
logits or hiddens) serve only to hold this module to JAX's layouts and
outputs in the tests; no path of the port calls them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from transformer_tpu_torch.config import PAD_ID, ModelConfig, TrainConfig
from transformer_tpu_torch.models.decoder import decoder_layer_apply
from transformer_tpu_torch.models.encoder import (
    _generators,
    _subkey,
    embed_prologue,
    encoder_layer_apply,
)
from transformer_tpu_torch.ops.masks import make_padding_mask
from transformer_tpu_torch.ops.nn import layernorm_apply, remat_layer
from transformer_tpu_torch.parallel.sharding import GatheredView, gather


def stack_layer_params(layers: list[dict]) -> dict:
    """Per-layer parameter trees -> one tree whose leaves carry a leading
    layer axis."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: stack_layer_params([layer[k] for layer in layers]) for k in first}
    return torch.stack(layers)


def unstack_layer_params(stacked: dict, num_layers: int) -> list[dict]:
    """The inverse of ``stack_layer_params``."""
    def pick(node, i):
        if isinstance(node, dict):
            return {k: pick(v, i) for k, v in node.items()}
        return node[i]

    return [pick(stacked, i) for i in range(num_layers)]


def gpipe_ticks(num_microbatches: int, num_stages: int) -> int:
    """Wall ticks of the GPipe forward schedule: M + P - 1 (its backward
    another M + P - 1); bubble share per direction (P - 1) / (M + P - 1)."""
    return num_microbatches + num_stages - 1


def one_f1b_ticks(num_microbatches: int, num_stages: int) -> int:
    """Ticks of the combined 1F1B schedule: M + 2(P - 1), each with one
    stage forward and one stage backward."""
    return num_microbatches + 2 * (num_stages - 1)


def one_f1b_stash_slots(num_stages: int) -> int:
    """Ring slots for stage-input stashes under 1F1B: 2P - 1 (stage s's
    input of microbatch i is written at tick s + i and read at tick
    2(P - 1) + i - s)."""
    return 2 * num_stages - 1


def stage_layers(num_layers: int, num_stages: int, stage: int) -> range:
    """The global layer indices stage ``stage`` of ``num_stages`` runs."""
    per = num_layers // num_stages
    return range(stage * per, (stage + 1) * per)


# Message tags: one block of tags per (stack, direction), one tag per
# microbatch within it.
_TAGS = {("encoder", "fwd"): 0, ("decoder", "fwd"): 1 << 16,
         ("encoder", "bwd"): 2 << 16, ("decoder", "bwd"): 3 << 16}


@dataclasses.dataclass
class _Ctx:
    """One step's pipeline: the mesh, the model, the microbatches of this
    rank's rows, and the accumulated gradients."""

    mesh: Any
    cfg: ModelConfig
    params: Any  # a GatheredView (or plain nested params)
    leaves: dict[str, torch.Tensor]
    key: tuple | None
    reference: bool
    grad: bool
    M: int
    tgt_in: list[torch.Tensor]  # per microbatch: decoder input ids
    src: list[torch.Tensor] | None  # per microbatch: source ids (seq2seq)
    aux_seed: float | torch.Tensor
    grads: dict[str, torch.Tensor] | None = None
    # seq2seq: the encoder output's microbatches as the decoder reads them
    # (leaves that take gradients) and their summed cotangents
    enc_mbs: list[torch.Tensor] | None = None
    d_enc: list[torch.Tensor | None] | None = None
    # fsdp: the split leaves outside the layer stacks (embeddings, final
    # LayerNorms, the output layer), gathered once for the step as JAX's
    # prologue and head are, with their whole gradients summed here
    whole: dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    d_whole: dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    def enc_mb(self, m: int):
        return None if self.enc_mbs is None else self.enc_mbs[m]

    def add_enc_grads(self, got) -> None:
        for m, g in enumerate(got):
            if g is not None:
                self.d_enc[m] = g if self.d_enc[m] is None else self.d_enc[m] + g

    @property
    def stage(self) -> int:
        return self.mesh.index("pipe")

    @property
    def stages(self) -> int:
        return self.mesh.shape["pipe"]

    @property
    def last(self) -> bool:
        return self.stage == self.stages - 1

    def tower_key(self, tower: str):
        if self.cfg.decoder_only:
            return self.key
        return _subkey(self.key, 0 if tower == "encoder" else 1)

    def act_shape(self, tower: str, m: int) -> tuple[int, ...]:
        ids = self.src[m] if tower == "encoder" else self.tgt_in[m]
        return (*ids.shape, self.cfg.d_model)

    def neighbour(self, delta: int) -> int:
        return self.mesh.rank_at(pipe=self.stage + delta)

    def add_grads(self, outputs, grad_outputs, extra=()) -> list:
        """``torch.autograd.grad`` of ``outputs`` (seeded with
        ``grad_outputs``) into the accumulated parameter gradients; returns
        the gradients of ``extra`` (None where unused)."""
        names = list(self.leaves) + [f"whole:{n}" for n in self.whole]
        inputs = [self.leaves[n] for n in self.leaves] + list(self.whole.values())
        inputs += [t for t in extra if t is not None]
        got = torch.autograd.grad(outputs, inputs, grad_outputs, allow_unused=True)
        for n, g in zip(names, got):
            acc = self.d_whole if n.startswith("whole:") else self.grads
            n = n.removeprefix("whole:")
            if g is not None:
                acc[n] = g if acc.get(n) is None else acc[n] + g
        rest = iter(got[len(names):])
        return [None if t is None else next(rest) for t in extra]


def _stage_fn(ctx: _Ctx, tower: str, m: int, enc_mb=None) -> Callable:
    """``run(x) -> (out, aux)``: this stage's layers of ``tower`` on
    microbatch ``m``; stage 0 embeds first (``x`` None)."""
    cfg, params = ctx.cfg, ctx.params
    key = ctx.tower_key(tower)
    deterministic = key is None
    ids = ctx.src[m] if tower == "encoder" else ctx.tgt_in[m]
    self_mask = make_padding_mask(ids)
    cross_mask = None if ctx.src is None or tower == "encoder" else make_padding_mask(ctx.src[m])
    stack = params[tower]
    layers = list(stage_layers(cfg.num_layers, ctx.stages, ctx.stage))

    def layer_call(layer, h, layer_key):
        if tower == "encoder":
            out = encoder_layer_apply(layer, h, self_mask, cfg, layer_key, deterministic,
                                      ctx.reference)
            return out[0], out[-1]
        out = decoder_layer_apply(layer, h, cfg, self_mask=self_mask, enc_out=enc_mb,
                                  cross_mask=cross_mask, key=layer_key,
                                  deterministic=deterministic, reference=ctx.reference)
        return out[0], out[2]

    if cfg.remat and torch.is_grad_enabled():
        layer_call = remat_layer(layer_call, cfg)

    def run(x):
        if x is None:
            (gen,) = _generators(_subkey(key, 0, m), 1, cfg, deterministic, ids.device)
            x = embed_prologue(stack["embedding"], ids, cfg, 0, gen, deterministic)
        aux = None
        layer_params = stack["layers"]
        for i in layers:
            x, a = layer_call(layer_params[i], x, _subkey(key, i + 1, m))
            if a is not None:
                aux = a if aux is None else aux + a
        return x, aux

    return run


def _final(ctx: _Ctx, tower: str, x: torch.Tensor) -> torch.Tensor:
    if ctx.cfg.norm_scheme == "pre":
        return layernorm_apply(ctx.params[tower]["final_ln"], x, ctx.cfg.layernorm_epsilon)
    return x


def _seeds(outputs: list, grads: list, aux, seed):
    """Append a stage's aux and its objective weight to an autograd call."""
    if aux is not None:
        outputs.append(aux)
        grads.append(torch.ones((), dtype=aux.dtype, device=aux.device) * seed)
    return outputs, grads


def _wait(requests) -> None:
    for req, _ in requests:
        req.wait()


def _gpipe_forward(ctx: _Ctx, tower: str) -> list:
    """Every microbatch through this stage's layers of ``tower``: records
    (input, output, aux) per microbatch; sends each output on."""
    mesh, s = ctx.mesh, ctx.stage
    recs, sends = [], []
    for m in range(ctx.M):
        x = None
        if s > 0:
            x = mesh.recv(ctx.act_shape(tower, m), ctx.cfg.compute_dtype, ctx.neighbour(-1),
                          _TAGS[tower, "fwd"] + m)
            x.requires_grad_(ctx.grad)
        enc_mb = None if tower == "encoder" else ctx.enc_mb(m)
        out, aux = _stage_fn(ctx, tower, m, enc_mb)(x)
        if not ctx.last:
            sends.append(mesh.send(out, ctx.neighbour(1), _TAGS[tower, "fwd"] + m))
        recs.append((x, out, aux))
    _wait(sends)
    return recs


def _gpipe_backward(ctx: _Ctx, tower: str, recs: list) -> None:
    """The backward of a non-last stage's records: each microbatch's output
    cotangent received from the next stage, its input's sent back (a
    decoder stage's cotangents of the encoder output kept in ctx)."""
    mesh, sends = ctx.mesh, []
    for m, (x, out, aux) in enumerate(recs):
        d = mesh.recv(out.shape, out.dtype, ctx.neighbour(1), _TAGS[tower, "bwd"] + m)
        outputs, grads = _seeds([out], [d], aux, ctx.aux_seed)
        enc_mb = None if tower == "encoder" else ctx.enc_mb(m)
        got = ctx.add_grads(outputs, grads, (x, enc_mb))
        if enc_mb is not None:
            ctx.add_enc_grads([None] * m + [got[1]])
        if x is not None:
            sends.append(mesh.send(got[0], ctx.neighbour(-1), _TAGS[tower, "bwd"] + m))
    _wait(sends)


def _send_input_grads(ctx: _Ctx, tower: str, xs: list, got: list) -> None:
    sends = [ctx.mesh.send(g, ctx.neighbour(-1), _TAGS[tower, "bwd"] + m)
             for m, (x, g) in enumerate(zip(xs, got)) if x is not None]
    _wait(sends)


def _microbatches(t: torch.Tensor, M: int) -> list[torch.Tensor]:
    if t.shape[0] % M:
        raise ValueError(f"num_microbatches {M} must divide the per-shard batch {t.shape[0]}")
    return list(t.chunk(M))


def _encode(ctx: _Ctx):
    """The encoder stack under GPipe: (records, the last stage's normalized
    output); the encoder output of this rank's rows, broadcast from the
    last stage, lands in ``ctx.enc_mbs`` on every stage."""
    recs = _gpipe_forward(ctx, "encoder")
    shape = (sum(s.shape[0] for s in ctx.src), ctx.src[0].shape[1], ctx.cfg.d_model)
    normed = None
    if ctx.last:
        normed = _final(ctx, "encoder", torch.cat([out for _, out, _ in recs]))
        enc = normed.detach().clone()
    else:
        enc = torch.empty(shape, dtype=ctx.cfg.compute_dtype, device=ctx.src[0].device)
    ctx.mesh.broadcast_([enc], src=ctx.neighbour(ctx.stages - 1 - ctx.stage), group="pipe")
    ctx.enc_mbs = [c.detach().requires_grad_(ctx.grad) for c in enc.chunk(ctx.M)]
    ctx.d_enc = [None] * ctx.M
    return recs, normed


def _encode_backward(ctx: _Ctx, recs, normed) -> None:
    """Sum the stages' cotangents of the encoder output, then run the
    encoder's backward from the last stage down."""
    d_enc = torch.cat([torch.zeros_like(e) if d is None else d
                       for e, d in zip(ctx.enc_mbs, ctx.d_enc)])
    ctx.mesh.all_reduce_sum_([d_enc], group="pipe")
    if ctx.last:
        aux = _sum_aux([a for _, _, a in recs])
        outputs, grads = _seeds([normed], [d_enc], aux, ctx.aux_seed)
        xs = [x for x, _, _ in recs]
        got = ctx.add_grads(outputs, grads, xs)
        _send_input_grads(ctx, "encoder", xs, got)
    else:
        _gpipe_backward(ctx, "encoder", recs)


def _sum_aux(auxes):
    auxes = [a for a in auxes if a is not None]
    return sum(auxes[1:], auxes[0]) if auxes else None


def _head(ctx: _Ctx, hidden, labels, train_cfg: TrainConfig, total):
    """The loss of the last stage's rows: (loss normalized globally, metric
    sums)."""
    from transformer_tpu_torch.train.trainer import loss_from_hidden

    hidden = _final(ctx, "decoder", hidden)
    return loss_from_hidden(ctx.params, hidden, labels, ctx.cfg, train_cfg, total_weight=total)


def _context(mesh, params, leaves, inp, src, cfg: ModelConfig, num_microbatches: int, key,
             reference: bool, grad: bool) -> tuple[_Ctx, slice]:
    """The step's context over this rank's rows (its place in the batch
    group) of the global ``inp`` (and ``src``), and those rows."""
    nb, b = mesh.size("batch"), mesh.group_index("batch")
    rows = inp.shape[0] // nb
    sl = slice(b * rows, (b + 1) * rows)
    M = num_microbatches or mesh.shape["pipe"]
    whole = {}
    if isinstance(params, GatheredView):
        from transformer_tpu_torch.models.transformer import flatten

        for name, part in flatten(dict(params)).items():
            dim = params.dims.get(name)
            if dim is not None and "/layers/" not in name:
                whole[name] = gather(part.detach(), mesh, dim).requires_grad_(grad)
        params = params.with_whole(whole)
    ctx = _Ctx(
        mesh, cfg, params, leaves, key, reference, grad, M,
        _microbatches(inp[sl], M), None if src is None else _microbatches(src[sl], M),
        cfg.moe_aux_weight / (M * nb), {} if grad else None, whole=whole,
    )
    return ctx, sl


def pipelined_transformer_apply(
    mesh,
    params,
    inp: torch.Tensor | None,
    tar: torch.Tensor,
    cfg: ModelConfig,
    num_microbatches: int,
    *,
    key=None,
    reference: bool = False,
    return_hidden: bool = False,
) -> torch.Tensor:
    """The GPipe forward of ``transformer_apply`` (JAX's
    ``pipelined_transformer_apply``) on this rank's rows of the global
    ``tar`` (and source ``inp``): the (rows, S, V) logits, or with
    ``return_hidden`` the decoder hiddens (after the pre-LN final
    LayerNorm), broadcast from the last stage to every stage."""
    ctx, _ = _context(mesh, params, {}, tar, inp, cfg, num_microbatches, key, reference, False)
    with torch.no_grad():
        if inp is not None:
            _encode(ctx)
        recs = _gpipe_forward(ctx, "decoder")
        rows = sum(t.shape[0] for t in ctx.tgt_in)
        if ctx.last:
            out = _final(ctx, "decoder", torch.cat([o for _, o, _ in recs]))
            if not return_hidden:
                from transformer_tpu_torch.models.transformer import project_logits

                out = project_logits(params, out, cfg)
        else:
            width = cfg.d_model if return_hidden else cfg.target_vocab_size
            out = torch.empty((rows, tar.shape[1], width), device=tar.device,
                              dtype=cfg.compute_dtype)
        out = out.contiguous()
        mesh.broadcast_([out], src=ctx.neighbour(ctx.stages - 1 - ctx.stage), group="pipe")
    return out


def pipeline_loss_and_grads(
    mesh,
    params,
    leaves: dict[str, torch.Tensor],
    inp: torch.Tensor,
    labels: torch.Tensor,
    src: torch.Tensor | None,
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    key,
    *,
    reference: bool = False,
    grad: bool = True,
    schedule: str = "gpipe",
    total: torch.Tensor | None = None,
    aux_scale: float | torch.Tensor = 1.0,
) -> tuple[dict, dict | None]:
    """One step's pipelined forward (and, with ``grad``, backward) on this
    rank's rows of a prepared global batch (``inp`` the decoder's input ids,
    ``labels`` its targets, ``src`` a seq2seq source). ``params`` is what
    the layers read (a ``GatheredView`` under fsdp), ``leaves`` what the
    gradients are taken for. Returns (this rank's share of the metrics, its
    gradients by leaf name, or None without ``grad``): the loss and the
    metric sums are the last stage's, the aux every stage's, so their sums
    over the processes are the whole batch's. ``total`` replaces the
    batch's token count as the "tokens" divisor and ``aux_scale`` scales
    the aux's objective weight (a ``grad_accum_steps`` micro-step's loss
    sum and its aux, as JAX's accumulation weighs them)."""
    ctx, sl = _context(mesh, params, leaves, inp, src, model_cfg, train_cfg.pp_microbatches,
                       key, reference, grad)
    ctx.aux_seed = ctx.aux_seed * aux_scale
    M, nb = ctx.M, mesh.size("batch")
    if total is None:
        total = (labels != PAD_ID).sum().float()  # every process holds the whole batch
    labels_mbs = _microbatches(labels[sl], M)
    with torch.set_grad_enabled(grad):
        enc_recs = normed = None
        if src is not None:
            enc_recs, normed = _encode(ctx)
        if grad and schedule == "1f1b":
            metrics, aux = _one_f1b(ctx, labels_mbs, train_cfg, total)
        else:
            metrics, aux = _gpipe_decoder(ctx, labels_mbs, train_cfg, total)
        if enc_recs is not None:
            aux = _sum_aux([aux, *(a for _, _, a in enc_recs)])
            if grad:
                _encode_backward(ctx, enc_recs, normed)
    dev = inp.device
    if model_cfg.moe_experts:
        metrics["moe_aux"] = (torch.zeros((), device=dev) if aux is None
                              else aux.detach().float() / (M * nb))
    metrics = {k: v.detach() for k, v in metrics.items()}
    if not grad:
        return metrics, None
    grads = {n: ctx.grads.get(n) if ctx.grads.get(n) is not None else torch.zeros_like(p)
             for n, p in leaves.items()}
    for name, full in ctx.whole.items():  # one reduce-scatter a step, every rank of the group
        g = ctx.d_whole.get(name)
        g = torch.zeros_like(full) if g is None else g
        grads[name] = grads[name] + mesh.reduce_scatter(g, "fsdp", params.dims[name])
    return metrics, grads


def _zero_metrics(device) -> dict:
    z = torch.zeros((), device=device)
    return {"loss": z, "loss_sum": z.clone(), "weight": z.clone(), "correct": z.clone()}


def _gpipe_decoder(ctx: _Ctx, labels_mbs, train_cfg, total):
    """The decoder stack under GPipe and the head; with gradients, its
    backward. Returns (metrics, this stage's summed aux)."""
    recs = _gpipe_forward(ctx, "decoder")
    aux = _sum_aux([a for _, _, a in recs])
    device = ctx.tgt_in[0].device
    metrics = _zero_metrics(device)
    if ctx.last:
        hidden = torch.cat([out for _, out, _ in recs])
        loss, metrics = _head(ctx, hidden, torch.cat(labels_mbs), train_cfg, total)
        metrics = {"loss": loss, **metrics}
        if ctx.grad:
            outputs, grads = _seeds([loss], [torch.ones_like(loss)], aux, ctx.aux_seed)
            xs = [x for x, _, _ in recs]
            got = ctx.add_grads(outputs, grads, xs + (ctx.enc_mbs or []))
            if ctx.enc_mbs is not None:
                ctx.add_enc_grads(got[len(xs):])
            _send_input_grads(ctx, "decoder", xs, got[: len(xs)])
    elif ctx.grad:
        _gpipe_backward(ctx, "decoder", recs)
    return metrics, aux


def _one_f1b(ctx: _Ctx, labels_mbs, train_cfg, total):
    """The decoder stack under 1F1B (``pipeline_train_1f1b``): JAX's ticks,
    each running this stage's forward of one microbatch (no graph, its
    input stashed) and the backward of another (the stage forward rerun
    from the stash). Returns (metrics, this stage's summed aux)."""
    mesh, s, P, M = ctx.mesh, ctx.stage, ctx.stages, ctx.M
    slots = one_f1b_stash_slots(P)
    stash: dict[int, torch.Tensor | None] = {}
    fwd_in: dict[int, torch.Tensor] = {}
    bwd_in: dict[int, torch.Tensor] = {}
    device = ctx.tgt_in[0].device
    metrics = _zero_metrics(device)
    aux_total = None
    tag_f, tag_b = _TAGS["decoder", "fwd"], _TAGS["decoder", "bwd"]
    for t in range(one_f1b_ticks(M, P)):
        sends = []
        f = t - s
        if 0 <= f < M:
            x = None if s == 0 else fwd_in.pop(f)
            stash[f % slots] = x
            if not ctx.last:  # the last stage's backward half reruns it this tick
                with torch.no_grad():
                    out, _ = _stage_fn(ctx, "decoder", f, ctx.enc_mb(f))(x)
                sends.append(mesh.send(out, ctx.neighbour(1), tag_f + f))
        b = t - 2 * (P - 1) + s
        if 0 <= b < M:
            x = stash.pop(b % slots)
            if x is not None:
                x = x.detach().requires_grad_(True)
            out, aux = _stage_fn(ctx, "decoder", b, ctx.enc_mb(b))(x)
            if aux is not None:
                aux_total = aux.detach() if aux_total is None else aux_total + aux.detach()
            if ctx.last:
                loss, m = _head(ctx, out, labels_mbs[b], train_cfg, total)
                for k, v in {"loss": loss, **m}.items():
                    metrics[k] = metrics[k] + v.detach()
                outputs, grads = [loss], [torch.ones_like(loss)]
            else:
                outputs, grads = [out], [bwd_in.pop(b)]
            outputs, grads = _seeds(outputs, grads, aux, ctx.aux_seed)
            got = ctx.add_grads(outputs, grads, (x, ctx.enc_mb(b)))
            if ctx.enc_mbs is not None:
                ctx.add_enc_grads([None] * b + [got[1]])
            if x is not None:
                sends.append(mesh.send(got[0], ctx.neighbour(-1), tag_b + b))
        nf, nb = f + 1, b + 1  # what this stage runs at tick t + 1
        if s > 0 and 0 <= nf < M:
            fwd_in[nf] = mesh.recv(ctx.act_shape("decoder", nf), ctx.cfg.compute_dtype,
                                   ctx.neighbour(-1), tag_f + nf)
        if not ctx.last and 0 <= nb < M:
            shape = ctx.act_shape("decoder", nb)
            bwd_in[nb] = mesh.recv(shape, ctx.cfg.compute_dtype, ctx.neighbour(1), tag_b + nb)
        _wait(sends)
    return metrics, aux_total
