"""Speculative decoding for the LM server: draft, verify, roll back.

Port of ``transformer_tpu/serve/speculative.py``. A drafter proposes up to
``k`` candidate tokens; one verify forward (``models/paged_decode.py`` at
S_q = k + 1) scores them all, and the longest prefix the model agrees with
is kept. Greedy requests accept a draft iff it equals the argmax at its
position, so their answers are the plain path's. Sampled requests use
rejection-sampling acceptance (Leviathan et al., arXiv:2211.17192) against
a deterministic drafter: accept ``d`` with probability ``p(d)``, else draw
from ``p`` with ``d`` removed; the output distribution is plain sampling's.

Two drafters behind one duck-typed interface (``start(prompt_ids) ->
state``; ``propose(state, context, k) -> tokens``): ``NgramDrafter``
(model-free prompt lookup) and ``ModelDrafter`` (a small draft export that
shares the target tokenizer, greedy from its own dense KV cache, re-synced
to the accepted history by rollback by index).

The numpy parts (``NgramDrafter``, ``build_verify_row``, ``judge_row``,
``filtered_probs``, ``sampled_accept``) are copies of the JAX package's.
``verify_row_picks`` keys each row's generator by (seed, position + j), as
the scheduler's plain pick keys a row by (seed, position).
``speculative_generate`` is the standalone batch-1 loop over dense KV
caches (``models/transformer.py`` ``transformer_verify``; cached
attention is plain, as in JAX). Both drafters' ``propose`` pass the fault
points ``draft.propose`` (raises) and ``draft.slow`` (stalls) first, as
the JAX package's do.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Protocol, Sequence

import numpy as np
import torch

from transformer_tpu_torch.config import ModelConfig
from transformer_tpu_torch.data.seeding import keyed_rng
from transformer_tpu_torch.models.decoder import init_decoder_caches
from transformer_tpu_torch.models.transformer import transformer_prefill, transformer_verify
from transformer_tpu_torch.ops.attention import rollback_cache
from transformer_tpu_torch.serve.resilience import maybe_fail
from transformer_tpu_torch.train.decode import _bucket, prefill_len_for, sample_token


def _drafter_fault_points() -> None:
    """The drafter's fault points: ``draft.propose`` (a failing drafter:
    the scheduler's speculative breaker fails speculation open to the
    plain path) and ``draft.slow`` (a stalling one: trips the scheduler's
    ``drafter_slow_ms`` budget). No-ops without an armed plane."""
    maybe_fail("draft.propose")
    maybe_fail("draft.slow")


class Drafter(Protocol):
    """What the scheduler requires of a drafter."""

    def start(self, prompt_ids: Sequence[int]) -> Any:
        """Per-request draft state (None for stateless drafters)."""

    def propose(self, state: Any, context: Sequence[int], k: int) -> list[int]:
        """Up to ``k`` candidate tokens continuing ``context`` (the whole
        determined history: prompt + accepted generations); fewer, or
        none, when it has nothing credible."""


# --------------------------------------------------------------------------
# drafters


@dataclasses.dataclass
class _NgramState:
    """Incremental lookup index: n-gram tuple -> start positions
    (ascending). Contexts only grow, so each ``propose`` indexes the new
    tail only."""

    ctx: list[int] = dataclasses.field(default_factory=list)
    occ: dict[tuple[int, ...], list[int]] = dataclasses.field(default_factory=dict)


class NgramDrafter:
    """Model-free prompt-lookup drafting: propose the tokens that followed
    the most recent earlier occurrence of the context's trailing n-gram,
    longest suffix first (``max_n`` down to ``min_n``)."""

    def __init__(self, max_n: int = 3, min_n: int = 1):
        if not 1 <= min_n <= max_n:
            raise ValueError(f"need 1 <= min_n <= max_n, got {min_n}/{max_n}")
        self.max_n = max_n
        self.min_n = min_n

    def start(self, prompt_ids: Sequence[int]) -> _NgramState:
        return _NgramState()

    def _index(self, state: _NgramState, context: Sequence[int]) -> list[int]:
        ctx, occ = state.ctx, state.occ
        if ctx and len(context) >= len(ctx) and int(context[len(ctx) - 1]) != ctx[-1]:
            raise ValueError("NgramDrafter contexts must grow append-only")
        for tok in context[len(ctx):]:
            ctx.append(int(tok))
            for n in range(self.min_n, self.max_n + 1):
                if len(ctx) >= n:
                    occ.setdefault(tuple(ctx[-n:]), []).append(len(ctx) - n)
        return ctx

    def propose(self, state: _NgramState | None, context: Sequence[int], k: int) -> list[int]:
        _drafter_fault_points()
        if state is None:
            state = _NgramState()
        ctx = self._index(state, context)
        for n in range(min(self.max_n, len(ctx) - 1), self.min_n - 1, -1):
            # The most recent earlier occurrence with a full k-token
            # continuation wins; one hugging the context's end is only the
            # fallback.
            starts = state.occ.get(tuple(ctx[-n:]), [])
            fallback: list[int] | None = None
            for start in reversed(starts):
                if start == len(ctx) - n:
                    continue  # the suffix itself
                cont = ctx[start + n : start + n + k]
                if len(cont) == k:
                    return cont
                if cont and fallback is None:
                    fallback = cont
            if fallback:
                return fallback
        return []


@dataclasses.dataclass
class _DraftState:
    caches: list[dict[str, Any]]
    fed: list[int]


class ModelDrafter:
    """A small decoder-only draft model sharing the target tokenizer: one
    batch-1 dense KV cache per request, greedy proposals from it, re-synced
    to the verified history by rolling the cache's index back to the
    longest common prefix of what it fed and what was accepted, then
    feeding the difference in power-of-two chunks."""

    def __init__(
        self,
        params,
        cfg: ModelConfig,
        max_total: int,
        eos_id: int | None = None,
        target_vocab_size: int | None = None,
        device="cuda",
    ):
        if not cfg.decoder_only:
            raise ValueError("ModelDrafter needs a decoder-only draft model")
        if cfg.attention_window:
            raise ValueError(
                "ModelDrafter cannot use a rolling-window cache: rollback "
                "by index cannot restore evicted slots"
            )
        if target_vocab_size is not None and cfg.target_vocab_size != target_vocab_size:
            # A draft id outside the target vocab would index past the
            # target's logits in the acceptance path: refuse at startup.
            raise ValueError(
                f"draft model vocab ({cfg.target_vocab_size}) != target "
                f"vocab ({target_vocab_size}) — speculative drafting "
                "requires a SHARED tokenizer"
            )
        self.params, self.cfg = params, cfg
        self.max_total = max_total
        self.eos_id = eos_id
        self.device = torch.device(device)

    def start(self, prompt_ids: Sequence[int]) -> _DraftState:
        return _DraftState(
            caches=init_decoder_caches(self.cfg, 1, self.max_total, device=self.device), fed=[]
        )

    def _ingest(self, state: _DraftState, toks: list[int]) -> torch.Tensor:
        index = int(state.caches[0]["index"])
        ids = torch.tensor([toks], dtype=torch.long, device=self.device)
        logits, state.caches = transformer_prefill(self.params, ids, state.caches, index, self.cfg)
        state.fed.extend(toks)
        return logits

    def propose(self, state: _DraftState, context: Sequence[int], k: int) -> list[int]:
        _drafter_fault_points()
        ctx = [int(t) for t in context]
        # The draft's own buffer and position budget caps the lookahead.
        k = min(k, self.max_total - 1 - len(ctx), self.cfg.max_position - len(ctx))
        if k <= 0 or not ctx:
            return []
        # Keep the longest common prefix of (fed, ctx), one short of ctx,
        # so the last context token is fed again: its logits give the
        # first proposal.
        m = 0
        limit = min(len(state.fed), len(ctx) - 1)
        while m < limit and state.fed[m] == ctx[m]:
            m += 1
        if m < len(state.fed):
            state.caches = [rollback_cache(c, m) for c in state.caches]
            state.fed = state.fed[:m]
        delta = ctx[m:]
        logits = None
        with torch.no_grad():
            while delta:
                w = prefill_len_for(len(delta)) or 1
                logits = self._ingest(state, delta[:w])
                delta = delta[w:]
            out: list[int] = []
            for i in range(k):
                d = int(torch.argmax(logits[0]))
                out.append(d)
                if self.eos_id is not None and d == self.eos_id:
                    break  # nothing credible follows EOS
                if i + 1 < k:
                    logits = self._ingest(state, [d])
        return out


def drafter_from_flags(
    draft_checkpoint: str,
    draft_ngram: int,
    max_total: int,
    eos_id: int | None = None,
    target_vocab_size: int | None = None,
    device="cuda",
):
    """The configured drafter: a ``ModelDrafter`` over the export at
    ``draft_checkpoint`` (loaded with ``cli/translate.load_export``; it must
    share the target tokenizer, which ``target_vocab_size`` enforces), else
    an ``NgramDrafter`` matching suffixes of up to ``draft_ngram`` tokens."""
    if draft_checkpoint:
        from transformer_tpu_torch.cli.translate import load_export

        d_params, d_cfg = load_export(draft_checkpoint, device=device)
        return ModelDrafter(
            d_params, d_cfg, max_total, eos_id=eos_id,
            target_vocab_size=target_vocab_size, device=device,
        )
    return NgramDrafter(max_n=max(1, draft_ngram))


# --------------------------------------------------------------------------
# verify-row planning and judging


def build_verify_row(
    history: Sequence[int],
    pos: int,
    k: int,
    drafter: Drafter | None,
    dstate: Any,
) -> tuple[list[int], int]:
    """Plan one verify forward for a stream whose cache holds positions
    ``< pos``: ``row[0]`` is the pending token ``history[pos]``, then up to
    ``k`` lookahead tokens, already-determined history first (the prompt
    tail, teacher-forced) and then drafter proposals continuing the
    history. Returns ``(row, n_drafted)``; ``len(row) <= k + 1``."""
    history = list(history)
    row = [int(history[pos])]
    forced = [int(t) for t in history[pos + 1 : pos + 1 + k]]
    row.extend(forced)
    n_drafted = 0
    want = k - len(forced)
    if want > 0 and drafter is not None:
        props = [int(t) for t in drafter.propose(dstate, history, want)][:want]
        row.extend(props)
        n_drafted = len(props)
    return row, n_drafted


def judge_row(
    row: Sequence[int],
    pos: int,
    prompt_len: int,
    accept: Callable[[int, int], tuple[bool, int]],
    bonus: Callable[[int], int],
) -> tuple[list[int], int, int]:
    """Walk one verify row, applying the acceptance rule.

    ``accept(j, draft) -> (accepted, token)`` judges the draft fed at row
    index ``j + 1`` against position ``j``'s output; ``bonus(j)`` picks the
    free token when every draft survived. Picks at positions still inside
    the prompt are discarded. Returns ``(emitted, keep, n_accepted)``: the
    generated tokens, how many fed tokens stay valid in the cache (the
    caller rolls back to ``pos + keep``) and how many drafts were accepted.
    The last emitted token has not been fed: it is the next pending token."""
    emitted: list[int] = []
    n_accepted = 0
    for j in range(len(row)):
        if pos + j + 1 < prompt_len:
            continue  # next position is still prompt: pick discarded
        if j + 1 < len(row):
            ok, tok = accept(j, int(row[j + 1]))
            emitted.append(int(tok))
            if not ok:
                return emitted, j + 1, n_accepted
            n_accepted += 1
        else:
            emitted.append(int(bonus(j)))
            return emitted, j + 1, n_accepted
    return emitted, len(row), n_accepted


def filtered_probs(
    logits: np.ndarray, temperature: float, top_k: int, top_p: float
) -> np.ndarray:
    """The ``sample_token`` distribution (f32 softmax over temperature-
    scaled logits, optional top-k then top-p truncation) in numpy: the
    probability the target assigns to a draft, for rejection sampling."""
    logits = np.asarray(logits, np.float32) / max(float(temperature), 1e-6)
    if top_k > 0:
        kth = np.sort(logits)[-min(top_k, logits.size)]
        logits = np.where(logits < kth, -np.inf, logits)
    if top_p < 1.0:
        order = np.sort(logits)[::-1]
        shifted = order - order[0]
        probs = np.exp(shifted) / np.sum(np.exp(shifted))
        exclusive = np.cumsum(probs) - probs
        kept = exclusive < top_p
        thresh = np.min(np.where(kept, order, np.inf))
        logits = np.where(logits < thresh, -np.inf, logits)
    logits = logits - np.max(logits)
    p = np.exp(logits)
    return p / np.sum(p)


def sampled_accept(
    probs: np.ndarray, draft: int, rng: np.random.Generator
) -> tuple[bool, int]:
    """Rejection-sampling acceptance against a deterministic drafter:
    accept ``draft`` with probability ``p(draft)``, else draw from the
    residual ``p`` with the draft's mass removed."""
    p_d = float(probs[draft])
    if rng.random() < p_d:
        return True, draft
    resid = probs.copy()
    resid[draft] = 0.0
    total = float(resid.sum())
    if total <= 0.0:
        # The draft held all the mass (up to rounding): emit it.
        return True, draft
    return False, int(rng.choice(len(resid), p=resid / total))


def pick_generator(seed: int, position: int, device) -> torch.Generator:
    """The generator of a sampled pick at ``position``: keyed (seed,
    position), so a request's draws do not depend on its neighbours or on
    how many positions one forward scored."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1_000_003 + position) % (1 << 63))
    return gen


def verify_row_picks(
    logits: torch.Tensor,
    seed: int,
    position: int,
    temperature: float,
    *,
    sample: bool,
    top_k: int,
    top_p: float,
) -> list[int]:
    """(W, V) verify logits -> W picks, one per fed position: greedy
    argmax, or a draw from row j's generator keyed (seed, position + j)."""
    if not sample:
        return sample_token(logits).tolist()
    return [
        int(sample_token(
            logits[j : j + 1], pick_generator(seed, position + j, logits.device),
            sample=True, temperature=temperature, top_k=top_k, top_p=top_p,
        )[0])
        for j in range(logits.shape[0])
    ]


# --------------------------------------------------------------------------
# standalone speculative generation (batch-1 host loop)


@torch.no_grad()
def speculative_generate(
    params,
    cfg: ModelConfig,
    prompt_ids: Sequence[int],
    max_new: int,
    eos_id: int,
    *,
    speculate_k: int,
    drafter: Drafter | None = None,
    sample: bool = False,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    seed: int = 0,
    prefill_chunk: int = 0,
) -> tuple[list[int], dict]:
    """Batch-1 speculative continuation of a BOS-led prompt over dense KV
    caches. Returns ``(tokens, stats)``: the generated stream (EOS
    included when generated) and ``verify_forwards`` / ``drafted`` /
    ``accepted``. Greedy tokens equal ``lm_generate``'s; sampled ones keep
    plain sampling's distribution (rejection acceptance).

    The cache buffer is a power of two with ``speculate_k`` rows of slack,
    so a verify row straddling the budget writes in bounds. The prefill
    stops one short of the prompt, so the first pick is a verify
    forward's; each verify rolls the cache back to the accepted prefix."""
    if cfg.attention_window:
        raise ValueError(
            "speculative decoding cannot roll back a rolling-window cache "
            "(attention_window configs serve non-speculatively)"
        )
    if speculate_k < 1:
        raise ValueError(f"speculate_k must be >= 1, got {speculate_k}")
    ids = [int(t) for t in prompt_ids]
    L = len(ids)
    if L < 1:
        raise ValueError("prompt must carry at least the BOS token")
    max_new = min(max_new, cfg.max_position - L)
    if drafter is None:
        drafter = NgramDrafter()
    buf = _bucket(L + max_new + 1 + speculate_k, cfg.max_position + 1 + speculate_k, floor=8)
    device = params["decoder"]["embedding"]["table"].device
    caches = init_decoder_caches(cfg, 1, buf, device=device)
    stats = {"verify_forwards": 0, "drafted": 0, "accepted": 0}
    if max_new < 1:
        return [], stats
    history = list(ids)
    pos = 0
    n = min(prefill_len_for(L, prefill_chunk), L - 1)
    if n >= 1:
        _, caches = transformer_prefill(
            params, torch.tensor([ids[:n]], dtype=torch.long, device=device), caches, 0, cfg,
            chunk=prefill_chunk,
        )
        pos = n
    dstate = drafter.start(ids)
    out: list[int] = []
    finished = False
    while not finished:
        # Cap the row so its writes stay inside the cache buffer.
        k_row = min(speculate_k, buf - pos - 1)
        row, n_drafted = build_verify_row(history, pos, k_row, drafter, dstate)
        stats["drafted"] += n_drafted
        toks = torch.tensor([row], dtype=torch.long, device=device)
        logits, caches = transformer_verify(params, toks, caches, pos, cfg)
        stats["verify_forwards"] += 1
        picks = verify_row_picks(
            logits[0], seed, pos, temperature, sample=sample, top_k=top_k, top_p=top_p
        )
        if sample:
            logits_np = logits[0].float().cpu().numpy()

            def accept(j, draft, _p=pos):
                probs = filtered_probs(logits_np[j], temperature, top_k, top_p)
                return sampled_accept(probs, draft, keyed_rng(seed, _p + j))
        else:
            def accept(j, draft):
                return picks[j] == draft, picks[j]

        emitted, keep, n_accepted = judge_row(row, pos, L, accept, lambda j: picks[j])
        n_consumed = 0
        for tok in emitted:
            if len(out) >= max_new:
                finished = True
                break
            n_consumed += 1
            out.append(int(tok))
            if tok == eos_id:
                finished = True
                break
        # Only consumed emissions count as accepted (a row's tail past EOS
        # or the budget was judged, never emitted).
        stats["accepted"] += min(n_accepted, n_consumed)
        if finished:
            break
        pos += keep
        history = ids + out
        caches = [rollback_cache(c, pos) for c in caches]
    return out, stats
