"""Ring attention: the port's plain ring step, banded chunk backward and
ring over gloo processes against the JAX package, on the same numpy inputs.
(The CUDA ring-step kernel against its plain version: chip_smoke.py.)

- ``flash_ring_step_plain`` against JAX ``flash_ring_step`` (Pallas,
  interpret mode, 16-row tiles) for one hop from a carry that an earlier
  hop left: causal with key padding, not causal, GQA with a band of -3 and
  of 0, C 32. The carry layouts are converted: JAX's m/l (BH, nq, bq, 1)
  and acc (BH, C, D). fp32, within 1e-5 (relative, 1e-5 absolute floor).
- ``flash_chunk_bwd`` with a band (+5, 0, -3 without causality; 7 with
  it; GQA) against JAX ``flash_chunk_bwd``: fp32, 1e-5.
- The port's ring over 4 gloo processes against JAX
  ``make_sequence_parallel_attention(impl="ring")`` on 4 virtual CPU
  devices, once: causal with padding, B 2, S 32, forward and gradients,
  fp32, 1e-5.
- The port's ring against JAX ``dot_product_attention`` under the same
  causal, padding and window masks, forward and gradients, fp32, 1e-5:
  windows 5 and 12 over chunks of 8 (the ring stops after 2 and 3 of 4
  hops and re-homes dK/dV with one shift) and 24 over chunks of 16, GQA,
  not causal, sp 2 and 4.
- ``ring_shift`` moves mixed-dtype tensors one and three places round a
  ring of 4.
- A ring of one with ``reference`` (the plain ring step and chunk
  backward, which a CUDA tensor runs in place of the kernels) gives the
  forward and gradients of the default route bit for bit.

Workers are module-level functions run in spawned processes (gloo on the
CPU, one thread each); they import no JAX.
"""

import os
import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from transformer_tpu_torch.kernels.flash_attention import (
    flash_chunk_bwd,
    flash_fwd_plain,
    flash_ring_step,
    flash_ring_step_plain,
)

MASKED = -1e30


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(worker, nprocs, *args):
    """Run ``worker(rank, nprocs, port, *args)`` in ``nprocs`` spawned
    processes that ``transformer_tpu_torch.parallel.mesh`` can join as a
    ``torch.distributed.run`` job; a failing worker fails the call."""
    os.environ["OMP_NUM_THREADS"] = "1"
    mp.spawn(worker, args=(nprocs, free_port(), *args), nprocs=nprocs, join=True)


def join_job(rank, world, port):
    """Set the launcher's environment and join the job on the CPU."""
    from transformer_tpu_torch.parallel.mesh import initialize_distributed

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    return initialize_distributed("cpu", log_fn=lambda *_: None)


# --------------------------------------------------------------------------
# one hop, and the banded chunk backward, against the JAX kernels


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


STEP_CASES = {
    "causal_mask": dict(causal=True, band=None, h_kv=4, mask=True),
    "non_causal": dict(causal=False, band=None, h_kv=4, mask=False),
    "gqa_band_neg3": dict(causal=False, band=-3, h_kv=2, mask=True),
    "gqa_band_0": dict(causal=False, band=0, h_kv=2, mask=False),
}
B, C, H, D, BLOCK = 2, 32, 4, 16, 16


def _jax_cfg(causal, band, h_kv, has_mask):
    from transformer_tpu.kernels.flash_attention import _FlashConfig

    return _FlashConfig(causal=causal, has_mask=has_mask, block_q=BLOCK, block_k=BLOCK,
                        num_heads=H, scale=D**-0.5, interpret=True, num_kv_heads=h_kv,
                        band=band)


def _fold(x):
    """(B, C, heads, D) numpy -> JAX's (B*heads, C, D)."""
    import jax.numpy as jnp

    b, c, h, d = x.shape
    return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, c, d)


def _rows(x):
    """(B, H, C) -> JAX's per-row (B*H, nq, bq, 1)."""
    import jax.numpy as jnp

    return jnp.asarray(np.asarray(x)).reshape(B * H, C // BLOCK, BLOCK, 1)


def _tiled_mask(mask):
    import jax.numpy as jnp

    return None if mask is None else jnp.asarray(mask.astype(np.int32)).reshape(
        B, C // BLOCK, 1, BLOCK)


def _step_inputs(spec, seed=0):
    rng = np.random.default_rng(seed)
    h_kv = spec["h_kv"]
    q, k0, v0 = _rand(rng, B, C, H, D), _rand(rng, B, C, h_kv, D), _rand(rng, B, C, h_kv, D)
    k, v, do = _rand(rng, B, C, h_kv, D), _rand(rng, B, C, h_kv, D), _rand(rng, B, C, H, D)
    mask = None
    if spec["mask"]:
        mask = np.ones((B, C), bool)
        mask[1, 20:] = False
        mask[0, :3] = False
    return q, (k0, v0), (k, v), do, mask


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_ring_step_plain_matches_jax(name):
    from transformer_tpu.kernels.flash_attention import flash_ring_step as j_step

    spec = STEP_CASES[name]
    q, (k0, v0), (k, v), _, mask = _step_inputs(spec)
    tq, tmask = torch.from_numpy(q), None if mask is None else torch.from_numpy(mask)
    # The carry an earlier, unmasked hop leaves.
    m = torch.full((B, H, C), MASKED)
    l, acc = torch.zeros(B, H, C), torch.zeros(B, C, H, D)
    m, l, acc = flash_ring_step_plain(tq, torch.from_numpy(k0), torch.from_numpy(v0), None,
                                      m, l, acc)
    kw = dict(causal=spec["causal"], band=spec["band"])
    got = flash_ring_step_plain(tq, torch.from_numpy(k), torch.from_numpy(v), tmask, m, l, acc,
                                **kw)
    cfg = _jax_cfg(spec["causal"], spec["band"], spec["h_kv"], mask is not None)
    jm, jl, jacc = j_step(cfg, _fold(q), _fold(k), _fold(v), _tiled_mask(mask), _rows(m),
                          _rows(l), _fold(acc.numpy()))
    want = (np.asarray(jm).reshape(B, H, C), np.asarray(jl).reshape(B, H, C),
            np.asarray(jacc).reshape(B, H, C, D).transpose(0, 2, 1, 3))
    for g, w, label in zip(got, want, ("m", "l", "acc")):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5, err_msg=label)
    # The wrapper on CPU tensors updates the carry in place with the same values.
    carry = [t.clone() for t in (m, l, acc)]
    out = flash_ring_step(tq, torch.from_numpy(k), torch.from_numpy(v), tmask, *carry, **kw)
    assert all(a is b for a, b in zip(out, carry))
    assert all(torch.equal(a, b) for a, b in zip(carry, got))


@pytest.mark.parametrize("causal, band, h_kv", [(False, 5, 4), (False, 0, 2), (False, -3, 2),
                                                 (True, 7, 2)])
def test_chunk_bwd_with_band_matches_jax(causal, band, h_kv):
    from transformer_tpu.kernels.flash_attention import flash_chunk_bwd as j_bwd

    spec = dict(h_kv=h_kv, mask=True)
    q, _, (k, v), do, mask = _step_inputs(spec, seed=1)
    t = torch.from_numpy
    kw = dict(causal=causal, band=band)
    out, lse = flash_fwd_plain(t(q), t(k), t(v), kv_mask=t(mask), **kw)
    delta = (t(do) * out).sum(-1).permute(0, 2, 1).contiguous()
    got = flash_chunk_bwd(t(q), t(k), t(v), t(mask), lse, delta, t(do), **kw)
    want = j_bwd(_jax_cfg(causal, band, h_kv, True), _fold(q), _fold(k), _fold(v),
                 _tiled_mask(mask), _rows(lse), _rows(delta), _fold(do))
    for g, w, heads, label in zip(got, want, (H, h_kv, h_kv), ("dq", "dk", "dv")):
        w = np.asarray(w).reshape(B, heads, C, D).transpose(0, 2, 1, 3)
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5, err_msg=label)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_of_one_reference_matches_the_default_route(causal):
    from transformer_tpu_torch.parallel.ring_attention import ring_attention

    spec = dict(h_kv=2, mask=True)
    q, _, (k, v), do, mask = _step_inputs(spec, seed=2)
    runs = []
    for reference in (False, True):
        q_t, k_t, v_t = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
        out = ring_attention(q_t, k_t, v_t, group=None, kv_mask=torch.from_numpy(mask),
                             causal=causal, reference=reference)
        out.backward(torch.from_numpy(do))
        runs.append([out.detach(), q_t.grad, k_t.grad, v_t.grad])
    for got, want, label in zip(runs[1], runs[0], ("out", "dq", "dk", "dv")):
        assert torch.equal(got, want), label


# --------------------------------------------------------------------------
# the ring over gloo processes


RING_CASES = {
    "causal_pad_sp4": dict(sp=4, causal=True),
    "window5_sp4": dict(sp=4, causal=True, window=5),
    "window12_sp4": dict(sp=4, causal=True, window=12),
    "window24_sp2": dict(sp=2, causal=True, window=24),
    "gqa_sp4": dict(sp=4, causal=True, h_kv=2),
    "non_causal_sp2": dict(sp=2, causal=False),
}
RB, RS, RH, RD = 2, 32, 4, 16


def _ring_inputs(spec, seed=3):
    rng = np.random.default_rng(seed)
    h_kv = spec.get("h_kv", RH)
    q, k, v = _rand(rng, RB, RS, RH, RD), _rand(rng, RB, RS, h_kv, RD), _rand(rng, RB, RS, h_kv, RD)
    do = _rand(rng, RB, RS, RH, RD)
    mask = np.ones((RB, RS), bool)
    # Tail padding and a gap, each shorter than the smallest window, so
    # that every query row sees a real key (JAX's dense softmax spreads a
    # row that sees none evenly; the flash kernels give it 0).
    mask[1, RS - 4:] = False
    mask[0, 9:12] = False
    return q, k, v, do, mask


def _ring_worker(rank, world, port, names, out_dir, shift_dir=None):
    """Each ring case of ``names``, this rank's outputs and gradients
    written to ``<rank>.npz``; with ``shift_dir``, then the ``ring_shift``
    case (``_shift_case``)."""
    from transformer_tpu_torch.parallel.mesh import make_mesh
    from transformer_tpu_torch.config import MeshConfig
    from transformer_tpu_torch.parallel.ring_attention import ring_attention

    process = join_job(rank, world, port)
    mesh = make_mesh(MeshConfig(seq=world), process)
    results = {}
    for name in names:
        spec = RING_CASES[name]
        c = RS // world
        part = slice(rank * c, (rank + 1) * c)
        q, k, v, do, mask = (torch.from_numpy(np.ascontiguousarray(a[:, part]))
                             for a in _ring_inputs(spec))
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        out = ring_attention(q, k, v, group=mesh.seq_group, kv_mask=mask,
                             causal=spec["causal"], window=spec.get("window", 0))
        out.backward(do)
        for key, x in (("out", out), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
            results[f"{name}/{key}"] = x.detach().numpy()
    np.savez(os.path.join(out_dir, f"{rank}.npz"), **results)
    if shift_dir is not None:
        _shift_case(mesh, rank, shift_dir)
    torch.distributed.destroy_process_group()


def _assemble(out_dir, world):
    parts = [np.load(os.path.join(out_dir, f"{r}.npz")) for r in range(world)]
    return {key: np.concatenate([p[key] for p in parts], axis=1) for key in parts[0].files}


@pytest.fixture(scope="module")
def ring_runs(tmp_path_factory):
    """Every ring case, one spawn per ring size, the two started together;
    the ring of 4 also takes the ``ring_shift`` case (``runs["shift"]``,
    its directory)."""
    os.environ["OMP_NUM_THREADS"] = "1"
    started = []
    shift = tmp_path_factory.mktemp("shift")
    for sp in (2, 4):
        names = [n for n, s in RING_CASES.items() if s["sp"] == sp]
        out = tmp_path_factory.mktemp(f"ring{sp}")
        args = (sp, free_port(), names, str(out), str(shift) if sp == 4 else None)
        started.append((sp, out, mp.spawn(_ring_worker, args=args, nprocs=sp, join=False)))
    runs = {}
    for sp, out, context in started:
        while not context.join():
            pass
        runs.update(_assemble(out, sp))
    runs["shift"] = shift
    return runs


def _jax_dense(spec, q, k, v, do, mask):
    """JAX ``dot_product_attention`` under the padding, causal and window
    masks: (out, dq, dk, dv)."""
    import jax
    import jax.numpy as jnp

    from transformer_tpu.ops.attention import dot_product_attention
    from transformer_tpu.ops.masks import make_causal_mask

    allowed = jnp.asarray(mask)[:, None, None, :]
    if spec["causal"]:
        allowed = allowed & make_causal_mask(RS, window=spec.get("window", 0))

    def f(q, k, v):
        return dot_product_attention(q, k, v, allowed)[0]

    out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    return (out, *vjp(jnp.asarray(do)))


@pytest.mark.parametrize("name", sorted(RING_CASES))
def test_ring_matches_jax_dense_attention(ring_runs, name):
    spec = RING_CASES[name]
    want = _jax_dense(spec, *_ring_inputs(spec))
    for key, w in zip(("out", "dq", "dk", "dv"), want):
        np.testing.assert_allclose(ring_runs[f"{name}/{key}"], np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=key)


def test_ring_matches_jax_ring(ring_runs):
    """The one case against JAX's own ring (shard_map over 4 virtual CPU
    devices, Pallas in interpret mode): causal with padding (the port's
    ring from ``ring_runs``)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from transformer_tpu.parallel.ring_attention import make_sequence_parallel_attention

    name = "causal_pad_sp4"
    q, k, v, do, mask = _ring_inputs(RING_CASES[name])
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("seq",))
    fn = make_sequence_parallel_attention(mesh, impl="ring")

    def f(q, k, v):
        return fn(q, k, v, kv_mask=jnp.asarray(mask), causal=True)

    want_out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    want = (want_out, *vjp(jnp.asarray(do)))
    for key, w in zip(("out", "dq", "dk", "dv"), want):
        np.testing.assert_allclose(ring_runs[f"{name}/{key}"], np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=key)


def _shift_case(mesh, rank, out_dir):
    from transformer_tpu_torch.parallel.ring_attention import ring_shift

    tensors = [torch.full((3,), float(rank), dtype=torch.bfloat16),
               torch.tensor([rank % 2 == 0] * 5), torch.arange(7, dtype=torch.float32) + rank]
    one = ring_shift(tensors, mesh.seq_group)
    three = ring_shift(tensors, mesh.seq_group, offset=3)
    np.savez(os.path.join(out_dir, f"{rank}.npz"),
             **{f"one{i}": t.float().numpy() for i, t in enumerate(one)},
             **{f"three{i}": t.float().numpy() for i, t in enumerate(three)},
             dtypes=np.array([str(t.dtype) for t in one + three]))


def test_ring_shift_moves_each_chunk_round_the_ring(ring_runs):
    for rank in range(4):
        got = np.load(ring_runs["shift"] / f"{rank}.npz")
        for label, offset in (("one", 1), ("three", 3)):
            src = (rank - offset) % 4
            np.testing.assert_array_equal(got[f"{label}0"], np.full(3, src))
            np.testing.assert_array_equal(got[f"{label}1"], np.full(5, src % 2 == 0))
            np.testing.assert_array_equal(got[f"{label}2"], np.arange(7) + src)
        assert list(got["dtypes"]) == ["torch.bfloat16", "torch.bool", "torch.float32"] * 2
