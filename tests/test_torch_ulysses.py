"""Ulysses attention: the port's two all-to-alls around the whole-sequence
flash attention, over gloo processes, against the JAX package on the same
numpy inputs.

- Through ``seq_context.seq_parallel_attention(impl="ulysses")`` over 4
  processes (sp 2 for GQA): causal with padding; not causal with padding;
  a causal window of 6 over chunks of 8; GQA with H_kv 2 at sp 2 (kv heads
  ride the all-to-all at their own count); and the repeat corner, H_kv 2
  at sp 4 (kv heads repeated to the query heads first). B 2, S 32, H 4,
  D 16, fp32: forward and the gradients of q, k and v against JAX
  ``dot_product_attention`` under the same masks, within 1e-5.
- The causal padded case against JAX's own
  ``make_sequence_parallel_attention(impl="ulysses")`` (``shard_map`` over
  4 virtual CPU devices, flash in interpret mode), within 1e-5.
- Heads that the ring size does not divide raise, as JAX's do
  (``tests/test_sequence_parallel.py::test_ulysses_rejects_indivisible_heads``).

Workers are module-level functions run in spawned processes (gloo on the
CPU, one thread each); they import no JAX.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

from test_torch_ring_attention import join_job, spawn

CASES = {
    "causal_pad_sp4": dict(sp=4, causal=True),
    "non_causal_pad_sp4": dict(sp=4, causal=False),
    "window6_sp4": dict(sp=4, causal=True, window=6),
    "gqa_hkv2_sp2": dict(sp=2, causal=True, h_kv=2),
    "repeat_hkv2_sp4": dict(sp=4, causal=False, h_kv=2),
}
B, S, H, D = 2, 32, 4, 16


def _inputs(spec, seed=4):
    rng = np.random.default_rng(seed)
    h_kv = spec.get("h_kv", H)

    def rand(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    q, k, v, do = rand(B, S, H, D), rand(B, S, h_kv, D), rand(B, S, h_kv, D), rand(B, S, H, D)
    mask = np.ones((B, S), bool)
    # Tail padding (the whole last chunk at sp 4; with a window, less than
    # it) and a gap shorter than the window, so that every query row sees a
    # real key (JAX's dense softmax spreads a row that sees none evenly; the
    # flash kernels give it 0).
    tail = spec["window"] - 2 if spec.get("window") else 9
    mask[1, S - tail :] = False
    mask[0, 9:12] = False
    return q, k, v, do, mask


def _worker(rank, world, port, names, out_dir):
    from transformer_tpu_torch.config import MeshConfig
    from transformer_tpu_torch.parallel.mesh import make_mesh
    from transformer_tpu_torch.parallel.seq_context import (
        SeqParallelContext,
        seq_parallel_attention,
    )

    mesh = make_mesh(MeshConfig(seq=world), join_job(rank, world, port))
    results = {}
    for name in names:
        spec = CASES[name]
        c = S // world
        part = slice(rank * c, (rank + 1) * c)
        q, k, v, do, mask = (torch.from_numpy(np.ascontiguousarray(a[:, part]))
                             for a in _inputs(spec))
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        ctx = SeqParallelContext(mesh.seq_group, rank, world, rank * c)
        out = seq_parallel_attention(ctx, "ulysses", q, k, v, mask, spec["causal"],
                                     window=spec.get("window", 0))
        out.backward(do)
        for key, x in (("out", out), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
            results[f"{name}/{key}"] = x.detach().numpy()
    np.savez(os.path.join(out_dir, f"{rank}.npz"), **results)
    torch.distributed.destroy_process_group()


def _assemble(out_dir, world):
    parts = [np.load(os.path.join(out_dir, f"{r}.npz")) for r in range(world)]
    return {key: np.concatenate([p[key] for p in parts], axis=1) for key in parts[0].files}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case, one spawn per ring size."""
    out = {}
    for sp in (2, 4):
        names = [n for n, s in CASES.items() if s["sp"] == sp]
        path = tmp_path_factory.mktemp(f"ulysses{sp}")
        spawn(_worker, sp, names, str(path))
        out.update(_assemble(path, sp))
    return out


def _jax_dense(spec, q, k, v, do, mask):
    import jax
    import jax.numpy as jnp

    from transformer_tpu.ops.attention import dot_product_attention
    from transformer_tpu.ops.masks import make_causal_mask

    allowed = jnp.asarray(mask)[:, None, None, :]
    if spec["causal"]:
        allowed = allowed & make_causal_mask(S, window=spec.get("window", 0))

    def f(q, k, v):
        return dot_product_attention(q, k, v, allowed)[0]

    out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    return (out, *vjp(jnp.asarray(do)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_ulysses_matches_jax_dense_attention(runs, name):
    spec = CASES[name]
    want = _jax_dense(spec, *_inputs(spec))
    for key, w in zip(("out", "dq", "dk", "dv"), want):
        np.testing.assert_allclose(runs[f"{name}/{key}"], np.asarray(w), rtol=1e-5, atol=1e-5,
                                   err_msg=key)


def test_ulysses_matches_jax_ulysses():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from transformer_tpu.parallel.ring_attention import make_sequence_parallel_attention

    name = "causal_pad_sp4"
    q, k, v, do, mask = _inputs(CASES[name])
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("seq",))
    fn = make_sequence_parallel_attention(mesh, impl="ulysses")

    def f(q, k, v):
        return fn(q, k, v, kv_mask=jnp.asarray(mask), causal=True)

    want_out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    want = (want_out, *vjp(jnp.asarray(do)))
    with tempfile.TemporaryDirectory() as out_dir:
        spawn(_worker, 4, [name], out_dir)
        got = _assemble(out_dir, 4)
    for key, w in zip(("out", "dq", "dk", "dv"), want):
        np.testing.assert_allclose(got[f"{name}/{key}"], np.asarray(w), rtol=1e-5, atol=1e-5,
                                   err_msg=key)


def _raise_worker(rank, world, port, out_dir):
    from transformer_tpu_torch.config import MeshConfig
    from transformer_tpu_torch.parallel.mesh import make_mesh
    from transformer_tpu_torch.parallel.ring_attention import ulysses_attention

    mesh = make_mesh(MeshConfig(seq=world), join_job(rank, world, port))
    messages = []
    for h, h_kv in ((6, 6), (4, 2)):  # 6 heads over 4; then kv heads not repeated first
        x, kv = torch.zeros(2, 8, h, 16), torch.zeros(2, 8, h_kv, 16)
        try:
            ulysses_attention(x, kv, kv, group=mesh.seq_group)
        except ValueError as e:
            messages.append(str(e))
    np.savez(os.path.join(out_dir, f"{rank}.npz"), messages=np.asarray(messages))
    torch.distributed.destroy_process_group()


def test_ulysses_rejects_indivisible_heads(tmp_path):
    spawn(_raise_worker, 4, str(tmp_path))
    messages = list(np.load(tmp_path / "0.npz")["messages"])
    assert messages == [
        "ulysses needs num_heads (6) divisible by the seq axis (4)",
        "ulysses with grouped kv needs kv heads (2) divisible by the seq axis (4); repeat kv "
        "to full heads first",
    ]
