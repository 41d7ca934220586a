"""Flash attention: the port's plain forward and backward against the JAX
package's Pallas kernels (interpret mode, as tests/test_flash.py runs them
on the CPU), on the same numpy inputs. (The CUDA kernels against the plain
versions: tests/test_torch_cuda.py.)

Cases at B=2, S=128, H=4, D=32: no mask; causal; causal with key padding
(batch row 1 pads its first 5 keys, so its first 5 query rows see no key);
a causal window of 16; GQA (H=4, H_kv=2); S_q=64 != S_k=128 with padding,
not causal; an awkward S=63 with the JAX blocks at 32 (padded to 64 on the
JAX side, ragged in the port); bf16.

Limits: fp32 ``out`` and ``lse`` within 1e-5 absolute; dq/dk/dv within
1e-4 of ||got - want|| / ||want||. bf16: ``out`` within 2**-7 absolute
(one bf16 ulp at |out| < 2: the two sides sum the rows in another order
before the one rounding) and the gradients within 2e-2 relative (dS and P
are rounded to bf16 before the second product, and one ulp of a rounded
operand moves a sum by up to 2**-8 of its terms). The plain backward is also held
against torch autograd through the plain forward, fp32, 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_tpu.kernels.flash_attention import (
    _block_and_padded_len,
    _FlashConfig,
    _fwd,
)
from transformer_tpu.kernels.flash_attention import flash_attention as j_flash
from transformer_tpu_torch.kernels.flash_attention import (
    flash_attention,
    flash_dkdv,
    flash_dkdv_plain,
    flash_dq,
    flash_dq_plain,
    flash_fwd,
    flash_fwd_plain,
)

CASES = {
    "none": dict(),
    "causal": dict(causal=True),
    "causal_pad": dict(causal=True, pad=True),
    "window": dict(causal=True, window=16),
    "gqa": dict(causal=True, h_kv=2),
    "cross": dict(s_q=64, pad=True),
    "awkward": dict(s=63, causal=True, pad=True, block=32),
    "bf16": dict(causal=True, pad=True, dtype="bfloat16"),
}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _case(name, seed=0):
    spec = dict(b=2, s=128, h=4, h_kv=4, d=32, causal=False, window=0, pad=False,
                block=128, dtype="float32")
    spec.update(CASES[name])
    spec.setdefault("s_q", spec["s"])
    rng = np.random.default_rng(seed)
    b, s_q, s_k, h, h_kv, d = (spec[k] for k in ("b", "s_q", "s", "h", "h_kv", "d"))
    q = rng.standard_normal((b, s_q, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s_k, h_kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s_k, h_kv, d)).astype(np.float32)
    do = rng.standard_normal((b, s_q, h, d)).astype(np.float32)
    mask = None
    if spec["pad"]:
        mask = np.ones((b, s_k), bool)
        mask[0, s_k - 20:] = False  # tail padding
        mask[1, :5] = False  # the first 5 causal rows see no key
    return spec, (q, k, v, do), mask


def _torch_inputs(spec, arrays, mask):
    dt = _TORCH[spec["dtype"]]
    q, k, v, do = (torch.from_numpy(a).to(dt) for a in arrays)
    tmask = None if mask is None else torch.from_numpy(mask)
    return q, k, v, do, tmask


def _jax_inputs(spec, arrays, mask):
    dt = jnp.dtype(spec["dtype"])
    q, k, v, do = (jnp.asarray(a, dt) for a in arrays)
    return q, k, v, do, None if mask is None else jnp.asarray(mask)


def _jax_forward_with_lse(spec, q, k, v, mask):
    """JAX's ``_fwd`` on the folded layout, as ``flash_attention`` calls it,
    returning (out (B, S_q, H, D), lse (B, H, S_q))."""
    b, s_q, h, d = q.shape
    s_k, h_kv = k.shape[1], k.shape[2]
    bq, s_q_pad = _block_and_padded_len(s_q, spec["block"])
    bk, s_k_pad = _block_and_padded_len(s_k, spec["block"])
    pad_q, pad_k = s_q_pad - s_q, s_k_pad - s_k
    if pad_k and mask is None and not spec["causal"]:
        mask = jnp.ones((b, s_k), bool)
    if mask is not None and pad_k:
        mask = jnp.pad(mask.astype(jnp.int32), ((0, 0), (0, pad_k)))
    q = jnp.pad(q, ((0, 0), (0, pad_q), (0, 0), (0, 0)))
    k = jnp.pad(k, ((0, 0), (0, pad_k), (0, 0), (0, 0)))
    v = jnp.pad(v, ((0, 0), (0, pad_k), (0, 0), (0, 0)))
    cfg = _FlashConfig(
        causal=spec["causal"], has_mask=mask is not None, block_q=bq, block_k=bk,
        num_heads=h, scale=d**-0.5, interpret=True, num_kv_heads=h_kv,
        band=spec["window"] or None,
    )

    def fold(x):
        return x.transpose(0, 2, 1, 3).reshape(b * x.shape[2], x.shape[1], d)

    m = None if mask is None else mask.astype(jnp.int32).reshape(b, s_k_pad // bk, 1, bk)
    out, lse = _fwd(cfg, fold(q), fold(k), fold(v), m)
    out = out.reshape(b, h, s_q_pad, d).transpose(0, 2, 1, 3)[:, :s_q]
    return out, lse.reshape(b, h, s_q_pad)[:, :, :s_q]


def _np(t):
    return np.asarray(t.float().detach() if isinstance(t, torch.Tensor) else t, np.float32)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_pallas_kernel(name):
    spec, arrays, mask = _case(name)
    kw = dict(causal=spec["causal"], window=spec["window"])
    band = dict(causal=spec["causal"], band=spec["window"] or None)  # the kernel-level spelling
    jq, jk, jv, jdo, jmask = _jax_inputs(spec, arrays, mask)

    def f(q, k, v):
        return j_flash(q, k, v, kv_mask=jmask, block_q=spec["block"],
                       block_k=spec["block"], interpret=True, **kw)

    want_out, vjp = jax.vjp(f, jq, jk, jv)
    want_grads = vjp(jdo)
    _, want_lse = _jax_forward_with_lse(spec, jq, jk, jv, jmask)

    q, k, v, do, tmask = _torch_inputs(spec, arrays, mask)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = flash_attention(q, k, v, kv_mask=tmask, **kw)
    out.backward(do)
    _, lse = flash_fwd_plain(q.detach(), k.detach(), v.detach(), kv_mask=tmask, **band)

    assert out.dtype == q.dtype and tuple(out.shape) == want_out.shape
    bf16 = spec["dtype"] == "bfloat16"
    out_tol = 2**-7 if bf16 else 1e-5
    np.testing.assert_allclose(_np(out), _np(want_out), rtol=0, atol=out_tol)
    np.testing.assert_allclose(_np(lse), _np(want_lse), rtol=0, atol=1e-5 if not bf16 else 1e-4)
    grad_tol = 2e-2 if bf16 else 1e-4
    for got, want, label in zip((q.grad, k.grad, v.grad), want_grads, "qkv"):
        assert got.dtype == q.dtype and tuple(got.shape) == want.shape, label
        assert _rel(got, want) <= grad_tol, (label, _rel(got, want))
    if spec["pad"] and spec["causal"]:
        # Batch row 1's first five query rows see no key: out 0, lse MASKED,
        # and no gradient reaches their queries.
        assert torch.all(out[1, :5] == 0) and torch.all(lse[1, :, :5] == -1e30)
        assert torch.all(q.grad[1, :5] == 0)


@pytest.mark.parametrize("name", ["causal_pad", "gqa", "window", "cross"])
def test_plain_backward_matches_autograd_of_plain_forward(name):
    spec, arrays, mask = _case(name, seed=1)
    kw = dict(causal=spec["causal"], band=spec["window"] or None)
    q, k, v, do, tmask = _torch_inputs(spec, arrays, mask)
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    out, lse = flash_fwd_plain(qr, kr, vr, kv_mask=tmask, **kw)
    want = torch.autograd.grad(out, (qr, kr, vr), do)
    delta = (do * out.detach()).sum(-1).permute(0, 2, 1)
    dq = flash_dq_plain(q, k, v, do, lse.detach(), delta, kv_mask=tmask, **kw)
    dk, dv = flash_dkdv_plain(q, k, v, do, lse.detach(), delta, kv_mask=tmask, **kw)
    for got, w, label in zip((dq, dk, dv), want, "qkv"):
        assert _rel(got, w) <= 1e-4, (label, _rel(got, w))


def test_wrappers_on_cpu_are_the_plain_versions():
    spec, arrays, mask = _case("gqa")
    q, k, v, do, _ = _torch_inputs(spec, arrays, mask)
    kw = dict(causal=True)
    before = (flash_fwd.launches, flash_dq.launches, flash_dkdv.launches)
    out, lse = flash_fwd(q, k, v, **kw)
    want_out, want_lse = flash_fwd_plain(q, k, v, **kw)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    delta = torch.zeros_like(lse)
    assert torch.equal(flash_dq(q, k, v, do, lse, delta, **kw),
                       flash_dq_plain(q, k, v, do, lse, delta, **kw))
    for got, want in zip(flash_dkdv(q, k, v, do, lse, delta, **kw),
                         flash_dkdv_plain(q, k, v, do, lse, delta, **kw)):
        assert torch.equal(got, want)
    assert (flash_fwd.launches, flash_dq.launches, flash_dkdv.launches) == before


@pytest.mark.parametrize(
    "bad, match",
    [
        (dict(window=4), "window requires causal"),
        (dict(causal=True, s_k=64), "S_q == S_k"),
        (dict(h_kv=3), "multiple of kv heads"),
    ],
)
def test_argument_contract(bad, match):
    s_k = bad.pop("s_k", 32)
    h_kv = bad.pop("h_kv", 2)
    q = torch.zeros((1, 32, 4, 8))
    k = torch.zeros((1, s_k, h_kv, 8))
    with pytest.raises(ValueError, match=match):
        flash_attention(q, k, k, **bad)
