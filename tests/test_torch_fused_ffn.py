"""Kernel A: the plain version of the port's fused residual+LN+FFN sublayer
against the JAX package's Pallas kernel ``fused_ln_ffn`` (interpret mode),
for all six activations x {pre, post} LN, with non-trivial LN parameters
and dff split into two tiles on the JAX side; and the shapes the CUDA
kernel's tiling takes or refuses, which ``check_kernel_args`` decides on
any device before a build. (The CUDA kernel against the plain version:
tests/test_torch_cuda.py.)

Tolerances: fp32 1e-5 absolute (same casts; the dff contraction is summed
in another order); bf16 3e-2 (outputs are O(1) LayerNorm'd or residual
values, a 3e-2 bound allows a few bf16 ulps placed differently)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_tpu.ops.ffn import fused_ln_ffn as j_fused_ln_ffn
from transformer_tpu_torch.ops import ffn as ffn_mod
from transformer_tpu_torch.ops.ffn import check_kernel_args, fused_ln_ffn, fused_ln_ffn_plain

ACTIVATIONS = ["geglu", "gelu", "reglu", "relu", "silu", "swiglu"]
GATED = {"geglu", "reglu", "swiglu"}


def _case(activation, m=3, d=32, dff=256, seed=0):
    rng = np.random.default_rng(seed)
    lim = (6.0 / (d + dff)) ** 0.5
    ffn = {
        "in": {"kernel": rng.standard_normal((d, dff)) * lim, "bias": rng.standard_normal(dff) * 0.1},
        "out": {"kernel": rng.standard_normal((dff, d)) * lim, "bias": rng.standard_normal(d) * 0.1},
    }
    if activation in GATED:
        ffn["gate"] = {"kernel": rng.standard_normal((d, dff)) * lim,
                       "bias": rng.standard_normal(dff) * 0.1}
    ln = {"scale": 1.0 + 0.1 * rng.standard_normal(d), "bias": 0.1 * rng.standard_normal(d)}
    x = rng.standard_normal((m, d))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    ffn, ln, x = jax.tree.map(f32, ffn), jax.tree.map(f32, ln), f32(x)
    return ffn, ln, x


def _torch(tree, dtype=torch.float32):
    return jax.tree.map(lambda a: torch.from_numpy(a.copy()).to(dtype), tree)


def _jax(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


@pytest.mark.parametrize("norm_scheme", ["pre", "post"])
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_plain_matches_jax_pallas_kernel(activation, norm_scheme):
    ffn, ln, x = _case(activation)
    kw = dict(activation=activation, norm_scheme=norm_scheme, epsilon=1e-6)
    want = j_fused_ln_ffn(
        _jax(ln), _jax(ffn), jnp.asarray(x), block_dff=128, interpret=True, **kw
    )
    got = fused_ln_ffn_plain(_torch(ln), _torch(ffn), torch.from_numpy(x), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("activation", ["relu", "gelu", "swiglu"])
def test_plain_matches_jax_pallas_kernel_bf16(activation):
    ffn, ln, x = _case(activation, seed=1)
    kw = dict(activation=activation, norm_scheme="post", epsilon=1e-6)
    want = j_fused_ln_ffn(
        _jax(ln), _jax(ffn), jnp.asarray(x, jnp.bfloat16), block_dff=128,
        interpret=True, **kw,
    )
    got = fused_ln_ffn_plain(_torch(ln), _torch(ffn), torch.from_numpy(x).bfloat16(), **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=0, atol=3e-2
    )


def test_leading_axes_fold_into_rows():
    ffn, ln, x = _case("relu", m=6)
    x3 = x.reshape(2, 3, -1)
    got = fused_ln_ffn(_torch(ln), _torch(ffn), torch.from_numpy(x3), norm_scheme="post")
    flat = fused_ln_ffn(_torch(ln), _torch(ffn), torch.from_numpy(x), norm_scheme="post")
    assert tuple(got.shape) == x3.shape
    assert torch.equal(got.reshape(6, -1), flat)


def test_wrapper_on_cpu_counts_no_launch():
    ffn, ln, x = _case("swiglu")
    before = fused_ln_ffn.launches
    got = fused_ln_ffn(_torch(ln), _torch(ffn), torch.from_numpy(x), activation="swiglu")
    want = fused_ln_ffn_plain(_torch(ln), _torch(ffn), torch.from_numpy(x), activation="swiglu")
    assert torch.equal(got, want)
    assert fused_ln_ffn.launches == before


def test_unknown_norm_scheme_rejected():
    ffn, ln, x = _case("relu")
    with pytest.raises(ValueError, match="norm_scheme"):
        fused_ln_ffn(_torch(ln), _torch(ffn), torch.from_numpy(x), norm_scheme="mid")


def _kernel_case(m, d, dff, activation="relu", dtype=torch.bfloat16):
    """Zero tensors of the kernel's shapes, on the CPU (only shapes, dtypes,
    devices and addresses are read)."""
    def dense(n_in, n_out):
        return {"kernel": torch.zeros(n_in, n_out, dtype=dtype),
                "bias": torch.zeros(n_out, dtype=dtype)}

    ffn = {"in": dense(d, dff), "out": dense(dff, d)}
    if activation in GATED:
        ffn["gate"] = dense(d, dff)
    ln = {"scale": torch.ones(d, dtype=dtype), "bias": torch.zeros(d, dtype=dtype)}
    return ln, ffn, torch.zeros(m, d, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("activation", ["relu", "swiglu"])
@pytest.mark.parametrize("d,dff", [(128, 512), (512, 2048), (1024, 4096), (64, 256)])
@pytest.mark.parametrize("m", [1, 4, 64, 256])
def test_kernel_takes_the_presets_widths(m, d, dff, activation, dtype):
    """The presets' widths (d 128/512/1024, dff 512/2048/4096), the CUDA
    test's (64, 256), M from 1 to the limit, gated or not, both dtypes."""
    check_kernel_args(*_kernel_case(m, d, dff, activation, dtype), activation)


def _misaligned(t):
    buf = torch.zeros(t.numel() + 1, dtype=t.dtype)
    return buf[1:].view(t.shape)


def _refusal(name):
    """(ln, ffn, x, activation) for one shape the kernel refuses."""
    ln, ffn, x = _kernel_case(4, 512, 2048)
    act = "relu"
    if name == "dtype":
        ln, ffn, x = _kernel_case(4, 512, 2048, dtype=torch.float16)
    elif name == "no_rows":
        x = x[:0]
    elif name == "too_many_rows":
        x = torch.zeros(ffn_mod.MAX_ROWS + 1, 512, dtype=torch.bfloat16)
    elif name == "d_not_a_multiple":
        ln, ffn, x = _kernel_case(4, 96, 2048)
    elif name == "d_too_wide":
        ln, ffn, x = _kernel_case(4, ffn_mod.MAX_D + 64, 2048)
    elif name == "dff_not_whole_clusters_bf16":
        ln, ffn, x = _kernel_case(4, 512, 2048 + 64)
    elif name == "dff_not_whole_clusters_fp32":
        ln, ffn, x = _kernel_case(4, 512, 2048 + 32, dtype=torch.float32)
    elif name == "gate_missing":
        act = "swiglu"
    elif name == "gate_unexpected":
        _, ffn, _ = _kernel_case(4, 512, 2048, "swiglu")
    elif name == "w_out_shape":
        ffn["out"]["kernel"] = torch.zeros(2048, 256, dtype=torch.bfloat16)
    elif name == "b_in_shape":
        ffn["in"]["bias"] = torch.zeros(1024, dtype=torch.bfloat16)
    elif name == "misaligned_weight":
        ffn["in"]["kernel"] = _misaligned(ffn["in"]["kernel"])
    elif name == "misaligned_x":
        x = _misaligned(x)
    elif name == "other_device":
        ln["scale"] = torch.ones(512, dtype=torch.bfloat16, device="meta")
    return ln, ffn, x, act


REFUSALS = {
    "dtype": "float32 or bfloat16", "no_rows": "rows", "too_many_rows": "rows",
    "d_not_a_multiple": "d_model", "d_too_wide": "d_model",
    "dff_not_whole_clusters_bf16": "dff % 128", "dff_not_whole_clusters_fp32": "dff % 64",
    "gate_missing": "needs gate", "gate_unexpected": "takes no gate",
    "w_out_shape": "out weights", "b_in_shape": "in weights",
    "misaligned_weight": "16-byte", "misaligned_x": "x must start", "other_device": "device",
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_kernel_refuses_what_its_tiling_cannot_take(name):
    ln, ffn, x, act = _refusal(name)
    with pytest.raises(ValueError, match=REFUSALS[name]):
        check_kernel_args(ln, ffn, x, act)


def test_workspace_is_kept_and_grown_per_device(monkeypatch):
    """The cluster partials and the tickets (one per 8-row chunk, zero)
    are allocated once per device; a larger call grows the partials and
    keeps the tickets."""
    monkeypatch.setattr(ffn_mod, "_WORKSPACE", {})
    cpu = torch.device("cpu")
    partial, ticket = ffn_mod._workspace(cpu, 100)
    assert partial.numel() == 100
    assert ticket.tolist() == [0] * (ffn_mod.MAX_ROWS // ffn_mod.ROW_CHUNK)
    again = ffn_mod._workspace(cpu, 50)
    assert again[0] is partial and again[1] is ticket
    grown = ffn_mod._workspace(cpu, 200)
    assert grown[0].numel() == 200 and grown[1] is ticket
