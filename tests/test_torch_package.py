"""Package-level contracts of the PyTorch port.

- No module of ``transformer_tpu_torch/`` (nor ``chip_smoke.py``, nor the
  card-only ``tests/test_torch_cuda.py``) imports ``jax`` or the JAX
  package ``transformer_tpu``: an AST walk of every import statement.
- ``ModelConfig`` and ``TrainConfig`` have the JAX twins' fields, defaults
  and validation.
- ``convert``: JAX params -> numpy -> port -> numpy is byte-identical,
  int8-quantized exports dequantize as the JAX loader does.
- ``KVPool`` alloc / alias / CoW / free keeps ``check_consistency``.
- Entry points default to CUDA and raise without a card; nothing falls
  back to the CPU unless the caller asks for it.
"""

import ast
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from transformer_tpu.config import ModelConfig as JConfig
from transformer_tpu.config import TrainConfig as JTrain
from transformer_tpu.models import transformer_init
from transformer_tpu.train.checkpoint import _flatten, export_params
from transformer_tpu_torch.config import FFN_ACTIVATIONS, ModelConfig as TConfig
from transformer_tpu_torch.config import TrainConfig as TTrain
from transformer_tpu_torch.convert import load_export, params_from_numpy, params_to_numpy
from transformer_tpu_torch.kernels.kv_pool import KVPool, KVPoolExhausted

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "transformer_tpu_torch")


def _port_sources():
    for dirpath, _, files in os.walk(PORT):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "tests", "test_torch_cuda.py")  # runs where JAX is absent


def _imported_roots(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    sources = list(_port_sources())
    assert len(sources) > 20
    offenders = []
    for path in sources:
        for name in _imported_roots(path):
            root = name.split(".")[0]
            if root in ("jax", "jaxlib", "transformer_tpu", "flax", "optax"):
                offenders.append(f"{os.path.relpath(path, ROOT)}: {name}")
    assert not offenders, offenders


def test_model_config_fields_match_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(JConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(TConfig)]
    assert tf == jf
    from transformer_tpu.ops.ffn import FFN_ACTIVATIONS as J_ACTS

    assert FFN_ACTIVATIONS == J_ACTS


@pytest.mark.parametrize(
    "bad",
    [
        dict(d_model=30, num_heads=4), dict(norm_scheme="mid"),
        dict(ffn_activation="tanh"), dict(num_kv_heads=3),
        dict(position_scheme="rope", d_model=12, num_heads=4),
        dict(moe_experts=2, ffn_activation="swiglu"),
    ],
)
def test_model_config_validation_matches_jax(bad):
    with pytest.raises(ValueError):
        JConfig(**bad)
    with pytest.raises(ValueError):
        TConfig(**bad)


def test_train_config_fields_match_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(JTrain)]
    tf = [(f.name, f.default) for f in dataclasses.fields(TTrain)]
    assert tf == jf


@pytest.mark.parametrize(
    "bad",
    [
        dict(loss_normalization="mean"), dict(objective="span"), dict(mlm_mask_rate=1.0),
        dict(pp_schedule="zb"), dict(optimizer="sgd"), dict(weight_decay=0.1),
        dict(lr_schedule="linear"), dict(lr_schedule="cosine", peak_lr=0.0),
        dict(lr_schedule="cosine", peak_lr=1e-3, warmup_steps=10, lr_decay_steps=10),
        dict(steps_per_dispatch=0),
    ],
)
def test_train_config_validation_matches_jax(bad):
    with pytest.raises(ValueError):
        JTrain(**bad)
    with pytest.raises(ValueError):
        TTrain(**bad)


def test_compute_dtype_is_torch():
    assert TConfig().compute_dtype == torch.bfloat16
    assert TConfig(dtype="float32").compute_dtype == torch.float32


_CONVERT_CASES = {
    "untied_post": dict(),
    "tied_pre_swiglu_gqa": dict(
        tie_output=True, norm_scheme="pre", ffn_activation="swiglu", num_kv_heads=2
    ),
}


@pytest.mark.parametrize("case", sorted(_CONVERT_CASES))
def test_convert_round_trip_is_byte_identical(case):
    kw = dict(
        num_layers=2, d_model=32, num_heads=4, dff=64, input_vocab_size=40,
        target_vocab_size=40, decoder_only=True, **_CONVERT_CASES[case],
    )
    jparams = transformer_init(jax.random.PRNGKey(3), JConfig(**kw))
    flat = _flatten(jparams)
    tparams = params_from_numpy(flat, TConfig(**kw), device="cpu")
    back = params_to_numpy(tparams)
    assert sorted(back) == sorted(flat)
    for key, want in flat.items():
        assert back[key].dtype == want.dtype and back[key].shape == want.shape, key
        assert back[key].tobytes() == want.tobytes(), key


def test_load_export_reads_int8_quantized_exports(tmp_path):
    kw = dict(
        num_layers=1, d_model=32, num_heads=4, dff=64, input_vocab_size=40,
        target_vocab_size=40, decoder_only=True,
    )
    jcfg = JConfig(**kw)
    jparams = transformer_init(jax.random.PRNGKey(4), jcfg)
    export_params(jparams, jcfg, str(tmp_path / "q8"), quantize="int8")
    from transformer_tpu.cli.translate import load_export as j_load_export

    want, _ = j_load_export(str(tmp_path / "q8"))
    got, cfg = load_export(str(tmp_path / "q8"), device="cpu", kv_cache_int8=True)
    assert cfg.kv_cache_int8 and cfg.decoder_only
    flat_want, flat_got = _flatten(want), params_to_numpy(got)
    for key, w in flat_want.items():
        assert flat_got[key].tobytes() == w.tobytes(), key


def test_params_from_numpy_rejects_wrong_shapes():
    kw = dict(num_layers=1, d_model=32, num_heads=4, dff=64, input_vocab_size=40,
              target_vocab_size=40, decoder_only=True)
    flat = _flatten(transformer_init(jax.random.PRNGKey(0), JConfig(**kw)))
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(flat, TConfig(**{**kw, "dff": 128}), device="cpu")
    flat.pop("final/bias")
    with pytest.raises(KeyError, match="final/bias"):
        params_from_numpy(flat, TConfig(**kw), device="cpu")


def test_kv_pool_alloc_alias_cow_free_stays_consistent():
    pool = KVPool(num_blocks=8, block_tokens=4, num_slots=3, slot_blocks=3)
    pool.ensure(0, 9)  # 3 blocks
    pool.check_consistency()
    shared = int(pool.table[0, 0])
    pool.extend(1, bid=shared)  # slot 1 aliases slot 0's first block
    pool.extend(1)
    assert pool.refs(shared) == 2
    pool.check_consistency()
    pairs = pool.make_writable(1, 0, 4)  # CoW split of the shared block
    assert len(pairs) == 1 and pairs[0][0] == shared
    assert pool.refs(shared) == 1
    pool.check_consistency()
    pool.retain(int(pool.table[0, 1]))  # an external pin survives free_slot
    pool.free_slot(0)
    pool.check_consistency()
    assert pool.used_blocks == 3  # slot 1's two blocks + the pinned one
    pool.ensure(2, 12)  # 3 of the 4 free blocks
    with pytest.raises(KVPoolExhausted):
        pool.ensure(0, 12)  # wants 3, one is left
    pool.check_consistency()  # the partial grant stays accounted
    pool.free_slot(0)
    pool.free_slot(1)
    pool.free_slot(2)
    pool.check_consistency()
    assert pool.table_device("cpu").dtype == torch.int32


def test_entry_points_refuse_cuda_without_a_card(tmp_path):
    """Without a card, CUDA is refused, never silently replaced by the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from transformer_tpu_torch.cli import serve
    from transformer_tpu_torch.models.transformer import init_params
    from transformer_tpu_torch.serve.scheduler import ContinuousScheduler

    kw = dict(num_layers=1, d_model=32, num_heads=4, dff=64, input_vocab_size=40,
              target_vocab_size=40, decoder_only=True, dtype="float32")
    cfg = TConfig(**kw)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, gen)
    params = init_params(cfg, gen, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousScheduler(params, cfg, tokenizer=None)
    jcfg = JConfig(**kw)
    export_params(transformer_init(jax.random.PRNGKey(0), jcfg), jcfg, str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_export(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--export_path", str(tmp_path), "--tgt_vocab_file", "unused"])
    from transformer_tpu_torch.cli import train

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--preset", "long4k", "--dataset_path", str(tmp_path),
                    "--ckpt_path", str(tmp_path / "ckpt")])


def test_kernel_wrappers_refuse_other_devices():
    from transformer_tpu_torch.kernels.flash_attention import flash_attention, flash_fwd
    from transformer_tpu_torch.kernels.paged_flash import paged_flash_attention

    x = torch.zeros((1, 8, 2, 8), device="meta")
    for fn in (flash_attention, flash_fwd):
        with pytest.raises(ValueError, match="cpu or cuda"):
            fn(x, x, x, causal=True)

    q = torch.zeros((1, 1, 2, 8), device="meta")
    pool = torch.zeros((2, 4, 2, 8), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        paged_flash_attention(q, pool, pool, torch.zeros((1, 1), dtype=torch.int32),
                              torch.ones((1,), dtype=torch.int32))


def test_init_params_has_the_jax_tree():
    kw = dict(num_layers=2, d_model=32, num_heads=4, dff=64, input_vocab_size=40,
              target_vocab_size=40, decoder_only=True, ffn_activation="geglu",
              norm_scheme="pre")
    from transformer_tpu_torch.models.transformer import init_params

    tparams = init_params(TConfig(**kw), torch.Generator().manual_seed(0), device="cpu")
    flat_t = params_to_numpy(tparams)
    flat_j = _flatten(transformer_init(jax.random.PRNGKey(0), JConfig(**kw)))
    assert {k: v.shape for k, v in flat_t.items()} == {k: v.shape for k, v in flat_j.items()}
    assert all(v.dtype == np.float32 for v in flat_t.values())


def test_console_scripts_exit_zero_after_serving(monkeypatch):
    """``sys.exit(entry())`` must report success: every console script of
    the port names a function that returns 0, not the scheduler."""
    import importlib
    import tomllib

    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    port = {k: v for k, v in scripts.items() if v.startswith("transformer_tpu_torch.")}
    assert port
    for target in port.values():
        module, name = target.split(":")
        mod = importlib.import_module(module)
        monkeypatch.setattr(mod, "main", lambda *a, **k: object())
        assert getattr(mod, name)() == 0
