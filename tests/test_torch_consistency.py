"""The port's ``utils.consistency`` against the JAX package's.

- ``tree_fingerprint`` of the same numpy leaves (fp32, int32, bf16, a
  0-d step, nested dicts and a list, as a params tree holds them) equals
  JAX's, key for key and digest for digest; the port's tensors give the
  digests of the same bytes.
- Over 2 gloo processes: identical parameters pass; one bit flipped in one
  leaf on rank 1 raises, naming that leaf and rank 1; parameters that hold
  the same NaNs on both ranks pass (bytes, not float equality).
- ``assert_step_deterministic`` passes a pure step and raises on one that
  draws fresh randomness per call.

Workers are module-level functions run in spawned processes (gloo on the
CPU, one thread each); they import no JAX.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_ring_attention import join_job, spawn
from transformer_tpu_torch.utils.consistency import (
    assert_cross_process_consistent,
    assert_step_deterministic,
    fingerprints_equal,
    tree_fingerprint,
)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "step": np.asarray(7, np.int32),
        "encoder": {
            "embedding": {"table": rng.standard_normal((5, 4)).astype(np.float32)},
            "layers": [
                {"ffn": {"in": {"kernel": rng.standard_normal((4, 8)).astype(np.float32),
                                "bias": np.zeros(8, np.float32)}}},
                {"ffn": {"in": {"kernel": rng.standard_normal((4, 8)).astype(np.float32),
                                "bias": np.arange(8, dtype=np.int32)}}},
            ],
        },
    }


def test_tree_fingerprint_equals_jax():
    import jax.numpy as jnp
    import ml_dtypes

    from transformer_tpu.utils.consistency import tree_fingerprint as j_fingerprint

    tree = _tree()
    bf16 = np.random.default_rng(1).standard_normal((3, 2)).astype(ml_dtypes.bfloat16)
    want = j_fingerprint({**tree, "half": jnp.asarray(bf16)})
    got = tree_fingerprint({**tree, "half": torch.from_numpy(
        bf16.view(np.int16).copy()).view(torch.bfloat16)})
    assert got == want
    assert set(got) >= {"step", "encoder/layers/1/ffn/in/bias", "half"}
    # Tensors digest as the arrays of their bytes.
    as_tensors = {"encoder": {"embedding": {"table": torch.from_numpy(
        tree["encoder"]["embedding"]["table"])}}}
    assert tree_fingerprint(as_tensors)["encoder/embedding/table"] == want[
        "encoder/embedding/table"]
    other = _tree(seed=2)
    assert "encoder/embedding/table" in fingerprints_equal(tree_fingerprint(other), got)


def _worker(rank, world, port, out_dir):
    from transformer_tpu_torch.config import MeshConfig
    from transformer_tpu_torch.parallel.mesh import make_mesh

    make_mesh(MeshConfig(data=world), join_job(rank, world, port))
    outcomes = {}
    params = {k: torch.from_numpy(v.copy()) if isinstance(v, np.ndarray) else v
              for k, v in {"a": np.ones((3, 4), np.float32),
                           "b": np.arange(6, dtype=np.float32)}.items()}
    assert_cross_process_consistent(params, label="same")
    outcomes["same"] = "passed"
    flipped = {k: v.clone() for k, v in params.items()}
    if rank == 1:  # one bit of one element
        flipped["b"].view(torch.int32)[4] ^= 1
    try:
        assert_cross_process_consistent(flipped, label="flipped")
        outcomes["flipped"] = "passed"
    except RuntimeError as e:
        outcomes["flipped"] = str(e)
    nans = {"a": torch.full((2, 2), float("nan")), "b": params["b"]}
    assert_cross_process_consistent(nans, label="nans")
    outcomes["nans"] = "passed"
    np.savez(os.path.join(out_dir, f"{rank}.npz"), **{k: np.asarray(v) for k, v in outcomes.items()})
    torch.distributed.destroy_process_group()


def test_cross_process_check_names_the_leaf_and_rank(tmp_path):
    spawn(_worker, 2, str(tmp_path))
    for rank in range(2):
        got = np.load(tmp_path / f"{rank}.npz")
        assert str(got["same"]) == "passed" and str(got["nans"]) == "passed"
        message = str(got["flipped"])
        assert message.startswith("cross-process divergence in flipped: 1 leaves differ "
                                  "across the 2 processes, starting with ['b']"), message
        assert "on 'b' ranks [1] disagree with rank 0" in message


def test_world_of_one_passes_without_a_process_group():
    assert_cross_process_consistent({"a": torch.zeros(2)})


def test_step_determinism():
    x = torch.arange(6, dtype=torch.float32)
    assert_step_deterministic(lambda t: (t * 2, {"sum": t.sum()}), x)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="impure step is nondeterministic: output leaf 0"):
        assert_step_deterministic(lambda t: t + torch.rand(6, generator=gen), x,
                                  label="impure step")
