"""The JAX CLI's flag surface on the port's entry points.

JAX's flag names, kinds and defaults are read from the source of
``transformer_tpu/cli/flags.py`` (``define_flags`` and
``define_metrics_flags``: the two trainers' flags) and of
``cli/serve.py`` + ``cli/translate.py`` (``define_serve_flags``,
``define_export_serving_flags``: the server's), so absl's global flag
registry is left alone. Then:

- every name parses in ``cli.train``, ``cli.distributed_train`` and (the
  server's) ``cli.serve``, at JAX's default with absl's spellings
  (``--name=value``, and ``--name`` / ``--noname`` for a boolean): never
  argparse's usage error (exit code 2), and each default is JAX's;
- away from its default every flag is accepted, or refused with a
  message that names it (``--moe_experts``; the unported mesh axes of the
  distributed trainer); the telemetry, profiler and TensorBoard flags and
  ``--slo_spec`` are accepted;
- ``--platform``: ``cpu`` means the CPU, ``gpu``/``cuda`` the card; any
  other value, or one that disagrees with ``--device``, is refused;
- ``--enable_function=false`` trains and refuses ``--steps_per_dispatch
  2`` with JAX's message.
"""

import ast
import io
import os

import pytest

from transformer_tpu_torch.cli import distributed_train, serve, train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = os.path.join(ROOT, "transformer_tpu", "cli")


def _jax_flags(path: str, functions: set[str]) -> dict[str, tuple[str, object]]:
    """{name: (kind, default)} of the ``flags.DEFINE_*`` calls inside the
    named functions of a JAX CLI source file."""
    tree = ast.parse(open(path, encoding="utf-8").read())
    out = {}
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef) and fn.name in functions):
            continue
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr.startswith("DEFINE_")):
                name = ast.literal_eval(node.args[0])
                default = eval(compile(ast.Expression(node.args[1]), path, "eval"),
                               {"__builtins__": {}})
                out[name] = (node.func.attr[len("DEFINE_"):], default)
    return out


TRAIN_FLAGS = _jax_flags(os.path.join(CLI, "flags.py"), {"define_flags", "define_metrics_flags"})
SERVE_FLAGS = {
    **_jax_flags(os.path.join(CLI, "serve.py"), {"define_serve_flags"}),
    **_jax_flags(os.path.join(CLI, "translate.py"), {"define_export_serving_flags"}),
    **_jax_flags(os.path.join(CLI, "flags.py"), {"define_metrics_flags"}),
}
TRAINERS = {
    "train": lambda argv: train.resolve_flags(argv),
    "distributed_train": lambda argv: train.resolve_flags(
        argv, distributed_train._FLAGS, distributed_train.__doc__),
}
# Set away from JAX's default, these are refused with a message naming them.
REFUSED = {"moe_experts"}
# The server refuses none of JAX's flags.
SERVE_REFUSED: set[str] = set()


def test_the_jax_sets_are_read():
    assert len(TRAIN_FLAGS) == 79 and "enable_function" in TRAIN_FLAGS
    assert TRAIN_FLAGS["target_vocab_size"] == ("integer", 2**15)
    assert len(SERVE_FLAGS) == 32 and "slo_spec" in SERVE_FLAGS


def _spell(kind: str, name: str, value) -> list[str]:
    if kind == "boolean":
        return [f"--{name}" if value else f"--no{name}"]
    return [f"--{name}={value}"]


def _other(kind: str, default):
    """A value other than ``default`` of the flag's kind."""
    return {"boolean": lambda d: not d, "integer": lambda d: d + 2,
            "float": lambda d: d + 0.5, "string": lambda d: d + "x"}[kind](default)


@pytest.mark.parametrize("name", sorted(TRAIN_FLAGS))
@pytest.mark.parametrize("trainer", sorted(TRAINERS))
def test_trainer_parses_every_jax_flag_at_its_default(trainer, name):
    kind, default = TRAIN_FLAGS[name]
    for argv in (_spell(kind, name, default), [f"--{name}={default}"]):
        args = TRAINERS[trainer](argv)
        assert getattr(args, name) == default, (argv, getattr(args, name))


# Enums and --platform take their other values in tests of their own.
VALUED = sorted(n for n, (kind, _) in TRAIN_FLAGS.items() if kind != "enum" and n != "platform")


@pytest.mark.parametrize("name", VALUED)
@pytest.mark.parametrize("trainer", sorted(TRAINERS))
def test_trainer_accepts_or_refuses_by_name_away_from_the_default(trainer, name):
    kind, default = TRAIN_FLAGS[name]
    value = _other(kind, default)
    if name in REFUSED:
        with pytest.raises(SystemExit, match=f"--{name}"):
            TRAINERS[trainer](_spell(kind, name, value))
    else:
        assert getattr(TRAINERS[trainer](_spell(kind, name, value)), name) == value


@pytest.mark.parametrize("name", sorted(SERVE_FLAGS))
def test_serve_parses_every_jax_flag(name):
    kind, default = SERVE_FLAGS[name]
    base = ["--export_path", "x"]
    args = serve.build_parser().parse_args(base + _spell(kind, name, default))
    assert getattr(args, name) == default
    if kind in ("enum",) or name == "platform":
        return
    value = _other(kind, default)
    args = serve.build_parser().parse_args(base + _spell(kind, name, value))
    if name in SERVE_REFUSED:
        with pytest.raises(SystemExit, match=f"--{name}"):
            serve.main(base + _spell(kind, name, value), stdin=io.StringIO(""))
    else:
        assert getattr(args, name) == value


def test_enum_values_parse_as_jax_spells_them():
    assert train.resolve_flags(["--pp_schedule=1f1b"]).pp_schedule == "1f1b"
    assert train.resolve_flags(["--optimizer", "adafactor", "--objective=mlm"]).optimizer == \
        "adafactor"
    args = serve.build_parser().parse_args(["--kv_layout=paged", "--decode_kernel",
                                            "paged_flash"])
    assert (args.kv_layout, args.decode_kernel) == ("paged", "paged_flash")


@pytest.mark.parametrize("argv,device", [
    (["--platform", "cpu"], "cpu"), (["--platform=gpu"], "cuda"), (["--platform", "cuda"],
                                                                   "cuda"),
    (["--platform", "cpu", "--device", "cpu"], "cpu"), ([], "cuda"), (["--device=cpu"], "cpu"),
])
def test_platform_picks_the_device(argv, device):
    assert train.resolve_flags(argv).device == device
    from transformer_tpu_torch.cli.translate import build_parser, export_device

    assert export_device(build_parser().parse_args(argv)) == device


@pytest.mark.parametrize("argv,match", [
    (["--platform", "tpu"], "--platform 'tpu'"),
    (["--platform", "cpu", "--device", "cuda"], "conflicts with --device"),
    (["--platform", "gpu", "--device", "cpu"], "conflicts with --device"),
])
def test_platform_refusals(argv, match):
    from transformer_tpu_torch.cli.translate import build_parser, export_device

    with pytest.raises(SystemExit, match=match):
        train.resolve_flags(argv)
    with pytest.raises(SystemExit, match=match):
        export_device(build_parser().parse_args(argv))


@pytest.mark.parametrize("name,value", [("dcn_data", "2"), ("pp_microbatches", "4"),
                                        ("pp_schedule", "1f1b"), ("fsdp", "2")])
def test_distributed_train_refuses_unported_axes_by_name(name, value):
    with pytest.raises(NotImplementedError, match=f"--{name}"):
        distributed_train.main([f"--{name}", value, "--device", "cpu"])


def test_absl_boolean_spellings():
    for argv, want in ((["--remat"], True), (["--noremat"], False), (["--remat=false"], False),
                       (["--remat=t"], True), (["--remat", "0"], False), ([], False)):
        assert train.resolve_flags(argv).remat is want, argv
    assert serve.build_parser().parse_args(["--nokv_cache_int8"]).kv_cache_int8 is False
    assert serve.build_parser().parse_args(["--kv_cache_int8"]).kv_cache_int8 is True


@pytest.fixture(scope="module")
def lm_corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("flags_corpus")
    with open(os.path.join(ROOT, "data", "tgt-train.txt"), encoding="utf-8") as f:
        (d / "tgt-train.txt").write_text("".join(next(f) for _ in range(60)), encoding="utf-8")
    (d / "src-train.txt").write_text((d / "tgt-train.txt").read_text(encoding="utf-8"),
                                     encoding="utf-8")
    return d


def _lm_argv(d, tmp_path, *extra):
    return ["--device=cpu", "--decoder_only", "--dataset_path", str(d), "--tgt_vocab_file",
            str(d / "v.subwords"), "--target_vocab_size", "300", "--num_layers", "1",
            "--d_model", "16", "--dff", "32", "--num_heads", "2", "--sequence_length", "32",
            "--batch_size", "8", "--epochs", "1", "--ckpt_path", str(tmp_path / "ckpt"),
            "--export_path", str(tmp_path / "export"), *extra]


def test_enable_function_false_trains_and_refuses_steps_per_dispatch(lm_corpus, tmp_path):
    trainer = train.main(_lm_argv(lm_corpus, tmp_path, "--enable_function=false",
                                  "--per_replica_batch_size", "8", "--buffer_size", "10",
                                  "--dp", "2", "--platform", "cpu"), log_fn=lambda _: None)
    assert trainer.train_cfg.enable_function is False and trainer.multi_step is None
    assert trainer.state.step == len(trainer.step_seconds) > 0
    with pytest.raises(ValueError, match="steps_per_dispatch > 1 requires enable_function="
                                         "True on the single-process Trainer"):
        train.main(_lm_argv(lm_corpus, tmp_path / "k", "--noenable_function",
                            "--steps_per_dispatch", "2"), log_fn=lambda _: None)
