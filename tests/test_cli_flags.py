"""CLI override-flag parity with the reference's TrainArgs
(config.rs:63-298): every overridable hyperparameter has a flag that
flows into Config."""

import pytest

from burn_ppo_tpu.cli import TRAIN_OVERRIDE_KEYS, build_parser, collect_overrides
from burn_ppo_tpu.config import Config


def parse(*argv):
    return build_parser().parse_args(["train", *argv])


def test_cnn_shape_flags_flow_to_config():
    ov = collect_overrides(
        parse(
            "--num-conv-layers", "3", "--kernel-size", "5",
            "--cnn-fc-hidden-size", "64", "--cnn-num-fc-layers", "2",
        )
    )
    cfg = Config().apply_overrides(ov)
    assert cfg.num_conv_layers == 3
    assert cfg.kernel_size == 5
    assert cfg.cnn_fc_hidden_size == 64
    assert cfg.cnn_num_fc_layers == 2


def test_adaptive_entropy_knob_flags():
    ov = collect_overrides(
        parse(
            "--adaptive-entropy", "0.6",
            "--adaptive-entropy-min-coef", "0.002",
            "--adaptive-entropy-max-coef", "0.2",
            "--adaptive-entropy-delta", "0.005",
        )
    )
    cfg = Config().apply_overrides(ov)
    assert cfg.adaptive_entropy is not None
    assert cfg.adaptive_entropy_min_coef == 0.002
    assert cfg.adaptive_entropy_max_coef == 0.2
    assert cfg.adaptive_entropy_delta == 0.005


def test_every_override_key_has_a_config_field():
    import dataclasses

    fields = {f.name for f in dataclasses.fields(Config)}
    for key in TRAIN_OVERRIDE_KEYS:
        assert key in fields, key


def test_reference_trainargs_coverage():
    """Every reference TrainArgs hyperparameter (config.rs:63-298,
    minus process-control args handled elsewhere) is overridable."""
    reference_fields = {
        "env", "num_envs", "num_steps", "learning_rate", "entropy_coef",
        "adaptive_entropy", "adaptive_entropy_min_coef",
        "adaptive_entropy_max_coef", "adaptive_entropy_delta",
        "reward_shaping_coef", "gamma", "gae_lambda", "clip_epsilon",
        "value_coef", "max_grad_norm", "target_kl", "total_steps",
        "max_training_time", "num_epochs", "num_minibatches",
        "adam_epsilon", "seed", "hidden_size", "num_hidden", "activation",
        "network_type", "num_conv_layers", "kernel_size",
        "cnn_fc_hidden_size", "cnn_num_fc_layers", "checkpoint_freq",
        "log_freq", "opponent_pool_fraction", "opponent_select_alpha",
        "opponent_select_exponent", "normalize_obs", "normalize_returns",
        "normalize_values", "clip_value", "split_networks",
        "debug_opponents",
    }
    missing = reference_fields - set(TRAIN_OVERRIDE_KEYS)
    assert not missing, f"reference TrainArgs without a CLI override: {missing}"


@pytest.fixture
def cache_config(monkeypatch):
    """Restore JAX's cache settings after a test that sets them."""
    import jax

    names = (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs",
        "jax_persistent_cache_min_entry_size_bytes",
    )
    saved = {n: getattr(jax.config, n) for n in names}
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    yield jax.config
    for n, v in saved.items():
        jax.config.update(n, v)


def test_compilation_cache_flag_and_helper(tmp_path, cache_config):
    from burn_ppo_tpu.cli import build_parser
    from burn_ppo_tpu.utils import enable_compilation_cache

    args = build_parser().parse_args(["train"])
    assert args.compilation_cache == "auto"
    args = build_parser().parse_args(["train", "--compilation-cache", "off"])
    assert enable_compilation_cache(args.compilation_cache) is None

    target = tmp_path / "xla_cache"
    got = enable_compilation_cache(str(target))
    assert got == str(target) and target.is_dir()
    assert cache_config.jax_compilation_cache_dir == str(target)


@pytest.mark.parametrize("spec", ["auto", "off", "explicit"])
def test_compilation_cache_env_var_sets_no_directory(
    tmp_path, monkeypatch, cache_config, spec
):
    """$JAX_COMPILATION_CACHE_DIR wins over every spec, and the code then
    sets no cache directory of its own (JAX reads the variable)."""
    from burn_ppo_tpu.utils import enable_compilation_cache

    before = cache_config.jax_compilation_cache_dir
    env_dir = str(tmp_path / "from_env")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    arg = str(tmp_path / "explicit") if spec == "explicit" else spec
    assert enable_compilation_cache(arg) == env_dir
    assert cache_config.jax_compilation_cache_dir == before
    assert not (tmp_path / "explicit").exists()


@pytest.mark.parametrize("backend,expected", [("gpu", True), ("cpu", False)])
def test_compilation_cache_auto_by_backend(monkeypatch, cache_config,
                                           backend, expected):
    """'auto' caches under <checkout>/.cache/xla on a GPU backend and
    stays off on CPU (XLA:CPU AOT code is host-feature specific)."""
    from pathlib import Path

    import jax

    import burn_ppo_tpu
    from burn_ppo_tpu.utils import enable_compilation_cache

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    got = enable_compilation_cache("auto")
    if expected:
        checkout = Path(burn_ppo_tpu.__file__).resolve().parents[1]
        assert got == str(checkout / ".cache" / "xla")
        assert cache_config.jax_compilation_cache_dir == got
    else:
        assert got is None


def test_main_preserves_train_valued_options(monkeypatch):
    """main() must strip only the subcommand token: an option VALUE that
    happens to be the string "train" (e.g. --run-name train) has to
    survive into the argv used for supervisor child respawns."""
    import burn_ppo_tpu.cli as cli

    seen = {}
    monkeypatch.setattr(
        cli, "run_train", lambda args, argv=None: seen.update(argv=argv) or 0
    )
    cli.main(["train", "--run-name", "train", "--env", "cartpole"])
    assert seen["argv"] == ["--run-name", "train", "--env", "cartpole"]
    # Default-subcommand form (no explicit "train" token).
    cli.main(["--run-name", "train", "--env", "cartpole"])
    assert seen["argv"] == ["--run-name", "train", "--env", "cartpole"]


def test_compilation_cache_empty_env_var_is_unset(monkeypatch, cache_config):
    """JAX_COMPILATION_CACHE_DIR='' (set-but-empty shell/CI artifact) must
    behave like unset — not become an explicit '' cache path."""
    from burn_ppo_tpu.utils import enable_compilation_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "")
    # CPU backend in tests: the backend-gated default applies -> None,
    # and crucially no FileNotFoundError / cwd cache dir from Path('').
    assert enable_compilation_cache("auto") is None


def test_platform_gpu_without_gpu_fails(tmp_path):
    """--platform gpu never falls back to the CPU: with no GPU the CLI
    exits non-zero before building anything."""
    import os
    import subprocess
    import sys

    # No visible card either way, so the check holds on a GPU host too.
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "burn_ppo_tpu", "train", "-c",
         "configs/test.toml", "--platform", "gpu", "--quiet",
         "--run-dir", str(tmp_path / "run")],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "--platform gpu" in proc.stderr and "no GPU" in proc.stderr
    assert not (tmp_path / "run").exists()
