"""CLI-level end-to-end tests: spawn `python -m burn_ppo_tpu` like the
reference's e2e.rs spawns the binary (help/version, train, resume, fork,
eval, error paths, supervisor reload)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def run_cli(*args, cwd=None, timeout=600, stdin=None):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=2")
    return subprocess.run(
        [sys.executable, "-m", "burn_ppo_tpu", *args],
        capture_output=True,
        text=True,
        cwd=cwd or REPO,
        env=env,
        timeout=timeout,
        input=stdin,
    )


def write_tiny_config(path: Path, **kw):
    lines = {
        "env": '"cartpole"',
        "num_envs": 2,
        "num_steps": 8,
        "total_steps": 64,
        "hidden_size": 16,
        "num_hidden": 1,
        "learning_rate": 1e-3,
        "checkpoint_freq": 32,
        "log_freq": 16,
        "seed": 7,
        "opponent_pool_fraction": 0.0,
    }
    lines.update(kw)
    path.write_text("\n".join(f"{k} = {v}" for k, v in lines.items()) + "\n")
    return path


@pytest.fixture(scope="module")
def trained_run(tmp_path_factory):
    """One tiny trained run shared by the read-only CLI tests."""
    base = tmp_path_factory.mktemp("cli")
    cfgp = write_tiny_config(base / "tiny.toml")
    run_dir = base / "run"
    r = run_cli("train", "-c", str(cfgp), "--run-dir", str(run_dir), "--quiet")
    assert r.returncode == 0, r.stderr
    return run_dir


# ------------------------------------------------------- basics
def test_help_and_version():
    r = run_cli("--help")
    assert r.returncode == 0
    for sub in ("train", "eval", "tournament", "interactive"):
        assert sub in r.stdout
    r = run_cli("--version")
    assert r.returncode == 0
    assert "burn-ppo-tpu" in r.stdout


def test_train_creates_artifacts(trained_run):
    assert (trained_run / "config.toml").exists()
    assert (trained_run / "metrics.jsonl").exists()
    latest = trained_run / "checkpoints" / "latest"
    assert latest.is_symlink()
    meta = json.loads((latest / "metadata.json").read_text())
    assert meta["env_name"] == "cartpole"
    assert meta["step"] >= 64


def test_train_rejects_existing_run_dir(trained_run, tmp_path):
    cfgp = write_tiny_config(tmp_path / "tiny.toml")
    r = run_cli("train", "-c", str(cfgp), "--run-dir", str(trained_run), "--quiet")
    assert r.returncode != 0
    assert "resume" in r.stderr.lower() or "resume" in r.stdout.lower()


def test_missing_config_errors(tmp_path):
    r = run_cli("train", "-c", str(tmp_path / "nope.toml"), "--quiet")
    assert r.returncode != 0


def test_resume_extends_run(trained_run):
    r = run_cli(
        "train", "--resume", str(trained_run), "--total-steps", "128", "--quiet"
    )
    assert r.returncode == 0, r.stderr
    latest = (trained_run / "checkpoints" / "latest").resolve()
    meta = json.loads((latest / "metadata.json").read_text())
    assert meta["step"] >= 128


def test_resume_rejects_config_overrides(trained_run):
    r = run_cli(
        "train", "--resume", str(trained_run), "--learning-rate", "1e-4", "--quiet"
    )
    assert r.returncode != 0
    assert "fork" in (r.stderr + r.stdout).lower()


def test_resume_missing_run_errors(tmp_path):
    r = run_cli("train", "--resume", str(tmp_path / "ghost"), "--quiet")
    assert r.returncode != 0


def test_fork_creates_child_with_lineage(trained_run, tmp_path):
    ckpt = (trained_run / "checkpoints" / "latest").resolve()
    child = tmp_path / "child"
    r = run_cli(
        "train", "--fork", str(ckpt), "--run-dir", str(child),
        "--runs-base", str(tmp_path), "--learning-rate", "5e-4",
        "--total-steps", "128", "--quiet",
    )
    assert r.returncode == 0, r.stderr
    meta = json.loads(
        (child / "checkpoints" / "latest").resolve().joinpath("metadata.json").read_text()
    )
    assert meta["forked_from"] == trained_run.name
    assert meta["step"] >= 128
    cfg_text = (child / "config.toml").read_text()
    assert "0.0005" in cfg_text


def test_fork_invalid_checkpoint_errors(tmp_path):
    r = run_cli("train", "--fork", str(tmp_path / "nothing"), "--quiet")
    assert r.returncode != 0


def test_eval_stats_cli(trained_run):
    r = run_cli(
        "eval", "-c", str(trained_run), "--random", "-n", "4",
        "--num-envs", "2", "--seed", "1",
    )
    assert r.returncode == 0, r.stderr
    assert "Results over" in r.stdout


# ------------------------------------------- CNN / CTDE through the CLI
# (reference e2e.rs:757-1053 CNN train/resume/metadata/eval;
#  e2e.rs:1285-1466 CTDE train + resume)
@pytest.fixture(scope="module")
def cnn_run(tmp_path_factory):
    base = tmp_path_factory.mktemp("cli_cnn")
    cfgp = write_tiny_config(
        base / "cnn.toml",
        env='"connect_four"',
        network_type='"cnn"',
        num_conv_layers=1,
        conv_channels=[4],
        cnn_fc_hidden_size=16,
    )
    run_dir = base / "run"
    r = run_cli("train", "-c", str(cfgp), "--run-dir", str(run_dir), "--quiet")
    assert r.returncode == 0, r.stderr
    return run_dir


def test_cnn_train_metadata_cli(cnn_run):
    latest = (cnn_run / "checkpoints" / "latest").resolve()
    meta = json.loads((latest / "metadata.json").read_text())
    assert meta["network_type"] == "cnn"
    assert meta["env_name"] == "connect_four"
    assert meta["obs_shape"] == [6, 7, 2]
    assert meta["step"] >= 64


def test_cnn_resume_cli(cnn_run):
    r = run_cli(
        "train", "--resume", str(cnn_run), "--total-steps", "128", "--quiet"
    )
    assert r.returncode == 0, r.stderr
    latest = (cnn_run / "checkpoints" / "latest").resolve()
    meta = json.loads((latest / "metadata.json").read_text())
    assert meta["step"] >= 128
    assert meta["network_type"] == "cnn"


def test_cnn_eval_cli(cnn_run):
    r = run_cli(
        "eval", "-c", str(cnn_run), "--random", "-n", "4",
        "--num-envs", "2", "--seed", "2",
    )
    assert r.returncode == 0, r.stderr
    assert "Results over" in r.stdout


# ------------------------------------------- watch mode (eval.rs:1068-1279)
def test_watch_mode_rotates_seats_between_games(cnn_run):
    r = run_cli(
        "eval", "-c", str(cnn_run), "--random", "--watch", "-n", "2",
        "--seed", "3",
    )
    assert r.returncode == 0, r.stderr
    assert "=== Game 1/2 ===" in r.stdout
    assert "=== Game 2/2 ===" in r.stdout
    seat_lines = [l for l in r.stdout.splitlines() if l.startswith("Seats:")]
    assert len(seat_lines) == 2
    # Seat assignment rotates one position per game (2 players: swap).
    assert seat_lines[0] != seat_lines[1]
    p0_g1 = seat_lines[0].split("P0=")[1].split(",")[0]
    p1_g2 = seat_lines[1].split("P1=")[1].split(",")[0]
    assert p0_g1 == p1_g2  # game 1's P0 sits at P1 in game 2
    assert r.stdout.count("Final rewards:") == 2


def test_watch_animate_fps(cnn_run):
    r = run_cli(
        "eval", "-c", str(cnn_run), "--random", "--animate", "--fps", "200",
        "-n", "1", "--seed", "4", timeout=240,
    )
    assert r.returncode == 0, r.stderr
    assert "=== Game 1/1 ===" in r.stdout
    assert "Final rewards:" in r.stdout
    # The board actually rendered between moves.
    assert r.stdout.count("|") > 10


def test_watch_step_mode_waits_for_enter(cnn_run):
    r = run_cli(
        "eval", "-c", str(cnn_run), "--random", "--step", "-n", "1",
        "--seed", "5", stdin="\n" * 200,
    )
    assert r.returncode == 0, r.stderr
    assert "[Enter to continue]" in r.stdout
    assert "Final rewards:" in r.stdout


# ------------------------------------------- human play (human.rs:31-115)
def test_human_play_scripted_stdin(cnn_run):
    script = "help\nrender\nhint\nnot-a-move\n" + "random\n" * 60
    r = run_cli(
        "eval", "-c", str(cnn_run), "--human", "Alice", "-n", "1",
        "--seed", "6", stdin=script,
    )
    assert r.returncode == 0, r.stderr
    assert "Commands:" in r.stdout  # help
    assert "your move>" in r.stdout
    assert "(random)" in r.stdout  # random command echoed the move
    assert "%" in r.stdout  # hint printed move probabilities
    assert "invalid input" in r.stdout or "not legal" in r.stdout
    assert "Final rewards:" in r.stdout
    assert "Wins:" in r.stdout


def test_human_play_quit_immediately(cnn_run):
    r = run_cli(
        "eval", "-c", str(cnn_run), "--human", "Alice", "-n", "1",
        "--seed", "6", stdin="quit\n",
    )
    assert r.returncode == 0, r.stderr
    assert "Wins:" not in r.stdout  # quit before the game finished


@pytest.fixture(scope="module")
def ctde_run(tmp_path_factory):
    base = tmp_path_factory.mktemp("cli_ctde")
    cfgp = write_tiny_config(
        base / "ctde.toml",
        env='"liars_dice"',
        network_type='"ctde"',
        critic_hidden_size=16,
        critic_num_hidden=1,
    )
    run_dir = base / "run"
    r = run_cli("train", "-c", str(cfgp), "--run-dir", str(run_dir), "--quiet")
    assert r.returncode == 0, r.stderr
    return run_dir


def test_ctde_train_metadata_cli(ctde_run):
    latest = (ctde_run / "checkpoints" / "latest").resolve()
    meta = json.loads((latest / "metadata.json").read_text())
    assert meta["network_type"] == "ctde"
    assert meta["env_name"] == "liars_dice"
    assert meta["privileged_obs_dim"] == 120
    assert meta["step"] >= 64


def test_ctde_resume_cli(ctde_run):
    r = run_cli(
        "train", "--resume", str(ctde_run), "--total-steps", "128", "--quiet"
    )
    assert r.returncode == 0, r.stderr
    latest = (ctde_run / "checkpoints" / "latest").resolve()
    meta = json.loads((latest / "metadata.json").read_text())
    assert meta["step"] >= 128


def test_ctde_eval_cli(ctde_run):
    r = run_cli(
        "eval", "-c", str(ctde_run), "-n", "4", "--num-envs", "2",
        "--seed", "3",
    )
    assert r.returncode == 0, r.stderr
    assert "Results over" in r.stdout


def test_sigterm_graceful_checkpoint(tmp_path):
    """SIGTERM (preemption notice) triggers the same graceful exit
    as Ctrl-C: finish the update, write a final checkpoint, exit 0 —
    so --resume recovers the run."""
    import signal as _signal
    import time as _time

    cfgp = write_tiny_config(
        tmp_path / "tiny.toml", total_steps=10_000_000, checkpoint_freq=64,
        log_freq=16,
    )
    run_dir = tmp_path / "sig"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=2")
    proc = subprocess.Popen(
        [
            sys.executable, "-m", "burn_ppo_tpu", "train",
            "-c", str(cfgp), "--run-dir", str(run_dir), "--quiet",
        ],
        cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        # Wait until training is demonstrably under way: a SCALAR metrics
        # row proves an update completed (the startup hparams line alone
        # would leave a step==0 window where SIGTERM checkpoints step 0).
        deadline = _time.time() + 300
        while _time.time() < deadline:
            mpath = run_dir / "metrics.jsonl"
            if mpath.exists() and '"type": "scalar"' in mpath.read_text():
                break
            if proc.poll() is not None:
                raise AssertionError(proc.communicate()[0][-2000:])
            _time.sleep(1)
        proc.send_signal(_signal.SIGTERM)
        out, _ = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out[-2000:]
    latest = run_dir / "checkpoints" / "latest"
    assert latest.exists()
    meta = json.loads((latest.resolve() / "metadata.json").read_text())
    assert meta["step"] > 0
    assert meta["step"] < 10_000_000  # stopped early, gracefully


def test_supervisor_forwards_sigterm(tmp_path):
    """SIGTERM to the SUPERVISOR forwards to the child (final checkpoint)
    and stops the respawn loop instead of immediately respawning."""
    import signal as _signal
    import time as _time

    cfgp = write_tiny_config(
        tmp_path / "tiny.toml", total_steps=10_000_000, checkpoint_freq=64,
        log_freq=16,
    )
    run_dir = tmp_path / "sup"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=2")
    proc = subprocess.Popen(
        [
            sys.executable, "-m", "burn_ppo_tpu", "train",
            "-c", str(cfgp), "--run-dir", str(run_dir),
            "--reload-every-n-checkpoints", "100", "--quiet",
        ],
        cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        deadline = _time.time() + 300
        while _time.time() < deadline:
            mpath = run_dir / "metrics.jsonl"
            if mpath.exists() and '"type": "scalar"' in mpath.read_text():
                break
            if proc.poll() is not None:
                raise AssertionError(proc.communicate()[0][-2000:])
            _time.sleep(1)
        proc.send_signal(_signal.SIGTERM)
        # Generous: under full-suite CPU contention the child's current
        # update + checkpoint write can take a while.
        out, _ = proc.communicate(timeout=420)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out[-2000:]
    meta = json.loads(
        (run_dir / "checkpoints" / "latest").resolve()
        .joinpath("metadata.json").read_text()
    )
    assert 0 < meta["step"] < 10_000_000, out[-2000:]


def test_supervisor_reload_cli(tmp_path):
    cfgp = write_tiny_config(tmp_path / "tiny.toml")
    run_dir = tmp_path / "suprun"
    r = run_cli(
        "train", "-c", str(cfgp), "--run-dir", str(run_dir),
        "--reload-every-n-checkpoints", "1", "--quiet",
        timeout=900,
    )
    assert r.returncode == 0, r.stderr
    latest = (run_dir / "checkpoints" / "latest").resolve()
    meta = json.loads((latest / "metadata.json").read_text())
    assert meta["step"] >= 64
