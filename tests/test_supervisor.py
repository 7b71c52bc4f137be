"""Supervisor tests (reference src/supervisor.rs: arg assembly,
completion detection, respawn loop)."""

import json
from pathlib import Path

from burn_ppo_tpu.supervisor import TrainingSupervisor, resume_safe_args


def write_latest(run_dir: Path, step: int):
    ckpt = run_dir / "checkpoints" / f"step_{step:08d}"
    ckpt.mkdir(parents=True, exist_ok=True)
    (ckpt / "metadata.json").write_text(json.dumps({"step": step}))
    latest = run_dir / "checkpoints" / "latest"
    if latest.is_symlink():
        latest.unlink()
    latest.symlink_to(ckpt.name)


def test_latest_step_none_without_checkpoint(tmp_path):
    sup = TrainingSupervisor(tmp_path, [], reload_every_n_checkpoints=2, total_steps=100)
    assert sup.latest_step() is None
    assert not sup.is_training_complete()


def test_latest_step_reads_metadata(tmp_path):
    write_latest(tmp_path, 64)
    sup = TrainingSupervisor(tmp_path, [], reload_every_n_checkpoints=2, total_steps=100)
    assert sup.latest_step() == 64
    assert not sup.is_training_complete()


def test_completion_at_total_steps(tmp_path):
    write_latest(tmp_path, 100)
    sup = TrainingSupervisor(tmp_path, [], reload_every_n_checkpoints=2, total_steps=100)
    assert sup.is_training_complete()


def test_completion_past_total_steps(tmp_path):
    write_latest(tmp_path, 150)
    sup = TrainingSupervisor(tmp_path, [], reload_every_n_checkpoints=2, total_steps=100)
    assert sup.is_training_complete()


def test_corrupt_metadata_is_not_complete(tmp_path):
    ckpt = tmp_path / "checkpoints" / "step_00000001"
    ckpt.mkdir(parents=True)
    (ckpt / "metadata.json").write_text("not json")
    latest = tmp_path / "checkpoints" / "latest"
    latest.symlink_to(ckpt.name)
    sup = TrainingSupervisor(tmp_path, [], reload_every_n_checkpoints=2, total_steps=100)
    assert sup.latest_step() is None


def test_run_returns_immediately_when_complete(tmp_path):
    write_latest(tmp_path, 100)
    sup = TrainingSupervisor(
        tmp_path, [], reload_every_n_checkpoints=2, total_steps=100, quiet=True
    )
    assert sup.run() == 0


# ------------------------------------------------------ resume arg filter
def test_resume_safe_args_drops_config_overrides():
    args = [
        "-c", "configs/skull.toml", "--learning-rate", "1e-3",
        "--num-envs", "128", "--quiet", "--total-steps", "5000",
    ]
    assert resume_safe_args(args) == ["--quiet", "--total-steps", "5000"]


def test_resume_safe_args_keeps_runtime_flags():
    args = ["--platform", "cpu", "--profile-dir", "/tmp/x", "--seed", "3"]
    assert resume_safe_args(args) == ["--platform", "cpu", "--profile-dir", "/tmp/x"]


def test_resume_safe_args_handles_equals_form():
    args = ["--total-steps=900", "--gamma=0.9", "--quiet"]
    assert resume_safe_args(args) == ["--total-steps=900", "--quiet"]


def test_resume_safe_args_drops_existing_resume():
    args = ["--resume", "runs/old", "--quiet"]
    assert resume_safe_args(args) == ["--quiet"]


def test_resume_safe_args_boolean_flags_not_greedy():
    # --normalize-obs (no value) followed by a safe flag must not eat it
    args = ["--normalize-obs", "--quiet"]
    assert resume_safe_args(args) == ["--quiet"]


def test_respawn_uses_resume_and_offsets(tmp_path, monkeypatch):
    """Second spawn adds --resume with only resume-safe flags."""
    import burn_ppo_tpu.supervisor as sup_mod

    spawned = []

    class FakeProc:
        def __init__(self, cmd):
            spawned.append(cmd)
            # first child writes a checkpoint short of total; second completes
            step = 50 if len(spawned) == 1 else 100
            write_latest(tmp_path, step)

        def wait(self, timeout=None):
            return 0

    monkeypatch.setattr(
        sup_mod.subprocess, "Popen", lambda cmd: FakeProc(cmd)
    )
    sup = TrainingSupervisor(
        tmp_path,
        ["-c", "x.toml", "--learning-rate", "1e-3", "--quiet"],
        reload_every_n_checkpoints=1,
        total_steps=100,
        quiet=True,
    )
    assert sup.run() == 0
    assert len(spawned) == 2
    first, second = spawned
    assert "--resume" not in first
    assert "-c" in first and "--learning-rate" in first
    assert "--resume" in second
    assert "-c" not in second and "--learning-rate" not in second
    assert "--quiet" in second
    assert "--max-checkpoints-this-run" in first
    assert "--elapsed-time-offset-ms" in second


def test_no_progress_child_ends_loop(tmp_path, monkeypatch):
    """A successful child that saves NO new checkpoint ends the loop
    (supervisor.rs:146-149) — e.g. the time budget is exhausted, so
    every respawn would exit immediately; without this check the
    supervisor spawns no-op children until max_restarts."""
    import burn_ppo_tpu.supervisor as sup_mod

    spawned = []
    write_latest(tmp_path, 50)  # resume point exists, short of total

    class FakeProc:
        def __init__(self, cmd):
            spawned.append(cmd)  # exits without writing a checkpoint

        def wait(self, timeout=None):
            return 0

    monkeypatch.setattr(sup_mod.subprocess, "Popen", lambda cmd: FakeProc(cmd))
    sup = TrainingSupervisor(
        tmp_path, [], reload_every_n_checkpoints=1, total_steps=100,
        quiet=True,
    )
    assert sup.run() == 0
    assert len(spawned) == 1


def test_failed_child_aborts(tmp_path, monkeypatch):
    """A child that exits nonzero is fatal (reference bails,
    supervisor.rs:128-138) — it would fail identically on an immediate
    zero-backoff respawn."""
    import burn_ppo_tpu.supervisor as sup_mod

    spawned = []

    class FakeProc:
        def __init__(self, cmd):
            spawned.append(cmd)

        def wait(self, timeout=None):
            return 3

    monkeypatch.setattr(sup_mod.subprocess, "Popen", lambda cmd: FakeProc(cmd))
    sup = TrainingSupervisor(
        tmp_path, [], reload_every_n_checkpoints=1, total_steps=100,
        quiet=True,
    )
    assert sup.run() == 1
    assert len(spawned) == 1


def test_resume_safe_args_keeps_checkify_and_cache():
    """--checkify / --compilation-cache are runtime flags, not config
    overrides: dropping them would silently turn off NaN checks and
    revert children to the auto cache path mid-run."""
    args = ["--checkify", "--compilation-cache", "/fast/cache", "--seed", "3"]
    assert resume_safe_args(args) == [
        "--checkify", "--compilation-cache", "/fast/cache"
    ]


def test_count_checkpoints_ignores_parked_old_dirs(tmp_path):
    """step_N.old overwrite backups (checkpoint.py's parked dirs) must
    not count as checkpoint progress."""
    d = tmp_path / "checkpoints"
    (d / "step_00000100").mkdir(parents=True)
    (d / "step_00000100.old").mkdir()
    (d / "step_abc").mkdir()
    sup = TrainingSupervisor.__new__(TrainingSupervisor)
    sup.run_dir = tmp_path
    assert sup._count_checkpoints() == 1


_SUPERVISOR_PROBE = """
import sys
from jax._src import xla_bridge
import burn_ppo_tpu.cli as cli
import burn_ppo_tpu.supervisor as sup

def probe(self):
    print("backends_initialized", xla_bridge.backends_are_initialized())
    return 0

sup.TrainingSupervisor.run = probe
sys.exit(cli.main(["train", "-c", "configs/test.toml", "--quiet",
                   "--reload-every-n-checkpoints", "2",
                   "--run-dir", sys.argv[1]]))
"""


def test_supervisor_parent_leaves_jax_backends_uninitialized(tmp_path):
    """The supervisor parent only loads the Config and spawns children:
    it must never open a device, or its process would hold the card's
    memory that the respawned training child needs."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", _SUPERVISOR_PROBE, str(tmp_path / "run")],
        cwd=repo, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "backends_initialized False" in proc.stdout
