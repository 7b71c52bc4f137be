"""Tests that need an NVIDIA GPU (``pytest -m gpu``). Each drives the
card from a child process, since this suite's own process is pinned to
the CPU; the ``gpu_env`` fixture skips them where no card is visible."""

import json
import os
import subprocess
import sys

import pytest

from burn_ppo_tpu import parity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
pytestmark = pytest.mark.gpu


def _child(args, env, timeout=600):
    proc = subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_default_device_is_gpu(gpu_env):
    info = json.loads(_child(["-m", "burn_ppo_tpu.parity", "device"],
                             gpu_env).strip().splitlines()[-1])
    assert info["platform"] == "gpu" and info["count"] >= 1


def test_gpu_matches_cpu_on_small_rollout(gpu_env, tmp_path):
    """parity (a)-(d) at the flagship's widths on a 64-env rollout."""
    ref, dev = tmp_path / "cpu.npz", tmp_path / "gpu.npz"
    base = ["-m", "burn_ppo_tpu.parity", "run", "-c",
            "configs/skull_ctde_4096.toml", "--num-envs", "64",
            "--num-steps", "16"]
    _child([*base, "--out", str(ref)], dict(gpu_env, **chip_smoke.CPU_ENV))
    _child([*base, "--inputs", str(ref), "--out", str(dev)], gpu_env)
    report = parity.compare(str(ref), str(dev))
    assert report["ok"], report
