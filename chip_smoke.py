#!/usr/bin/env python3
"""Smoke test of the trainer on NVIDIA GPUs, through its user entry points.

    python chip_smoke.py          # one card (the default)
    python chip_smoke.py --four   # the data-parallel paths on four cards

One card: the flagship Skull-CTDE config (configs/skull_ctde_4096.toml:
4 players, CTDE actor and critic 256x3, 4096 envs x 64 steps, opponent
pool at 0.3 with K = 8 stacked opponents, 8-update fused windows) with
random weights from its seed, through

  device   JAX's default device must be a GPU; nvidia-smi names the card;
  train    ``python -m burn_ppo_tpu train`` for two windows: two
           checkpoints and one pool rotation with a non-empty pool;
  resume   ``train --resume`` for a third window;
  eval     ``python -m burn_ppo_tpu eval`` of the run against a random
           player;
  compare  the same rollout, GAE and PPO update on the CPU and on the
           GPU at the flagship widths (256 envs x 64 steps), compared by
           ``burn_ppo_tpu.parity``.

Four cards (``--four``), and nothing else: ``train --mesh-data 4`` against
``--mesh-data 1`` on one seed, then four processes of one card each
joined through jax.distributed; their pool-stats replicas must be
byte-identical and their metric tails must match the 4-card run.

This process never imports JAX: every phase is a child process, run one
after another, so each card is held by one process at a time. The last
line of stdout is one JSON object, printed only when every phase passed:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failure exits non-zero without it.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent
PLATFORM = "gpu"  # ``train --platform``: no fallback to another backend
CONFIG = "configs/skull_ctde_4096.toml"
WINDOW_STEPS = 4096 * 64 * 8  # one fused window of the flagship config
TRAIN_STEPS = 2 * WINDOW_STEPS
RESUME_STEPS = 3 * WINDOW_STEPS
EVAL_GAMES = 100
COMPARE_ENVS = 256
DEADLINE_S = 1150.0  # the whole run, compilation included

# Data-parallel config for --four: the flagship's env and widths, cut to
# two 2-update windows (256 envs x 16 steps x 4 updates) so that four
# processes finish inside the deadline.
FOUR_STEPS = 16384
FOUR_CONFIG = """\
env = "skull"
network_type = "ctde"
hidden_size = 256
num_hidden = 3
critic_hidden_size = 256
critic_num_hidden = 3
num_envs = 256
num_steps = 16
num_minibatches = 4
checkpoint_freq = 8192
log_freq = 8192
seed = 5
opponent_pool_fraction = 0.25
max_active_opponents = 2
pool_rotation_interval = 2

[player_count]
type = "Fixed"
count = 4
"""
# The CPU reference children: no card, and no persistent compile cache —
# XLA:CPU executables cached on one host can SIGILL on another, and
# $JAX_COMPILATION_CACHE_DIR may be shared between machines.
CPU_ENV = {"JAX_PLATFORMS": "cpu", "CUDA_VISIBLE_DEVICES": "",
           "JAX_ENABLE_COMPILATION_CACHE": "false"}
TAIL_KEYS = ("train/policy_loss", "train/value_loss", "train/entropy",
             "train/returns_mean", "episode/count")


class PhaseError(RuntimeError):
    pass


class Smoke:
    def __init__(self, workdir: Path, **extra_env):
        self.workdir = workdir
        self.extra_env = extra_env
        self.t0 = time.monotonic()

    def remaining(self) -> float:
        return DEADLINE_S - (time.monotonic() - self.t0)

    def log(self, msg: str) -> None:
        print(f"[smoke +{time.monotonic() - self.t0:.0f}s] {msg}",
              file=sys.stderr, flush=True)

    def env(self, **extra) -> dict:
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(CHECKOUT)] + [p for p in [env.get("PYTHONPATH")] if p])
        env.update(self.extra_env)
        env.update(extra)
        return env

    def child(self, name: str, args: list, cap_s: float, **env) -> str:
        """Run ``python args`` from the checkout; return its stdout."""
        timeout = min(cap_s, self.remaining())
        if timeout <= 0:
            raise PhaseError(f"{name}: no time left before the deadline")
        self.log(f"{name}: python {' '.join(args)}")
        out_path = self.workdir / f"{name}.out"
        log_path = self.workdir / f"{name}.log"
        with open(out_path, "w") as out, open(log_path, "w") as err:
            proc = subprocess.Popen(
                [sys.executable, *args], cwd=CHECKOUT, env=self.env(**env),
                stdout=out, stderr=err, start_new_session=True)
            try:
                proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                _kill(proc)
                raise PhaseError(f"{name}: timed out after {timeout:.0f}s\n"
                                 + _tail(out_path) + _tail(log_path))
        if proc.returncode != 0:
            raise PhaseError(f"{name}: exit {proc.returncode}\n"
                             + _tail(out_path) + _tail(log_path))
        return out_path.read_text()


def _kill(proc: subprocess.Popen) -> None:
    """Kill a child started with start_new_session and all it spawned."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def _tail(path: Path, n: int = 3000) -> str:
    """The error lines of a child's log (a crash's stack trace would
    push them out of the tail), then its last n characters."""
    try:
        text = path.read_text(errors="replace")
    except OSError:
        return ""
    errors = [ln for ln in text.splitlines()
              if "Check failed" in ln or "Error" in ln][:20]
    return "\n".join(errors + [text[-n:]])


def _last_json(stdout: str) -> dict:
    for line in reversed(stdout.strip().splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    raise PhaseError(f"no JSON line in child output: {stdout[-500:]}")


def nvidia_smi() -> list:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise PhaseError(f"nvidia-smi failed: {e}")
    if out.returncode != 0:
        raise PhaseError(f"nvidia-smi failed: {out.stderr.strip()}")
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def phase_device(s: Smoke, count: int) -> dict:
    if not (CHECKOUT / "burn_ppo_tpu" / "__init__.py").exists():
        raise PhaseError(f"no burn_ppo_tpu package next to {__file__}")
    info = _last_json(
        s.child("device", ["-m", "burn_ppo_tpu.parity", "device"], 180))
    if info.get("platform") != PLATFORM:
        raise PhaseError(
            f"device: JAX's default platform is {info}, not {PLATFORM}")
    if info["count"] < count:
        raise PhaseError(f"device: {info['count']} GPUs, {count} needed")
    info["nvidia_smi"] = nvidia_smi()
    s.log(f"device: {info}")
    return info


def read_scalars(run_dir: Path) -> list:
    """Every scalar record of a run's metrics.jsonl, checked for health."""
    records = []
    with open(run_dir / "metrics.jsonl") as f:
        for line in f:
            obj = json.loads(line)
            if obj.get("type") == "scalar":
                records.append(obj)
    if not records:
        raise PhaseError(f"{run_dir}: no scalar metrics")
    bad = [r for r in records
           if not math.isfinite(r["value"])
           or (r["name"] in ("train/invalid_mask_count",
                             "train/nonfinite_count") and r["value"] != 0)]
    if bad:
        raise PhaseError(f"{run_dir}: unhealthy metrics {bad[:5]}")
    guards = {r["name"] for r in records} & {
        "train/invalid_mask_count", "train/nonfinite_count"}
    if len(guards) != 2:
        raise PhaseError(f"{run_dir}: runtime-guard counters missing")
    return records


def checkpoint_step(run_dir: Path) -> int:
    meta = run_dir / "checkpoints" / "latest" / "metadata.json"
    if not meta.exists():
        raise PhaseError(f"{run_dir}: no checkpoints/latest")
    return int(json.loads(meta.read_text())["step"])


def train(s: Smoke, name: str, args: list, run_dir: Path, steps: int,
          cap_s: float) -> list:
    s.child(name, ["-m", "burn_ppo_tpu", "train", "--platform", PLATFORM,
                   *args, "--total-steps", str(steps)], cap_s)
    step = checkpoint_step(run_dir)
    if step < steps:
        raise PhaseError(f"{name}: checkpoints/latest at {step} < {steps}")
    records = read_scalars(run_dir)
    s.log(f"{name}: checkpoint step {step}, {len(records)} scalars")
    return records


def metrics_tail(records: list) -> dict:
    return {r["name"]: r["value"] for r in records}


def assert_tails_match(tag: str, a: dict, b: dict) -> None:
    checked = 0
    for k in TAIL_KEYS:
        if k in a and k in b:
            if not abs(a[k] - b[k]) <= 1e-4 + 2e-4 * abs(b[k]):
                raise PhaseError(f"{tag}: {k} {a[k]} vs {b[k]}")
            checked += 1
    if checked < 3:
        raise PhaseError(f"{tag}: only {checked} comparable tail metrics")


def one_card(s: Smoke) -> dict:
    info = phase_device(s, 1)
    run = s.workdir / "run"
    recs = train(s, "train", ["-c", CONFIG, "--run-dir", str(run)], run,
                 TRAIN_STEPS, 600)
    sps = [r["value"] for r in recs if r["name"] == "perf/sps"]
    train(s, "resume", ["--resume", str(run)], run, RESUME_STEPS, 400)

    out = s.child("eval", ["-m", "burn_ppo_tpu", "eval", "-c", str(run),
                           "--random", "-n", str(EVAL_GAMES),
                           "--players", "4"], 300)
    if "random" not in out.lower():
        raise PhaseError(f"eval: no rating table in output:\n{out[-2000:]}")

    ref, dev = s.workdir / "cpu.npz", s.workdir / "gpu.npz"
    par = ["-m", "burn_ppo_tpu.parity", "run", "-c", CONFIG,
           "--num-envs", str(COMPARE_ENVS)]
    s.child("compare-cpu", [*par, "--out", str(ref)], 400, **CPU_ENV)
    s.child("compare-gpu", [*par, "--inputs", str(ref), "--out", str(dev)],
            300)
    report = _last_json(s.child(
        "compare", ["-m", "burn_ppo_tpu.parity", "compare", str(ref),
                    str(dev)], 120, **CPU_ENV))
    s.log(f"compare: {json.dumps(report)}")
    print("compare, GPU vs CPU: |d|/(1+|ref|) under highest precision, "
          "its bar, and the default-precision drift (information only)")
    for k, d in report["highest"]["by_key"].items():
        drift = report["default_precision"]["by_key"].get(k, float("nan"))
        print(f"  {k:26s} {d:.3e}  bar {report['bars'][k]:.0e}  "
              f"default {drift:.3e}")
    print(f"identical sampled actions {report['same_actions']} (bar "
          f"{report['min_same_actions']}); default precision over its bar "
          f"on {report['default_precision']['over_bar']}")
    for card in info["nvidia_smi"]:
        print(f"smoke reading, not a benchmark: train windows at "
              f"{[round(v) for v in sps]} env-steps/s on {card}")
    return info


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def four_processes(s: Smoke, cfg: Path, run_dir: Path) -> list:
    """Four trainer processes, one card each, into one run dir."""
    port = _free_port()
    procs, logs = [], []
    deadline = time.monotonic() + min(450.0, s.remaining())
    try:
        for pid in range(4):
            log_path = s.workdir / f"4proc_{pid}.log"
            logs.append(log_path)
            env = s.env(CUDA_VISIBLE_DEVICES=str(pid),
                        BURN_PPO_COORDINATOR=f"localhost:{port}",
                        BURN_PPO_NUM_PROCESSES="4",
                        BURN_PPO_PROCESS_ID=str(pid),
                        BURN_PPO_DUMP_POOL_STATS="1")
            with open(log_path, "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "burn_ppo_tpu", "train", "-c",
                     str(cfg), "--run-dir", str(run_dir), "--platform",
                     PLATFORM, "--multihost", "--total-steps",
                     str(FOUR_STEPS)],
                    cwd=CHECKOUT, env=env, stdout=log,
                    stderr=subprocess.STDOUT, start_new_session=True))
        s.log("4proc: launched 4 processes")
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        raise PhaseError("4proc: timed out\n" + _tail(logs[0]))
    finally:
        for p in procs:
            if p.poll() is None:
                _kill(p)
    failed = [i for i, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise PhaseError(f"4proc: processes {failed} failed\n"
                         + _tail(logs[failed[0]]))
    step = checkpoint_step(run_dir)
    if step < FOUR_STEPS:
        raise PhaseError(f"4proc: checkpoints/latest at {step}")
    dumps = [(run_dir / f"pool_stats_proc{i}.json").read_text()
             for i in range(4)]
    if any(d != dumps[0] for d in dumps):
        raise PhaseError("4proc: pool-stats replicas differ between processes")
    return read_scalars(run_dir)


def four_cards(s: Smoke) -> dict:
    info = phase_device(s, 4)
    cfg = s.workdir / "four.toml"
    cfg.write_text(FOUR_CONFIG)
    tails = {}
    for n in (4, 1):
        run = s.workdir / f"mesh{n}"
        recs = train(s, f"mesh{n}", ["-c", str(cfg), "--run-dir", str(run),
                                     "--mesh-data", str(n)],
                     run, FOUR_STEPS, 450)
        tails[n] = metrics_tail(recs)
    assert_tails_match("mesh-data 4 vs 1", tails[4], tails[1])
    tail_4p = metrics_tail(four_processes(s, cfg, s.workdir / "procs4"))
    assert_tails_match("4 processes vs mesh-data 4", tail_4p, tails[4])
    print("four cards: mesh-data 4 matches mesh-data 1; 4 processes x 1 "
          "card: pool-stats replicas identical, tails match mesh-data 4")
    return info


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the four-card data-parallel phase")
    args = parser.parse_args(argv)
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        if args.four:
            info = four_cards(Smoke(workdir))
        else:
            info = one_card(Smoke(workdir))
    except PhaseError as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for card in info["nvidia_smi"]:
        print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
