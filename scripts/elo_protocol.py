"""Standardized per-env Elo validation protocol.

Round-over-round learning-quality tracking: each multiplayer env trains
for a FIXED wall budget (default 8m) with a FIXED per-env seed on the
same config shapes as the round-2 hardware runs (runs/*_hw_r2), so the
during-training Plackett-Luce Elo (anchor 1000 at the first checkpoint,
rating_history.rs semantics) is comparable across rounds. Throughput
improvements are allowed to show up as more env steps inside the budget
— the protocol measures end-to-end learning per wall-clock, which is
what the framework optimizes.

Usage (repo root, on the GPU):
    python scripts/elo_protocol.py [--budget 8m] [--tag r3] [env ...]

Writes runs/{env}_hw_{tag} and prints one summary row per env.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

# Per-env standard settings == runs/*_hw_r2/config.toml (fixed seeds),
# plus the round-3 production pool cadence (pool_rotation_interval 8).
PROTOCOL = {
    "skull": [
        "--env", "skull", "--players", "4", "--network-type", "ctde",
        "--num-envs", "2048", "--num-steps", "64",
        "--hidden-size", "512", "--num-hidden", "2",
        "--critic-hidden-size", "512", "--critic-num-hidden", "2",
        "--activation", "tanh",
        "--learning-rate", "0.0003", "--gamma", "0.995",
        "--gae-lambda", "0.95", "--clip-epsilon", "0.2",
        "--entropy-coef", "0.02",
        "--total-steps", "1000000000",
        "--num-epochs", "4", "--num-minibatches", "4",
        "--checkpoint-freq", "2000000", "--log-freq", "500000",
        "--opponent-pool-fraction", "0.25", "--max-active-opponents", "4",
        "--pool-rotation-interval", "8",
        "--seed", "11",
    ],
    "liars_dice": [
        "--env", "liars_dice", "--players", "4", "--network-type", "ctde",
        "--num-envs", "2048", "--num-steps", "64",
        "--hidden-size", "256", "--num-hidden", "2",
        "--critic-hidden-size", "256", "--critic-num-hidden", "2",
        "--activation", "tanh",
        "--learning-rate", "0.0003", "--gamma", "0.995",
        "--gae-lambda", "0.95", "--clip-epsilon", "0.2",
        "--entropy-coef", "0.02",
        "--total-steps", "1000000000",
        "--num-epochs", "4", "--num-minibatches", "4",
        "--checkpoint-freq", "2000000", "--log-freq", "500000",
        "--opponent-pool-fraction", "0.25", "--max-active-opponents", "4",
        "--pool-rotation-interval", "8",
        "--seed", "3",
    ],
    "connect_four": [
        "--env", "connect_four",
        "--num-envs", "4096", "--num-steps", "64",
        "--hidden-size", "512", "--num-hidden", "2",
        "--activation", "tanh",
        "--learning-rate", "0.001", "--gamma", "0.99",
        "--gae-lambda", "0.95", "--clip-epsilon", "0.1",
        "--entropy-coef", "0.05", "--target-kl", "0.02",
        "--total-steps", "1000000000",
        "--num-epochs", "4", "--num-minibatches", "4",
        "--checkpoint-freq", "4000000", "--log-freq", "1000000",
        "--opponent-pool-fraction", "0.25", "--max-active-opponents", "4",
        "--pool-rotation-interval", "8",
        "--seed", "8",
    ],
}


def last_metrics(run_dir: Path) -> dict:
    want = {
        "train/current_elo", "train/best_elo", "train/explained_variance",
        "train/approx_kl", "perf/sps", "train/rating_games",
    }
    out: dict = {}
    step = 0
    with open(run_dir / "metrics.jsonl") as f:
        for line in f:
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue
            if row.get("type") == "scalar" and row.get("name") in want:
                out[row["name"]] = row["value"]
                step = max(step, int(row.get("step", 0)))
    out["final_step"] = step
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("envs", nargs="*", default=None)
    ap.add_argument("--budget", default="8m")
    ap.add_argument("--tag", default="r3")
    args = ap.parse_args()
    envs = args.envs or list(PROTOCOL)

    rows = []
    for env in envs:
        run_name = f"{env}_hw_{args.tag}"
        run_dir = REPO / "runs" / run_name
        cmd = [
            sys.executable, "-m", "burn_ppo_tpu", "train",
            *PROTOCOL[env],
            "--max-training-time", args.budget,
            "--run-name", run_name,
            # Cold compiles every round: a warm persistent cache would
            # inflate learning-per-wall-clock vs earlier rounds.
            "--compilation-cache", "off",
        ]
        print(f"== {env}: {args.budget} budget -> runs/{run_name}", flush=True)
        rc = subprocess.run(cmd, cwd=REPO).returncode
        if rc != 0:
            print(f"{env}: FAILED rc={rc}")
            return rc
        m = last_metrics(run_dir)
        rows.append((env, m))
        print(
            f"{env}: steps={m['final_step']:,} "
            f"elo={m.get('train/current_elo', 0):.0f} "
            f"best={m.get('train/best_elo', 0):.0f} "
            f"ev={m.get('train/explained_variance', 0):.2f} "
            f"kl={m.get('train/approx_kl', 0):.4f} "
            f"games={int(m.get('train/rating_games', 0))}",
            flush=True,
        )

    print("\n| Env | Budget | Env steps | Elo (current) | Elo (best) | ev | approx_kl |")
    print("|---|---|---|---|---|---|---|")
    for env, m in rows:
        print(
            f"| {env} | {args.budget} | {m['final_step'] / 1e6:.1f}M "
            f"| {m.get('train/current_elo', 0):.0f} "
            f"| {m.get('train/best_elo', 0):.0f} "
            f"| {m.get('train/explained_variance', 0):.2f} "
            f"| {m.get('train/approx_kl', 0):.4f} |"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
