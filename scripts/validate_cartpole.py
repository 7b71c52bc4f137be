"""Validation run: solve CartPole (>195 avg return within 200k steps).

Mirrors the reference's validation bar (docs/DESIGN.md:191) and its
configs/cartpole.toml settings: 32 envs x 128 steps, lr 1e-3,
normalize_obs, hidden 64x2.

Usage: python scripts/validate_cartpole.py [total_steps] [--gpu]
(CPU by default: at 32 envs the learning bar is host-bound anyway.)
"""

import sys
import os

import jax

jax.config.update("jax_platforms", "cuda" if "--gpu" in sys.argv else "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import tempfile
import time

from burn_ppo_tpu.config import Config
from burn_ppo_tpu.schedule import Schedule
from burn_ppo_tpu.train import Trainer


def main():
    total = int(sys.argv[1]) if len(sys.argv) > 1 and sys.argv[1].isdigit() else 200_000
    cfg = Config(
        env="cartpole",
        num_envs=32,
        num_steps=128,
        total_steps=total,
        learning_rate=Schedule.constant(1e-3),
        normalize_obs=True,
        hidden_size=64,
        num_hidden=2,
        activation="tanh",
        entropy_coef=Schedule.constant(0.01),
        checkpoint_freq=100_000,
        log_freq=8_192,
        seed=1,
        opponent_pool_fraction=0.0,
    )
    with tempfile.TemporaryDirectory() as d:
        t0 = time.time()
        trainer = Trainer(cfg, d + "/run", quiet=False)
        summary = trainer.train()
        dt = time.time() - t0
        print(
            f"\nFinal: step={summary['final_step']} avg_return={summary['avg_return']:.1f} "
            f"sps={summary['sps']:.0f} wall={dt:.0f}s"
        )
        if summary["avg_return"] >= 195.0:
            print("PASS: CartPole solved (>195)")
            return 0
        print("FAIL: avg return below 195")
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
