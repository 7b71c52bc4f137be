"""burn_ppo_tpu — a PPO self-play framework on JAX.

A from-scratch JAX/XLA re-design of the capabilities of the `burn-ppo`
reference (single-process Rust/Burn PPO with self-play, opponent pools,
Plackett-Luce ratings, tournaments and evaluation tooling).

Design pillars (accelerator-first, not a port):
  * Environments are pure functions stepped under `vmap` *inside* `jit`
    on-device — there is no CPU env worker pool and no host<->device
    obs/action round trip per step (the reference crosses twice per step,
    src/main.rs "Device boundary" note).
  * Rollout collection is a `lax.scan`; GAE (single- and multi-player) is a
    reverse `lax.scan`; the PPO update is a scanned minibatch loop around
    `jax.value_and_grad`. One `jit`-compiled `train_step` does an entire
    update iteration.
  * Multi-chip scale-out (absent in the reference) uses a
    `jax.sharding.Mesh` with a `data` axis: env states and rollouts are
    sharded, parameters replicated, gradients reduced by GSPMD all-reduces.
"""

__version__ = "0.1.0"
