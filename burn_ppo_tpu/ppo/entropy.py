"""Adaptive entropy-coefficient controller.

Bang-bang control steering the policy entropy toward a scheduled target
expressed as a ratio of max entropy ln(A). Behavioral parity with the
reference (src/entropy.rs:14-105): coefficient moves by +/-delta in the
direction of (target - last_entropy), clamped to [min, max]; no
adjustment until the first entropy observation.

Two implementations with identical semantics (equivalence-tested in
tests/test_entropy.py):

- ``AdaptiveEntropyController`` — host-side Python, used by the unfused
  phase-profiling diagnostic path (one update per host call).
- ``AdaptiveEntropyState`` + ``adaptive_entropy_step/record`` — device
  pytree state updated INSIDE the fused train step, so adaptive-entropy
  runs keep the K-update device windows (the controller is three
  arithmetic ops; keeping it host-side forced per-update dispatch).
  Only the scheduled target crosses the host boundary, once per window.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from burn_ppo_tpu import struct

from burn_ppo_tpu.schedule import Schedule


class AdaptiveEntropyState(struct.PyTreeNode):
    """Device-resident controller state (entropy.rs:14-30 fields)."""

    coef: jax.Array  # f32 scalar, current coefficient
    last_entropy: jax.Array  # f32 scalar, most recent observed entropy
    has_entropy: jax.Array  # bool scalar; no adjustment until first obs

    @staticmethod
    def create(initial_coef: float) -> "AdaptiveEntropyState":
        return AdaptiveEntropyState(
            coef=jnp.asarray(initial_coef, jnp.float32),
            last_entropy=jnp.asarray(0.0, jnp.float32),
            has_entropy=jnp.asarray(False),
        )


def adaptive_entropy_step(
    state: AdaptiveEntropyState,
    target: jax.Array,
    min_coef: float,
    max_coef: float,
    delta: float,
) -> Tuple[jax.Array, AdaptiveEntropyState]:
    """Device analog of ``get_coefficient`` (entropy.rs:73-87).

    Returns (coefficient to use for this update, state with it stored).
    The reference's comment claims sign(0) = 0, but Rust's
    ``f64::signum(+0.0)`` is +1.0 — target - current yields +0.0 under
    IEEE round-to-nearest, so the actual behavior nudges the coefficient
    UP by delta when exactly on target. ``copysign`` reproduces signum
    exactly (including the unreachable -0.0 -> -1.0 case)."""
    error = target - state.last_entropy
    adjusted = jnp.clip(
        state.coef + delta * jnp.copysign(1.0, error), min_coef, max_coef
    )
    coef = jnp.where(state.has_entropy, adjusted, state.coef)
    return coef, state.replace(coef=coef)


def adaptive_entropy_record(
    state: AdaptiveEntropyState, entropy: jax.Array
) -> AdaptiveEntropyState:
    """Device analog of ``record_entropy`` (entropy.rs:62)."""
    return state.replace(
        last_entropy=jnp.asarray(entropy, jnp.float32),
        has_entropy=jnp.asarray(True),
    )


class AdaptiveEntropyController:
    def __init__(
        self,
        target_schedule: Schedule,
        num_actions: int,
        initial_coef: float,
        min_coef: float = 0.001,
        max_coef: float = 0.1,
        delta: float = 0.001,
    ):
        self.target_schedule = target_schedule
        self.min_coef = min_coef
        self.max_coef = max_coef
        self.delta = delta
        self.max_entropy = math.log(num_actions)
        self.current_coef = initial_coef
        self.last_entropy: Optional[float] = None

    def record_entropy(self, entropy: float) -> None:
        self.last_entropy = float(entropy)

    def target_entropy(self, step: int) -> float:
        return self.target_schedule.get(step) * self.max_entropy

    def get_coefficient(self, step: int) -> Tuple[float, float]:
        """(coefficient, target_entropy); adjusts by Rust signum(error).

        ``f64::signum(+0.0)`` is +1.0, so an exactly-on-target entropy
        still nudges the coefficient up by delta (entropy.rs:82; the
        reference's sign(0)=0 comment misstates its own stdlib)."""
        target = self.target_entropy(step)
        if self.last_entropy is not None:
            error = target - self.last_entropy
            sign = math.copysign(1.0, error)
            self.current_coef = min(
                self.max_coef, max(self.min_coef, self.current_coef + self.delta * sign)
            )
        return self.current_coef, target
