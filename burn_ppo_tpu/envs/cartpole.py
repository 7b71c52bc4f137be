"""CartPole-v1 as a pure JAX function.

Behavioral parity with the reference (src/envs/cartpole.rs): OpenAI Gym
physics with semi-implicit Euler integration (cartpole.rs:50-66), 5-dim
observation including normalized episode time (cartpole.rs:76-86), 500
step cap, and reward 1.0 per step except a failure-terminal step which
pays 0.0 (cartpole.rs:294-298).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from burn_ppo_tpu import struct

from burn_ppo_tpu.envs import register
from burn_ppo_tpu.envs.base import Environment, EnvSpec

GRAVITY = 9.8
CART_MASS = 1.0
POLE_MASS = 0.1
TOTAL_MASS = CART_MASS + POLE_MASS
POLE_HALF_LENGTH = 0.5
POLE_MASS_LENGTH = POLE_MASS * POLE_HALF_LENGTH
FORCE_MAG = 10.0
TAU = 0.02
X_THRESHOLD = 2.4
THETA_THRESHOLD = 12.0 * jnp.pi / 180.0
MAX_STEPS = 500


class CartPoleState(struct.PyTreeNode):
    x: jax.Array
    x_dot: jax.Array
    theta: jax.Array
    theta_dot: jax.Array
    step_idx: jax.Array  # i32
    rewards: jax.Array  # f32[1] reward emitted by the last step
    done: jax.Array  # bool
    # Unused after reset: autoreset_step always supplies a fresh key from
    # the rollout's PRNG chain (envs/base.py:263); kept only because the
    # Environment protocol reconstructs states tree-wise.
    key: jax.Array


class CartPole(Environment):
    spec = EnvSpec(
        name="cartpole",
        obs_dim=5,
        num_actions=2,
        num_players=1,
        max_episode_steps=MAX_STEPS,
    )

    def reset(self, key: jax.Array) -> CartPoleState:
        key, sub = jax.random.split(key)
        init = jax.random.uniform(sub, (4,), minval=-0.05, maxval=0.05)
        return CartPoleState(
            x=init[0],
            x_dot=init[1],
            theta=init[2],
            theta_dot=init[3],
            step_idx=jnp.zeros((), jnp.int32),
            rewards=jnp.zeros((1,), jnp.float32),
            done=jnp.zeros((), jnp.bool_),
            key=key,
        )

    def step(self, state: CartPoleState, action: jax.Array) -> CartPoleState:
        force = jnp.where(action == 0, -FORCE_MAG, FORCE_MAG)
        cos_t = jnp.cos(state.theta)
        sin_t = jnp.sin(state.theta)

        temp = (
            force + POLE_MASS_LENGTH * jnp.square(state.theta_dot) * sin_t
        ) / TOTAL_MASS
        theta_acc = (GRAVITY * sin_t - cos_t * temp) / (
            POLE_HALF_LENGTH * (4.0 / 3.0 - POLE_MASS * jnp.square(cos_t) / TOTAL_MASS)
        )
        x_acc = temp - POLE_MASS_LENGTH * theta_acc * cos_t / TOTAL_MASS

        x_dot = state.x_dot + TAU * x_acc
        x = state.x + TAU * x_dot
        theta_dot = state.theta_dot + TAU * theta_acc
        theta = state.theta + TAU * theta_dot
        steps = state.step_idx + 1

        failed = (jnp.abs(x) > X_THRESHOLD) | (jnp.abs(theta) > THETA_THRESHOLD)
        done = failed | (steps >= MAX_STEPS)
        # +1 per surviving step; a failure terminal pays 0 (timeout pays 1)
        reward = jnp.where(failed & (steps < MAX_STEPS), 0.0, 1.0)

        return state.replace(
            x=x,
            x_dot=x_dot,
            theta=theta,
            theta_dot=theta_dot,
            step_idx=steps,
            rewards=reward.reshape(1).astype(jnp.float32),
            done=done,
        )

    def obs(self, state: CartPoleState) -> jax.Array:
        return jnp.stack(
            [
                state.x,
                state.x_dot,
                state.theta,
                state.theta_dot,
                state.step_idx.astype(jnp.float32) / MAX_STEPS,
            ]
        )

    def describe_action(self, action: int) -> str:
        return "Push left" if action == 0 else "Push right"

    def parse_action(self, text: str) -> int:
        t = text.strip().lower()
        if t in ("left", "l", "0"):
            return 0
        if t in ("right", "r", "1"):
            return 1
        raise ValueError("Enter 'left' or 'right' (or 'l'/'r')")

    def render(self, state) -> str:
        # Minimal ASCII render for watch mode.
        width = 41
        pos = int((float(state.x) / X_THRESHOLD + 1.0) * (width - 1) / 2)
        pos = max(0, min(width - 1, pos))
        track = ["-"] * width
        track[pos] = "C"
        angle_deg = float(state.theta) * 180.0 / 3.141592653589793
        return (
            f"x={float(state.x):+.3f} theta={angle_deg:+.2f}deg "
            f"step={int(state.step_idx)}\n" + "".join(track)
        )


register("cartpole", CartPole)
