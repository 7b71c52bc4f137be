"""Runtime-guard tests: a deliberately broken env must surface within one
update instead of silently training (reference panics on empty action
masks, src/utils.rs:115-135, and asserts finite outputs,
src/ppo.rs:363-366)."""

import jax
import jax.numpy as jnp
import pytest
from burn_ppo_tpu import struct

from burn_ppo_tpu.config import Config
from burn_ppo_tpu.envs import register
from burn_ppo_tpu.envs.base import Environment, EnvSpec
from burn_ppo_tpu.schedule import Schedule
from burn_ppo_tpu.train import Trainer


class _BrokenState(struct.PyTreeNode):
    count: jax.Array
    rewards: jax.Array
    done: jax.Array
    key: jax.Array


class _EmptyMaskEnv(Environment):
    """Action mask goes all-zero after 2 steps — an env bug."""

    spec = EnvSpec(name="broken_mask", obs_dim=2, num_actions=3, num_players=1)

    def reset(self, key):
        return _BrokenState(
            count=jnp.zeros((), jnp.int32),
            rewards=jnp.zeros((1,), jnp.float32),
            done=jnp.zeros((), jnp.bool_),
            key=key,
        )

    def step(self, state, action):
        count = state.count + 1
        return state.replace(
            count=count,
            rewards=jnp.ones((1,), jnp.float32),
            done=count >= 6,
        )

    def obs(self, state):
        return jnp.stack(
            [state.count.astype(jnp.float32), jnp.ones(())]
        )

    def action_mask(self, state):
        return jnp.where(
            state.count >= 2,
            jnp.zeros((3,), jnp.bool_),
            jnp.ones((3,), jnp.bool_),
        )


class _NaNObsEnv(_EmptyMaskEnv):
    """Observations turn NaN after 2 steps — poisons the forward pass."""

    spec = EnvSpec(name="nan_obs", obs_dim=2, num_actions=3, num_players=1)

    def obs(self, state):
        bad = jnp.where(state.count >= 2, jnp.nan, 1.0)
        return jnp.stack([state.count.astype(jnp.float32), bad])

    def action_mask(self, state):
        return jnp.ones((3,), jnp.bool_)


register("broken_mask", lambda: _EmptyMaskEnv())
register("nan_obs", lambda: _NaNObsEnv())


def guard_config(env_name: str, **kw) -> Config:
    base = dict(
        env=env_name,
        num_envs=2,
        num_steps=8,
        total_steps=64,
        hidden_size=8,
        num_hidden=1,
        learning_rate=Schedule.constant(1e-3),
        checkpoint_freq=64,
        log_freq=16,
        seed=0,
        opponent_pool_fraction=0.0,
    )
    base.update(kw)
    return Config(**base)


def test_empty_mask_raises_within_one_update(tmp_path):
    trainer = Trainer(guard_config("broken_mask"), tmp_path / "run", quiet=True)
    with pytest.raises(RuntimeError, match="EMPTY action mask"):
        trainer.train()


def test_empty_mask_warn_mode_continues(tmp_path, capsys):
    cfg = guard_config("broken_mask", runtime_guards="warn")
    trainer = Trainer(cfg, tmp_path / "run", quiet=True)
    summary = trainer.train()
    assert summary["final_step"] >= cfg.total_steps
    assert "EMPTY action mask" in capsys.readouterr().err


def test_nan_obs_raises(tmp_path):
    trainer = Trainer(guard_config("nan_obs"), tmp_path / "run", quiet=True)
    with pytest.raises(RuntimeError, match="non-finite"):
        trainer.train()


def test_guards_off_trains_silently(tmp_path, capsys):
    cfg = guard_config("broken_mask", runtime_guards="off")
    trainer = Trainer(cfg, tmp_path / "run", quiet=True)
    summary = trainer.train()
    assert summary["final_step"] >= cfg.total_steps
    assert "EMPTY action mask" not in capsys.readouterr().err


def test_healthy_env_guard_metrics_zero(tmp_path):
    cfg = guard_config("cartpole")
    trainer = Trainer(cfg, tmp_path / "run", quiet=True)
    summary = trainer.train()  # must not raise
    assert summary["train/nonfinite_count"] == 0.0


def test_checkify_mode_runs_clean(tmp_path):
    cfg = guard_config("cartpole")
    trainer = Trainer(cfg, tmp_path / "run", quiet=True, debug_checkify=True)
    assert not trainer.use_windows
    summary = trainer.train()
    assert summary["final_step"] >= cfg.total_steps


def test_checkify_mode_throws_on_nan(tmp_path):
    from jax.experimental.checkify import JaxRuntimeError

    cfg = guard_config("nan_obs", runtime_guards="off")
    trainer = Trainer(cfg, tmp_path / "run", quiet=True, debug_checkify=True)
    with pytest.raises((JaxRuntimeError, RuntimeError)):
        trainer.train()


def test_checkify_covers_pool_path(tmp_path):
    """--checkify must wrap the opponent-pool window too: once the first
    checkpoint joins the pool, the rotation branch IS the run, and a
    plain-jit pool window would leave the whole run unchecked."""
    cfg = guard_config(
        "connect_four",
        num_envs=4,
        total_steps=256,
        checkpoint_freq=64,
        log_freq=64,
        opponent_pool_fraction=0.5,
    )
    trainer = Trainer(cfg, tmp_path / "run", quiet=True, debug_checkify=True)
    summary = trainer.train()
    assert summary["final_step"] >= cfg.total_steps
    # The pool path actually ran, and through a checkified window.
    assert trainer._pool_windows, "pool window never built — path not exercised"
