"""Differential rules oracle for the bluffing games.

Replays thousands of random games through an independently-written
plain-Python rules engine (tests/oracles/, written from the reference's
semantics: /root/reference/src/envs/skull.rs:1103-1252,
liars_dice.rs:481-551) and the JAX envs in lockstep, diffing
phase / current player / action mask / rewards / done / placements on
EVERY step and the full observation + privileged observation vectors on
sampled steps. Nondeterminism is injected so both engines see the same
world: the Skull discard choice goes through forced_discard, Liar's
Dice rolls are read from the JAX env and handed to the oracle.

Connect Four is covered too (connect_four.rs:249-310; deterministic, no
injection needed) — its obs compares through the oracle's channels-last
view of the reference layout, the repo's one documented obs deviation.

Game count: ORACLE_GAMES env var (total across configs) — default 10240
(~8k Skull over 4 player counts + 2k Liar's Dice + 2k Connect Four).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from burn_ppo_tpu.envs.liars_dice import LiarsDice
from burn_ppo_tpu.envs.skull import Skull
from tests.oracles.liars_dice_oracle import LiarsDiceOracle
from tests.oracles.skull_oracle import SkullOracle

TOTAL_GAMES = int(os.environ.get("ORACLE_GAMES", "10240"))
SKULL_GAMES = TOTAL_GAMES // 5  # per player-count config (2, 3, 4, 6)
LD_GAMES = TOTAL_GAMES // 5
OBS_SAMPLE = 8  # full obs/priv diff every Nth step per game
BATCH = 256
SHAPING = 0.05  # nonzero to exercise round-reward shaping in both

PHASE_ID = {"placing": 0, "bidding": 1, "revealing": 2}


def _jitted(env):
    return (
        jax.jit(jax.vmap(env.step)),
        jax.jit(jax.vmap(env.obs)),
        jax.jit(jax.vmap(env.action_mask)),
        jax.jit(jax.vmap(env.privileged_obs)),
        jax.jit(jax.vmap(env.game_outcome)),
    )


def _reset_batch(env, base_seed, B):
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(B) + base_seed)
    state = jax.vmap(env.reset)(keys)
    return state.replace(
        shaping_coef=jnp.full((B,), SHAPING, jnp.float32)
    )


def _diff(g, step, what, a, b):
    np.testing.assert_allclose(
        np.asarray(a, np.float64),
        np.asarray(b, np.float64),
        atol=1e-5,
        err_msg=f"game {g} step {step}: {what} diverged",
    )


def run_skull_config(num_players, n_games, seed):
    env = Skull(num_players)
    step_j, obs_j, mask_j, priv_j, outcome_j = _jitted(env)
    rng = np.random.default_rng(seed)
    finished = 0
    for batch_start in range(0, n_games, BATCH):
        B = min(BATCH, n_games - batch_start)
        state = _reset_batch(env, seed * 100_003 + batch_start, B)
        oracles = [SkullOracle(num_players, SHAPING) for _ in range(B)]
        active = np.ones(B, bool)
        step = 0
        while active.any():
            step += 1
            assert step < 4000, "skull game did not terminate"
            mask = np.asarray(mask_j(state))
            phase = np.asarray(state.phase)
            current = np.asarray(state.current)
            obs = priv = None
            if step % OBS_SAMPLE == 1:
                obs = np.asarray(obs_j(state))
                priv = np.asarray(priv_j(state))
            actions = np.zeros(B, np.int32)
            discards = np.full(B, -1, np.int32)
            dchoice = [None] * B
            for g in np.nonzero(active)[0]:
                o = oracles[g]
                assert phase[g] == PHASE_ID[o.phase], (g, step, o.phase)
                assert current[g] == o.current, (g, step)
                om = np.asarray(o.action_mask())
                assert (mask[g] == om).all(), (
                    f"game {g} step {step}: mask diverged "
                    f"jax={np.nonzero(mask[g])[0]} oracle={np.nonzero(om)[0]}"
                )
                if obs is not None:
                    _diff(g, step, "obs", obs[g], o.observation())
                    _diff(g, step, "priv_obs", priv[g], o.privileged_obs())
                actions[g] = rng.choice(np.nonzero(om)[0])
                if o.phase == "revealing":
                    b = o.current_bidder
                    legal = []
                    if o.has_trap[b]:
                        legal.append("skull")
                    if o.rose_count[b] > 0:
                        legal.append("rose")
                    dchoice[g] = legal[int(rng.integers(len(legal)))]
                    discards[g] = 0 if dchoice[g] == "skull" else 1
            state = state.replace(forced_discard=jnp.asarray(discards))
            state = step_j(state, jnp.asarray(actions))
            rewards = np.asarray(state.rewards)
            done = np.asarray(state.done)
            outcomes = None
            for g in np.nonzero(active)[0]:
                orw, odone = oracles[g].step(int(actions[g]), dchoice[g])
                _diff(g, step, "rewards", rewards[g], orw)
                assert bool(done[g]) == odone, (g, step)
                if odone:
                    if outcomes is None:
                        outcomes = np.asarray(outcome_j(state))
                    assert (
                        outcomes[g] == np.asarray(oracles[g].placements())
                    ).all(), f"game {g}: placements diverged"
                    active[g] = False
                    finished += 1
    return finished


def run_liars_dice(n_games, seed):
    env = LiarsDice()
    step_j, obs_j, mask_j, priv_j, outcome_j = _jitted(env)
    rng = np.random.default_rng(seed)
    finished = 0
    for batch_start in range(0, n_games, BATCH):
        B = min(BATCH, n_games - batch_start)
        state = _reset_batch(env, seed * 100_003 + batch_start, B)
        dice0 = np.asarray(state.dice)
        oracles = [LiarsDiceOracle(dice0[g], SHAPING) for g in range(B)]
        active = np.ones(B, bool)
        step = 0
        while active.any():
            step += 1
            assert step < 2000, "liars dice game did not terminate"
            mask = np.asarray(mask_j(state))
            current = np.asarray(state.current)
            obs = priv = None
            if step % OBS_SAMPLE == 1:
                obs = np.asarray(obs_j(state))
                priv = np.asarray(priv_j(state))
            actions = np.zeros(B, np.int32)
            for g in np.nonzero(active)[0]:
                o = oracles[g]
                assert current[g] == o.current, (g, step)
                om = np.asarray(o.action_mask())
                assert (mask[g] == om).all(), (
                    f"game {g} step {step}: mask diverged "
                    f"jax={np.nonzero(mask[g])[0]} oracle={np.nonzero(om)[0]}"
                )
                if obs is not None:
                    _diff(g, step, "obs", obs[g], o.observation())
                    _diff(g, step, "priv_obs", priv[g], o.privileged_obs())
                actions[g] = rng.choice(np.nonzero(om)[0])
            state = step_j(state, jnp.asarray(actions))
            rewards = np.asarray(state.rewards)
            done = np.asarray(state.done)
            new_dice = np.asarray(state.dice)
            outcomes = None
            for g in np.nonzero(active)[0]:
                orw, odone = oracles[g].step(
                    int(actions[g]), next_dice=new_dice[g]
                )
                _diff(g, step, "rewards", rewards[g], orw)
                assert bool(done[g]) == odone, (g, step)
                if odone:
                    if outcomes is None:
                        outcomes = np.asarray(outcome_j(state))
                    assert (
                        outcomes[g] == np.asarray(oracles[g].placements())
                    ).all(), f"game {g}: placements diverged"
                    active[g] = False
                    finished += 1
    return finished


def run_connect_four(n_games, seed):
    from burn_ppo_tpu.envs.connect_four import ConnectFour
    from tests.oracles.connect_four_oracle import ConnectFourOracle

    env = ConnectFour()
    step_j, obs_j, mask_j, _, outcome_j = (
        jax.jit(jax.vmap(env.step)),
        jax.jit(jax.vmap(env.obs)),
        jax.jit(jax.vmap(env.action_mask)),
        None,
        jax.jit(jax.vmap(env.game_outcome)),
    )
    rng = np.random.default_rng(seed)
    finished = 0
    for batch_start in range(0, n_games, BATCH):
        B = min(BATCH, n_games - batch_start)
        keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(B) + seed)
        state = jax.vmap(env.reset)(keys)
        oracles = [ConnectFourOracle() for _ in range(B)]
        active = np.ones(B, bool)
        step = 0
        while active.any():
            step += 1
            assert step <= 43, "connect four game too long"
            mask = np.asarray(mask_j(state))
            current = np.asarray(state.current)
            obs = np.asarray(obs_j(state)) if step % 2 == 1 else None
            actions = np.zeros(B, np.int32)
            for g in np.nonzero(active)[0]:
                o = oracles[g]
                assert current[g] == o.current, (g, step)
                om = np.asarray(o.action_mask())
                assert (mask[g] == om).all(), (g, step)
                if obs is not None:
                    # The repo stores the board channels-last (documented
                    # deviation, docs/DESIGN.md) — the oracle provides the
                    # permuted view of its reference-layout obs.
                    _diff(g, step, "obs", obs[g], o.observation_channels_last())
                actions[g] = rng.choice(np.nonzero(om)[0])
            state = step_j(state, jnp.asarray(actions))
            rewards = np.asarray(state.rewards)
            done = np.asarray(state.done)
            outcomes = None
            for g in np.nonzero(active)[0]:
                orw, odone = oracles[g].step(int(actions[g]))
                _diff(g, step, "rewards", rewards[g], orw)
                assert bool(done[g]) == odone, (g, step)
                if odone:
                    if outcomes is None:
                        outcomes = np.asarray(outcome_j(state))
                    assert (
                        outcomes[g] == np.asarray(oracles[g].placements())
                    ).all(), f"game {g}: placements diverged"
                    active[g] = False
                    finished += 1
    return finished


def test_connect_four_matches_oracle():
    finished = run_connect_four(LD_GAMES, seed=17)
    assert finished == LD_GAMES


@pytest.mark.parametrize("num_players", [2, 3, 4, 6])
def test_skull_matches_oracle(num_players):
    finished = run_skull_config(num_players, SKULL_GAMES, seed=num_players)
    assert finished == SKULL_GAMES


def test_liars_dice_matches_oracle():
    finished = run_liars_dice(LD_GAMES, seed=11)
    assert finished == LD_GAMES
