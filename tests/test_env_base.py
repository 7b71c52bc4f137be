"""Environment abstraction tests with a synthetic CounterEnv — the
reference tests VecEnv auto-reset with exactly this pattern
(src/env.rs:495-518 CounterEnv<MAX_STEPS>)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from burn_ppo_tpu import struct

from burn_ppo_tpu.envs.base import (
    Environment,
    EnvSpec,
    EpisodeAccumulator,
    autoreset_step,
    tree_select,
)


class CounterState(struct.PyTreeNode):
    count: jax.Array
    rewards: jax.Array
    done: jax.Array
    step_idx: jax.Array
    shaping_coef: jax.Array
    key: jax.Array


class CounterEnv(Environment):
    """Terminates after MAX steps; reward = action value each step."""

    MAX = 3
    spec = EnvSpec(name="counter", obs_dim=1, num_actions=2, num_players=1)
    context_fields = ("shaping_coef",)

    def reset(self, key):
        return CounterState(
            count=jnp.zeros((), jnp.int32),
            rewards=jnp.zeros((1,), jnp.float32),
            done=jnp.zeros((), jnp.bool_),
            step_idx=jnp.zeros((), jnp.int32),
            shaping_coef=jnp.zeros((), jnp.float32),
            key=key,
        )

    def step(self, state, action):
        count = state.count + 1
        return state.replace(
            count=count,
            rewards=jnp.asarray([action], jnp.float32),
            done=count >= self.MAX,
            step_idx=state.step_idx + 1,
        )

    def obs(self, state):
        return state.count.astype(jnp.float32)[None]


@pytest.fixture()
def env():
    return CounterEnv()


def roll(env, state, acc, actions, key=0):
    keys = jax.random.split(jax.random.PRNGKey(key), len(actions))
    logs = []
    terms = []
    for a, k in zip(actions, keys):
        state, acc, term, log = autoreset_step(env, state, acc, jnp.asarray(a), k)
        logs.append(log)
        terms.append(term)
    return state, acc, terms, logs


def test_episode_completes_at_max(env):
    s = env.reset(jax.random.PRNGKey(0))
    acc = EpisodeAccumulator.zero(1)
    s, acc, terms, logs = roll(env, s, acc, [1, 1, 1])
    assert not bool(logs[0].completed)
    assert not bool(logs[1].completed)
    assert bool(logs[2].completed)
    assert float(logs[2].total_rewards[0]) == 3.0
    assert int(logs[2].length) == 3


def test_autoreset_restarts_counters(env):
    s = env.reset(jax.random.PRNGKey(0))
    acc = EpisodeAccumulator.zero(1)
    s, acc, _t, _l = roll(env, s, acc, [1, 1, 1])
    # after the completing step, state is freshly reset
    assert int(s.count) == 0
    assert float(acc.reward_sum[0]) == 0.0
    assert int(acc.length) == 0


def test_second_episode_isolated(env):
    s = env.reset(jax.random.PRNGKey(0))
    acc = EpisodeAccumulator.zero(1)
    s, acc, _t, logs = roll(env, s, acc, [1, 1, 1, 0, 0, 1])
    assert bool(logs[5].completed)
    # second episode's rewards: 0 + 0 + 1, not contaminated by episode 1
    assert float(logs[5].total_rewards[0]) == 1.0
    assert int(logs[5].length) == 3


def test_terminal_state_pre_reset(env):
    """The returned terminal state is the stepped (pre-reset) state."""
    s = env.reset(jax.random.PRNGKey(0))
    acc = EpisodeAccumulator.zero(1)
    _s, _acc, terms, logs = roll(env, s, acc, [1, 1, 1])
    assert int(terms[2].count) == 3  # pre-reset value
    assert bool(terms[2].done)


def test_context_fields_survive_reset(env):
    s = env.reset(jax.random.PRNGKey(0))
    s = s.replace(shaping_coef=jnp.asarray(0.7, jnp.float32))
    acc = EpisodeAccumulator.zero(1)
    s, _acc, _t, _l = roll(env, s, acc, [1, 1, 1])
    assert float(s.shaping_coef) == pytest.approx(0.7)  # fresh state inherits


def test_incomplete_episode_accumulates(env):
    s = env.reset(jax.random.PRNGKey(0))
    acc = EpisodeAccumulator.zero(1)
    s, acc, _t, logs = roll(env, s, acc, [1, 0])
    assert not bool(logs[1].completed)
    assert float(acc.reward_sum[0]) == 1.0
    assert int(acc.length) == 2


def test_vmapped_autoreset_independent(env):
    """Envs at different phases reset independently under vmap."""
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    states = jax.vmap(env.reset)(keys)
    # advance env 0 by two steps manually so phases differ
    accs = jax.vmap(lambda _: EpisodeAccumulator.zero(1))(jnp.arange(3))

    def step_all(states, accs, actions, k):
        ks = jax.random.split(k, 3)
        return jax.vmap(lambda s, a, act, kk: autoreset_step(env, s, a, act, kk))(
            states, accs, actions, ks
        )

    # offset env 0: step it twice via uneven action masks (all step together,
    # but counters equal) -> instead verify done flags differ by seeding counts
    states = states.replace(count=jnp.asarray([2, 1, 0], jnp.int32))
    states, accs, terms, log = step_all(
        states, accs, jnp.asarray([1, 1, 1]), jax.random.PRNGKey(9)
    )
    done = np.asarray(log.completed)
    assert done.tolist() == [True, False, False]
    assert int(states.count[0]) == 0  # env 0 reset
    assert int(states.count[1]) == 2  # env 1 advanced


def test_tree_select_broadcasts_rank():
    pred = jnp.asarray([True, False])
    a = {"x": jnp.ones((2, 3)), "y": jnp.ones((2,))}
    b = {"x": jnp.zeros((2, 3)), "y": jnp.zeros((2,))}
    out = tree_select(pred, a, b)
    np.testing.assert_array_equal(np.asarray(out["x"][0]), np.ones(3))
    np.testing.assert_array_equal(np.asarray(out["x"][1]), np.zeros(3))
    assert out["y"].tolist() == [1.0, 0.0]


def test_default_surface():
    env = CounterEnv()
    s = env.reset(jax.random.PRNGKey(0))
    assert env.action_mask(s).shape == (2,)
    assert bool(env.action_mask(s).all())
    assert int(env.current_player(s)) == 0
    assert env.game_outcome(s).tolist() == [1]
    assert int(env.active_player_count(s)) == 1
    assert env.render(s) is None
    assert env.describe_action(1) == "Action 1"
    assert env.parse_action(" 1 ") == 1
    with pytest.raises(NotImplementedError):
        env.privileged_obs(s)
