"""The rollout `lax.scan` (self-play and vs-pool) equals a per-step
Python loop: T chained one-step rollouts, threading the carry (and the
pool seating), produce the same batch, episode logs and final carry as
one T-step rollout. Covers the four envs, masks on and off, and the
CTDE privileged-obs path on and off."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from burn_ppo_tpu.envs import make_env
from burn_ppo_tpu.models.network import make_network
from burn_ppo_tpu.ppo.pool_rollout import (
    PoolSeating,
    collect_rollouts_with_opponents,
)
from burn_ppo_tpu.ppo.rollout import collect_rollouts, init_rollout_carry

E = 4


def _env(name):
    env = make_env(name)
    if env.spec.variable_player_count:
        env = env.with_num_players(3)
    return env


def _net(env, ctde):
    return make_network(env.spec, network_type="ctde" if ctde else "mlp",
                        hidden_size=8, num_hidden=1, activation="tanh",
                        critic_hidden_size=8, critic_num_hidden=1)


def _assert_trees_close(a, b):
    """Exact for int/bool leaves; floats to ~1 ulp (the return
    normalizer folds its stats per call, so T one-step calls sum in
    another order than one T-step call)."""
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        if np.issubdtype(x.dtype, np.floating):
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-5,
                                       equal_nan=True)
        else:
            np.testing.assert_array_equal(x, y)


def _stack_steps(outs):
    """[1, ...]-stacked per-step outputs -> one [T, ...] tree."""
    return jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate(xs, axis=0), *outs)


SELFPLAY_CASES = [
    (env, masks, ctde)
    for env, ctde_options in (("cartpole", (False,)),
                              ("connect_four", (False,)),
                              ("liars_dice", (False, True)),
                              ("skull", (False, True)))
    for masks in (True, False)
    for ctde in ctde_options
]


@pytest.mark.parametrize("num_steps", [3, 8])
@pytest.mark.parametrize("env_name,masks,ctde", SELFPLAY_CASES)
def test_selfplay_scan_equals_step_loop(env_name, masks, ctde, num_steps):
    env = _env(env_name)
    net = _net(env, ctde)
    params = net.init(jax.random.PRNGKey(0))
    carry0 = init_rollout_carry(env, E, jax.random.PRNGKey(1))

    def rollout(c, t):
        return collect_rollouts(net, env, params, c, None, None,
                                num_steps=t, gamma=0.99,
                                normalize_returns=True, collect_masks=masks)

    scanned = jax.jit(lambda c: rollout(c, num_steps))(carry0)
    one = jax.jit(lambda c: rollout(c, 1))
    carry, batches, logs = carry0, [], []
    for _ in range(num_steps):
        carry, b, lg = one(carry)
        batches.append(b)
        logs.append(lg)
    _assert_trees_close(scanned[0], carry)
    _assert_trees_close(scanned[1], _stack_steps(batches))
    _assert_trees_close(scanned[2], _stack_steps(logs))
    assert (scanned[1].action_masks is None) == (not masks)
    assert (scanned[1].privileged_obs is None) == (not ctde)


POOL_CASES = [("connect_four", False), ("liars_dice", False),
              ("liars_dice", True), ("skull", False), ("skull", True)]


@pytest.mark.parametrize("num_steps", [3, 8])
@pytest.mark.parametrize("env_name,ctde", POOL_CASES)
def test_pool_scan_equals_step_loop(env_name, ctde, num_steps):
    env = _env(env_name)
    net = _net(env, ctde)
    params = net.init(jax.random.PRNGKey(0))
    K, L = 2, 2
    opp = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs),
        *[net.init(jax.random.PRNGKey(10 + i)) for i in range(K)])
    carry0 = init_rollout_carry(env, E, jax.random.PRNGKey(1))
    seat0 = PoolSeating.create(E, L, env.spec.num_players, num_slots=K,
                               key=jax.random.PRNGKey(2))

    def rollout(c, s, t):
        return collect_rollouts_with_opponents(
            net, env, params, opp, None, c, s, None, None, num_steps=t,
            num_learner_envs=L, num_slots=K, gamma=0.99,
            normalize_returns=True)

    scanned = jax.jit(lambda c, s: rollout(c, s, num_steps))(carry0, seat0)
    one = jax.jit(lambda c, s: rollout(c, s, 1))
    carry, seat, batches, logs = carry0, seat0, [], []
    for _ in range(num_steps):
        carry, seat, b, lg = one(carry, seat)
        batches.append(b)
        logs.append(lg)
    _assert_trees_close(scanned[0], carry)
    _assert_trees_close(scanned[1], seat)
    _assert_trees_close(scanned[2], _stack_steps(batches))
    _assert_trees_close(scanned[3], _stack_steps(logs))
    assert (scanned[2].privileged_obs is None) == (not ctde)
