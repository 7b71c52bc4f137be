"""burn_ppo_tpu.struct: frozen dataclass pytrees.

Every device state class must flatten its fields in declaration order
with attribute key paths (the checkpoint leaf order), unflatten back,
support ``replace``, and stay frozen; ``field(pytree_node=False)`` marks
static metadata that is never a leaf."""

import dataclasses
import glob
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from burn_ppo_tpu import struct
from burn_ppo_tpu.checkpoint import CheckpointManager, load_pytree
from burn_ppo_tpu.envs.base import EpisodeAccumulator, EpisodeLog
from burn_ppo_tpu.envs.cartpole import CartPoleState
from burn_ppo_tpu.envs.connect_four import ConnectFourState
from burn_ppo_tpu.envs.liars_dice import LiarsDiceState
from burn_ppo_tpu.envs.skull import SkullState
from burn_ppo_tpu.eval import _EvalCarry
from burn_ppo_tpu.ppo.entropy import AdaptiveEntropyState
from burn_ppo_tpu.ppo.normalization import (
    ObsNormState,
    PopArtState,
    ReturnNormState,
)
from burn_ppo_tpu.ppo.pool_rollout import PoolSeating, PoolStepLog
from burn_ppo_tpu.ppo.rollout import RolloutBatch, RolloutCarry
from burn_ppo_tpu.train import PoolRecordLog, TrainState

STATE_CLASSES = [
    EpisodeLog, EpisodeAccumulator, CartPoleState, ConnectFourState,
    LiarsDiceState, SkullState, _EvalCarry, AdaptiveEntropyState,
    ObsNormState, ReturnNormState, PopArtState, PoolSeating, PoolStepLog,
    RolloutBatch, RolloutCarry, TrainState, PoolRecordLog,
]


def _filled(cls):
    """An instance whose i-th field holds the array [i, i + 0.5]."""
    names = [f.name for f in dataclasses.fields(cls)]
    return cls(**{n: jnp.asarray([i, i + 0.5], jnp.float32)
                  for i, n in enumerate(names)}), names


@pytest.mark.parametrize("cls", STATE_CLASSES, ids=lambda c: c.__name__)
def test_flatten_unflatten_replace(cls):
    inst, names = _filled(cls)
    paths_leaves, treedef = jax.tree_util.tree_flatten_with_path(inst)
    assert [p[0].name for p, _ in paths_leaves] == names
    assert [float(x[0]) for _, x in paths_leaves] == list(range(len(names)))

    back = jax.tree_util.tree_unflatten(treedef, [x for _, x in paths_leaves])
    assert type(back) is cls
    for n in names:
        np.testing.assert_array_equal(getattr(back, n), getattr(inst, n))

    first = names[0]
    new = inst.replace(**{first: jnp.zeros(3)})
    assert getattr(new, first).shape == (3,)
    assert getattr(inst, first).shape == (2,)  # original untouched
    with pytest.raises(dataclasses.FrozenInstanceError):
        setattr(inst, first, None)


def test_none_fields_are_empty_subtrees():
    """Optional fields set to None contribute no leaves (RolloutBatch
    without privileged obs / masks)."""
    inst, names = _filled(RolloutBatch)
    full = len(jax.tree_util.tree_leaves(inst))
    inst = inst.replace(privileged_obs=None, action_masks=None)
    assert len(jax.tree_util.tree_leaves(inst)) == full - 2


class _WithStatic(struct.PyTreeNode):
    x: jax.Array
    size: int = struct.field(pytree_node=False, default=4)


def test_static_field_is_not_a_leaf():
    a = _WithStatic(x=jnp.ones(2))
    leaves, treedef = jax.tree_util.tree_flatten(a)
    assert len(leaves) == 1
    assert jax.tree_util.tree_unflatten(treedef, leaves).size == 4
    # The static value is part of the structure: a change is a new tree.
    assert treedef != jax.tree_util.tree_structure(a.replace(size=5))

    traced_sizes = []

    @jax.jit
    def f(s):
        traced_sizes.append(s.size)
        return s.x * s.size

    np.testing.assert_allclose(f(a), [4.0, 4.0])
    np.testing.assert_allclose(f(a.replace(size=2)), [2.0, 2.0])
    assert traced_sizes == [4, 2]


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_GAUNTLET = sorted(
    os.path.relpath(os.path.dirname(p), _REPO)
    for p in glob.glob(os.path.join(_REPO, "gauntlet", "*", "r4*",
                                    "metadata.json"))
)


@pytest.mark.parametrize("entry", _GAUNTLET)
def test_committed_checkpoints_still_load(entry):
    """The committed gauntlet checkpoints (saved when the states were
    flax dataclasses) load unchanged: same leaf order, same shapes."""
    ckpt = os.path.join(_REPO, entry)
    network, params, meta = CheckpointManager.load_model(ckpt)
    for leaf in jax.tree_util.tree_leaves(params):
        assert np.all(np.isfinite(np.asarray(leaf)))

    obs_norm = CheckpointManager.load_obs_normalizer(ckpt)
    assert (obs_norm is not None) == bool(meta.get("normalize_obs"))
    if obs_norm is not None:
        assert isinstance(obs_norm, ObsNormState)
        assert obs_norm.mean.shape == (meta["obs_dim"],)

    with np.load(os.path.join(ckpt, "return_norm.npz")) as f:
        e, p = f["leaf_00000"].shape
    ret = load_pytree(Path(ckpt) / "return_norm.npz",
                      ReturnNormState.create(e, p))
    assert isinstance(ret, ReturnNormState) and ret.returns.shape == (e, p)
    assert p == meta["num_players"]

    obs = jnp.zeros((3, meta["obs_dim"]), jnp.float32)
    priv = (jnp.zeros((3, network.privileged_obs_dim), jnp.float32)
            if network.is_ctde else None)
    logits, values = network.policy_and_value(params, obs, priv)
    assert logits.shape[0] == 3 and np.all(np.isfinite(np.asarray(values)))
