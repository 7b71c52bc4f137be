"""On-device rollout collection as a `lax.scan`.

The reference's `collect_rollouts` (src/ppo.rs:213-500) is a Python-style
loop: envs step on CPU threads, observations ship to the device for the
forward pass, actions ship back, and the whole batch transfers once at
the end.  Here the envs *are* device code, so the loop is a `lax.scan`
over `num_steps` with every env vmapped — zero host<->device crossings.

Per-step ordering matches the reference exactly:
  1. read current players / obs / privileged obs / masks from env states
  2. normalize obs with *lagged* stats (src/ppo.rs:262-293) — the obs
     normalizer state advances only after the rollout, with the raw batch
  3. model forward -> logits, value; mask; Gumbel sample; log-prob
  4. PopArt-denormalize values (ppo.rs:357-359)
  5. env step + auto-reset (placements captured pre-reset)
  6. return-normalize the acting player's reward (ppo.rs:390-408)
  7. record per-player last values for multiplayer GAE bootstrap
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from burn_ppo_tpu import struct

from burn_ppo_tpu.envs.base import (
    Environment,
    EpisodeAccumulator,
    EpisodeLog,
    autoreset_step,
)
from burn_ppo_tpu.models.network import ActorCriticNetwork
from burn_ppo_tpu.ops.categorical import (
    apply_action_mask,
    log_prob_categorical,
    sample_categorical,
)
from burn_ppo_tpu.ppo.normalization import (
    ObsNormState,
    PopArtState,
    ReturnNormState,
    obs_norm_apply,
    popart_denormalize,
    return_norm_finalize,
    return_norm_roll,
)


class RolloutBatch(struct.PyTreeNode):
    """Collected rollout data, [T, E, ...]. Obs are stored RAW; the update
    normalizes with the same lagged stats the rollout used."""

    obs: jax.Array  # [T, E, D] raw observations
    privileged_obs: Optional[jax.Array]  # [T, E, Dp] or None
    actions: jax.Array  # [T, E] i32
    rewards: jax.Array  # [T, E] acting player's (normalized) reward
    all_rewards: jax.Array  # [T, E, P] per-player rewards (acting slot normalized)
    dones: jax.Array  # [T, E] f32
    values: jax.Array  # [T, E] (PopArt-denormalized)
    log_probs: jax.Array  # [T, E]
    acting_players: jax.Array  # [T, E] i32
    action_masks: Optional[jax.Array]  # [T, E, A] f32 or None
    valid_mask: jax.Array  # [T, E] f32, 1.0 = learner turn


class RolloutCarry(struct.PyTreeNode):
    """State threaded between rollouts (lives on device across updates)."""

    env_states: Any
    episode_acc: EpisodeAccumulator  # vmapped [E]
    return_norm: ReturnNormState
    last_value_per_player: jax.Array  # [E, P]
    key: jax.Array


def init_rollout_carry(
    env: Environment, num_envs: int, key: jax.Array
) -> RolloutCarry:
    key, sub = jax.random.split(key)
    reset_keys = jax.random.split(sub, num_envs)
    env_states = jax.vmap(env.reset)(reset_keys)
    P = env.spec.num_players
    return RolloutCarry(
        env_states=env_states,
        episode_acc=jax.vmap(lambda _: EpisodeAccumulator.zero(P))(
            jnp.arange(num_envs)
        ),
        return_norm=ReturnNormState.create(num_envs, P),
        last_value_per_player=jnp.zeros((num_envs, P), jnp.float32),
        key=key,
    )


def collect_rollouts(
    network: ActorCriticNetwork,
    env: Environment,
    params: Any,
    carry: RolloutCarry,
    obs_norm: Optional[ObsNormState],
    popart: Optional[PopArtState],
    *,
    num_steps: int,
    gamma: float,
    normalize_returns: bool,
    return_clip: float = 10.0,
    collect_masks: bool = True,
    obs_clip: float = 10.0,
    env_context: Optional[dict] = None,
) -> Tuple[RolloutCarry, RolloutBatch, EpisodeLog]:
    """Pure self-play / single-player rollout (learner acts every turn).

    ``env_context``: scalar values broadcast into the env states' context
    fields before the rollout (e.g. the scheduled reward-shaping coef).
    Returns (carry', batch, episode_logs [T, E]).
    """
    E = carry.last_value_per_player.shape[0]
    if env_context:
        states = carry.env_states
        states = states.replace(
            **{
                f: jnp.full(getattr(states, f).shape, v, getattr(states, f).dtype)
                for f, v in env_context.items()
            }
        )
        carry = carry.replace(env_states=states)
    P = env.spec.num_players
    collect_priv = network.is_ctde

    v_obs = jax.vmap(env.obs)
    v_player = jax.vmap(env.current_player)
    v_mask = jax.vmap(env.action_mask)
    v_priv = jax.vmap(env.privileged_obs) if collect_priv else None

    def step_fn(c: RolloutCarry, _):
        key, k_sample, k_reset = jax.random.split(c.key, 3)
        states = c.env_states

        players = v_player(states)  # [E]
        obs_raw = v_obs(states)  # [E, D]
        obs = (
            obs_norm_apply(obs_norm, obs_raw, obs_clip)
            if obs_norm is not None
            else obs_raw
        )
        mask = v_mask(states).astype(jnp.float32) if collect_masks else None
        priv = v_priv(states) if collect_priv else None

        logits, values = network.policy_and_value(params, obs, priv)
        masked_logits = apply_action_mask(logits, mask)
        actions = sample_categorical(k_sample, masked_logits)
        log_probs = log_prob_categorical(masked_logits, actions)
        if popart is not None:
            values = popart_denormalize(popart, values)

        reset_keys = jax.random.split(k_reset, E)
        next_states, next_acc, terminal, log = jax.vmap(
            lambda s, a, act, k: autoreset_step(env, s, a, act, k)
        )(states, c.episode_acc, actions, reset_keys)

        all_rewards = terminal.rewards  # [E, P]
        dones = terminal.done  # [E] bool
        # One-hot contraction, not take_along_axis: it fuses into the
        # surrounding elementwise pass instead of a per-row gather.
        onehot = jax.nn.one_hot(players, P, dtype=all_rewards.dtype)
        acting_reward = jnp.sum(all_rewards * onehot, axis=1)

        ret_norm = c.return_norm
        # Scalar placeholder when normalization is off (no dead [T, E]
        # stacked output); normalize_returns is static, so the scan's
        # output structure is consistent.
        samples = jnp.zeros((), jnp.float32)
        if normalize_returns:
            # Only the elementwise rolling-return update stays in the
            # scan; the Welford stats + normalization run ONCE over the
            # whole [T, E] batch after it (return_norm_finalize) — the
            # policy never consumes normalized rewards, only GAE does.
            new_returns, samples = return_norm_roll(
                ret_norm.returns, acting_reward, players, dones, gamma
            )
            ret_norm = ret_norm.replace(returns=new_returns)

        last_vpp = (
            c.last_value_per_player * (1.0 - onehot) + values[:, None] * onehot
        )

        out = RolloutBatch(
            obs=obs_raw,
            privileged_obs=priv,
            actions=actions,
            rewards=acting_reward,
            all_rewards=all_rewards,
            dones=dones.astype(jnp.float32),
            values=values,
            log_probs=log_probs,
            acting_players=players,
            action_masks=mask,
            valid_mask=jnp.ones((E,), jnp.float32),
        )
        new_carry = RolloutCarry(
            env_states=next_states,
            episode_acc=next_acc,
            return_norm=ret_norm,
            last_value_per_player=last_vpp,
            key=key,
        )
        return new_carry, (out, log, samples)

    carry_out, (batch, logs, samples) = jax.lax.scan(
        step_fn, carry, None, length=num_steps
    )
    if normalize_returns:
        new_norm, normalized = return_norm_finalize(
            carry_out.return_norm, samples, batch.rewards, return_clip
        )
        carry_out = carry_out.replace(return_norm=new_norm)
        onehot = jax.nn.one_hot(
            batch.acting_players, P, dtype=batch.all_rewards.dtype
        )
        batch = batch.replace(
            rewards=normalized,
            all_rewards=batch.all_rewards * (1.0 - onehot)
            + normalized[..., None] * onehot,
        )
    return carry_out, batch, logs


def bootstrap_values(
    network: ActorCriticNetwork,
    env: Environment,
    params: Any,
    carry: RolloutCarry,
    obs_norm: Optional[ObsNormState],
    popart: Optional[PopArtState],
    obs_clip: float = 10.0,
) -> Tuple[jax.Array, jax.Array]:
    """Value of the final env states for GAE bootstrap.

    Returns (last_values [E], last_value_per_player [E, P]) where the
    per-player matrix has the current players' slots refreshed with the
    bootstrap forward (reference src/main.rs:878-931).
    """
    states = carry.env_states
    obs = jax.vmap(env.obs)(states)
    if obs_norm is not None:
        obs = obs_norm_apply(obs_norm, obs, obs_clip)
    if network.is_ctde:
        priv = jax.vmap(env.privileged_obs)(states)
        values = network.forward_critic(params, priv, obs)
    else:
        values = network.forward(params, obs)[1]
    if popart is not None:
        values = popart_denormalize(popart, values)
    players = jax.vmap(env.current_player)(states)
    P = env.spec.num_players
    onehot = jax.nn.one_hot(players, P, dtype=values.dtype)
    last_vpp = (
        carry.last_value_per_player * (1.0 - onehot) + values[:, None] * onehot
    )
    return values, last_vpp
