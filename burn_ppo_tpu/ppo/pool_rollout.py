"""Rollout collection against historical opponents (vs-pool).

Reference: `collect_rollouts_with_opponents` (src/ppo.rs:537-1063) —
a fraction of envs plays against sampled past checkpoints; the learner
occupies one (shuffled) seat; only learner turns are valid training
samples; placements and seating are captured before reseating.

Device formulation: the K active opponents' parameter pytrees are
stacked along a leading axis and applied with ONE `vmap`-ed forward over
the pool-env block — no per-opponent batching or lazy model loads inside
the step (the reference partitions envs per opponent on CPU,
ppo.rs:777-862). Seat assignments and opponent slots live in device
arrays and are resampled branchlessly at episode boundaries inside the
scan, exactly where the reference reseats (ppo.rs:871-917).

Env layout: envs [0, L) are pure self-play (learner plays every seat);
envs [L, E) are pool envs (learner plays seat `learner_seat[e]`, other
seats play the opponent checkpoint in `seat_opp[e, seat]`).

Values are always the learner critic's estimates (opponents contribute
actions only). Opponent-turn entries are masked out of the PPO update
and only feed the (unused) opponent chains in multiplayer GAE, matching
the reference's effective semantics.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
from burn_ppo_tpu import struct

from burn_ppo_tpu.envs.base import Environment, EpisodeLog, autoreset_step
from burn_ppo_tpu.models.network import ActorCriticNetwork
from burn_ppo_tpu.ops.categorical import (
    apply_action_mask,
    log_prob_categorical,
    sample_categorical,
)
from burn_ppo_tpu.ppo.normalization import (
    ObsNormState,
    PopArtState,
    obs_norm_apply,
    popart_denormalize,
    return_norm_finalize,
    return_norm_roll,
)
from burn_ppo_tpu.ppo.rollout import RolloutBatch, RolloutCarry


class PoolSeating(struct.PyTreeNode):
    """Per-env seating for pool envs (ignored for self-play envs)."""

    learner_seat: jax.Array  # [E] i32; -1 = self-play env (learner everywhere)
    seat_opp: jax.Array  # [E, P] i32 opponent slot per seat (learner seat ignored)

    @staticmethod
    def create(num_envs: int, num_learner_envs: int, num_players: int,
               num_slots: int, key: jax.Array) -> "PoolSeating":
        k1, k2 = jax.random.split(key)
        seats = jax.random.randint(k1, (num_envs,), 0, num_players)
        is_selfplay = jnp.arange(num_envs) < num_learner_envs
        learner_seat = jnp.where(is_selfplay, -1, seats).astype(jnp.int32)
        seat_opp = jax.random.randint(
            k2, (num_envs, num_players), 0, max(num_slots, 1)
        ).astype(jnp.int32)
        return PoolSeating(learner_seat=learner_seat, seat_opp=seat_opp)


class PoolStepLog(struct.PyTreeNode):
    """Extra per-step record for host bookkeeping (win rates, ratings)."""

    episode: EpisodeLog
    learner_seat: jax.Array  # [E] seat BEFORE reseat
    seat_opp: jax.Array  # [E, P] slots BEFORE resample


def collect_rollouts_with_opponents(
    network: ActorCriticNetwork,
    env: Environment,
    params: Any,
    opp_params: Any,  # stacked pytree, leading axis K
    opp_obs_norm: Optional[ObsNormState],  # stacked [K, ...] or None
    carry: RolloutCarry,
    seating: PoolSeating,
    obs_norm: Optional[ObsNormState],
    popart: Optional[PopArtState],
    *,
    num_steps: int,
    num_learner_envs: int,
    num_slots: int,
    num_active=None,  # traced i32 <= num_slots, or None (= num_slots)
    gamma: float = 0.99,
    normalize_returns: bool = False,
    return_clip: float = 10.0,
    obs_clip: float = 10.0,
    env_context: Optional[dict] = None,
) -> Tuple[RolloutCarry, PoolSeating, RolloutBatch, PoolStepLog]:
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
    L = num_learner_envs
    Ep = E - L
    collect_priv = network.is_ctde

    v_obs = jax.vmap(env.obs)
    v_player = jax.vmap(env.current_player)
    v_mask = jax.vmap(env.action_mask)
    v_priv = jax.vmap(env.privileged_obs) if collect_priv else None

    def opponent_logits(obs_raw_pool):
        """Stacked-opponent policy logits for the pool envs. [K, Ep, A]"""

        def one_opponent(p, norm):
            obs = obs_raw_pool
            if norm is not None:
                obs = obs_norm_apply(norm, obs, obs_clip)
            return network.forward_actor(p, obs)  # [Ep, A]

        if opp_obs_norm is not None:
            logits_k = jax.vmap(one_opponent)(opp_params, opp_obs_norm)
        else:
            logits_k = jax.vmap(lambda p: one_opponent(p, None))(opp_params)
        return logits_k  # [K, Ep, A]

    def step_fn(state_in, _):
        c, seat = state_in
        key, k_sample, k_opp, k_reset, k_seat, k_slot = jax.random.split(c.key, 6)
        states = c.env_states

        players = v_player(states)  # [E]
        obs_raw = v_obs(states)
        obs = (
            obs_norm_apply(obs_norm, obs_raw, obs_clip)
            if obs_norm is not None
            else obs_raw
        )
        mask = v_mask(states).astype(jnp.float32)
        priv = v_priv(states) if collect_priv else None

        # Learner forward on ALL envs (values used everywhere).
        logits, values = network.policy_and_value(params, obs, priv)
        masked_logits = apply_action_mask(logits, mask)
        learner_actions = sample_categorical(k_sample, masked_logits)
        log_probs = log_prob_categorical(masked_logits, learner_actions)
        if popart is not None:
            values = popart_denormalize(popart, values)

        learner_turn = (seat.learner_seat < 0) | (players == seat.learner_seat)

        onehot = jax.nn.one_hot(players, P, dtype=values.dtype)  # [E, P]

        # Opponent forward on the pool block only. Selections are one-hot
        # contractions (see ops/categorical.log_prob_from_logp).
        if Ep > 0:
            logits_k = opponent_logits(obs_raw[L:])  # [K, Ep, A]
            acting_slot = jnp.sum(
                seat.seat_opp[L:].astype(values.dtype) * onehot[L:], axis=1
            ).astype(jnp.int32)  # [Ep]
            slot_oh = jax.nn.one_hot(
                acting_slot, logits_k.shape[0], dtype=logits_k.dtype
            )  # [Ep, K]
            opp_logits = jnp.einsum("kea,ek->ea", logits_k, slot_oh)
            opp_masked = apply_action_mask(opp_logits, mask[L:])
            opp_actions = sample_categorical(k_opp, opp_masked)
            actions = jnp.concatenate(
                [
                    learner_actions[:L],
                    jnp.where(learner_turn[L:], learner_actions[L:], opp_actions),
                ]
            )
        else:
            actions = learner_actions

        reset_keys = jax.random.split(k_reset, E)
        next_states, next_acc, terminal, log = jax.vmap(
            lambda s, a, act, k: autoreset_step(env, s, a, act, k)
        )(states, c.episode_acc, actions, reset_keys)

        all_rewards = terminal.rewards  # [E, P]
        dones = terminal.done
        oh_r = onehot.astype(all_rewards.dtype)
        acting_reward = jnp.sum(all_rewards * oh_r, axis=1)
        # Return normalization, reference pool semantics (ppo.rs:952-969):
        # the rolling return advances for EVERY acting player (variance
        # stats + normalization happen after the scan, learner turns
        # only — see return_norm_finalize below).
        ret_norm = c.return_norm
        # Scalar placeholder when normalization is off (no dead [T, E]
        # stacked output); normalize_returns is static, so the scan's
        # output structure is consistent.
        samples = jnp.zeros((), jnp.float32)
        if normalize_returns:
            # Elementwise rolling-return update only; stats + normalize
            # run once over the whole [T, E] batch after the scan.
            new_returns, samples = return_norm_roll(
                ret_norm.returns, acting_reward, players, dones, gamma
            )
            ret_norm = ret_norm.replace(returns=new_returns)
        # Record last values only on learner turns (learner's own chain).
        last_vpp = jnp.where(
            learner_turn[:, None] & (onehot > 0),
            values[:, None],
            c.last_value_per_player,
        )

        step_log = PoolStepLog(
            episode=log,
            learner_seat=seat.learner_seat,
            seat_opp=seat.seat_opp,
        )

        # Reseat + resample opponents for envs whose episode just ended
        # (capture happened above, matching ppo.rs:871-917 ordering).
        new_seats = jax.random.randint(k_seat, (E,), 0, P).astype(jnp.int32)
        is_selfplay = jnp.arange(E) < L
        new_learner_seat = jnp.where(
            dones & ~is_selfplay, new_seats, seat.learner_seat
        )
        # Slot resampling is bounded by the TRACED active count so the
        # compiled program's shape is independent of how many opponents
        # the rotation actually has — the stacked axis stays num_slots
        # (padded with duplicates that are never selected), and the pool
        # growing from 1 to max_active opponents costs zero recompiles.
        slot_hi = (
            jnp.maximum(num_active, 1)
            if num_active is not None
            else max(num_slots, 1)
        )
        new_slots = jax.random.randint(
            k_slot, (E, P), 0, slot_hi
        ).astype(jnp.int32)
        new_seat_opp = jnp.where(dones[:, None], new_slots, seat.seat_opp)

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
            valid_mask=learner_turn.astype(jnp.float32),
        )
        new_carry = RolloutCarry(
            env_states=next_states,
            episode_acc=next_acc,
            return_norm=ret_norm,
            last_value_per_player=last_vpp,
            key=key,
        )
        new_seat_state = PoolSeating(
            learner_seat=new_learner_seat, seat_opp=new_seat_opp
        )
        return (new_carry, new_seat_state), (out, step_log, samples)

    (carry_out, seat_out), (batch, logs, samples) = jax.lax.scan(
        step_fn, (carry, seating), None, length=num_steps
    )
    if normalize_returns:
        # Reference pool semantics (ppo.rs:952-996): variance stats fold
        # on LEARNER turns only, every acting reward normalizes with the
        # running (prefix) stats, and the normalized value replaces the
        # acting slot of all_rewards so GAE attribution sees it.
        new_norm, normalized = return_norm_finalize(
            carry_out.return_norm,
            samples,
            batch.rewards,
            return_clip,
            valid=batch.valid_mask,
        )
        carry_out = carry_out.replace(return_norm=new_norm)
        P = batch.all_rewards.shape[-1]
        oh_r = jax.nn.one_hot(
            batch.acting_players, P, dtype=batch.all_rewards.dtype
        )
        batch = batch.replace(
            rewards=normalized,
            all_rewards=batch.all_rewards * (1.0 - oh_r)
            + normalized[..., None] * oh_r,
        )
    return carry_out, seat_out, batch, logs
