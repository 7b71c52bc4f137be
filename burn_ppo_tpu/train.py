"""Training orchestrator.

The reference's `run_training` (src/main.rs:167-1632) is a host loop
around four phases: collect rollouts, GAE, PPO update, bookkeeping. Here
the first three phases fuse into ONE jitted `train_step` that never
leaves the device; the host loop only evaluates schedules, logs metrics,
and writes checkpoints.

Self-play with an opponent pool follows the reference's wiring
(main.rs:564-825): a fraction of envs plays vs sampled historical
checkpoints, game results feed EMA win rates and the Plackett-Luce
rating history, and ratings drive the ``best`` symlink for multiplayer
runs (main.rs:1348-1353).

Fresh/Resume/Fork modes (main.rs:151-161), checkpoint cadence + best
tracking (main.rs:1226-1418), per-player episode metrics
(main.rs:1026-1223) and the perf/* timing series (main.rs:530-533,
1092-1124) all have direct equivalents.
"""

from __future__ import annotations

import json
import os
import signal
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from burn_ppo_tpu import struct

from burn_ppo_tpu.checkpoint import CheckpointManager, build_metadata, fetch_tree
from burn_ppo_tpu.config import Config
from burn_ppo_tpu.envs import make_env
from burn_ppo_tpu.envs.base import Environment
from burn_ppo_tpu.metrics import MetricsLogger
from burn_ppo_tpu.models.network import ActorCriticNetwork, make_network
from burn_ppo_tpu.ops.gae import compute_gae, compute_gae_multiplayer
from burn_ppo_tpu.parallel.mesh import make_mesh, replicate, shard_rollout_carry
from burn_ppo_tpu.ppo.entropy import AdaptiveEntropyController
from burn_ppo_tpu.ppo.normalization import (
    ObsNormState,
    PopArtState,
    obs_norm_apply,
    obs_norm_update,
)
from burn_ppo_tpu.ppo.pool_rollout import (
    PoolSeating,
    collect_rollouts_with_opponents,
)
from burn_ppo_tpu.ppo.rollout import (
    RolloutCarry,
    bootstrap_values,
    collect_rollouts,
    init_rollout_carry,
)
from burn_ppo_tpu.ppo.update import PPOUpdateConfig, make_optimizer, ppo_update


class TrainState(struct.PyTreeNode):
    params: Any
    opt_state: Any
    carry: RolloutCarry
    obs_norm: Optional[ObsNormState]
    popart: Optional[PopArtState]
    update_key: jax.Array
    # Device-resident adaptive-entropy controller state (None unless
    # cfg.adaptive_entropy is set); updated inside the fused step so
    # adaptive runs keep K-update windows (entropy.rs:62-105 semantics).
    ent_state: Optional[Any] = None


def build_network_for_env(env: Environment, cfg: Config) -> ActorCriticNetwork:
    return make_network(
        env.spec,
        network_type=cfg.network_type,
        hidden_size=cfg.hidden_size,
        num_hidden=cfg.num_hidden,
        activation=cfg.activation,
        split_networks=cfg.split_networks,
        critic_hidden_size=cfg.critic_hidden_size,
        critic_num_hidden=cfg.critic_num_hidden,
        num_conv_layers=cfg.num_conv_layers,
        conv_channels=cfg.conv_channels,
        kernel_size=cfg.kernel_size,
        cnn_fc_hidden_size=cfg.cnn_fc_hidden_size,
        cnn_num_fc_layers=cfg.cnn_num_fc_layers,
        compute_dtype=cfg.compute_dtype,
    )


def _update_cfg(cfg: Config) -> PPOUpdateConfig:
    return PPOUpdateConfig(
        clip_epsilon=cfg.clip_epsilon,
        clip_value=cfg.clip_value,
        value_coef=cfg.value_coef,
        max_grad_norm=cfg.max_grad_norm,
        num_epochs=cfg.num_epochs,
        num_minibatches=cfg.num_minibatches,
        target_kl=cfg.target_kl,
        adam_epsilon=cfg.adam_epsilon,
        normalize_values=cfg.normalize_values,
        shuffle_block_rows=cfg.shuffle_block_rows,
    )


def _prepare_update(network, env, cfg, state, carry, batch):
    """Normalizer advance + bootstrap + GAE + flatten into update data.

    Returns (obs_norm_new, data).  Split from the optimizer phase so the
    profiler can time the GAE stage separately (perf/gae_time,
    main.rs:1104-1124)."""
    multiplayer = env.spec.num_players > 1

    # Lagged obs-normalizer advance: stats absorb this rollout's raw batch
    # AFTER collection (ppo.rs:495-497); the bootstrap forward then uses
    # the updated stats (main.rs:878-883).
    obs_norm_new = (
        obs_norm_update(state.obs_norm, batch.obs)
        if state.obs_norm is not None
        else None
    )
    last_values, last_vpp = bootstrap_values(
        network, env, state.params, carry, obs_norm_new, state.popart
    )

    if multiplayer:
        advantages, returns = compute_gae_multiplayer(
            batch.all_rewards, batch.values, batch.dones,
            batch.acting_players, last_vpp, cfg.gamma, cfg.gae_lambda,
        )
    else:
        advantages, returns = compute_gae(
            batch.rewards, batch.values, batch.dones, last_values,
            cfg.gamma, cfg.gae_lambda,
        )

    T, E = batch.actions.shape
    N = T * E
    obs_for_update = (
        obs_norm_apply(state.obs_norm, batch.obs)
        if state.obs_norm is not None
        else batch.obs
    )
    data = {
        "obs": obs_for_update.reshape(N, -1),
        "actions": batch.actions.reshape(N),
        "old_log_probs": batch.log_probs.reshape(N),
        "advantages": advantages.reshape(N),
        "returns": returns.reshape(N),
        "old_values": batch.values.reshape(N),
        "valid": batch.valid_mask.reshape(N),
    }
    if batch.privileged_obs is not None:
        data["privileged_obs"] = batch.privileged_obs.reshape(N, -1)
    if batch.action_masks is not None:
        data["action_masks"] = batch.action_masks.reshape(N, env.spec.num_actions)
    return obs_norm_new, data


def _apply_update(network, cfg, tx, state, carry, obs_norm_new, data, lr,
                  ent_coef, may_have_invalid=False):
    """Optimizer phase: minibatch PPO epochs. Returns (new_state, metrics)."""
    ucfg = _update_cfg(cfg)
    key, sub = jax.random.split(state.update_key)
    params, opt_state, popart, metrics = ppo_update(
        network, tx, state.params, state.opt_state, data, state.popart,
        sub, lr, ent_coef, ucfg, may_have_invalid=may_have_invalid,
    )
    if popart is not None:
        metrics["value_norm/mean"] = popart.mean
        metrics["value_norm/std"] = popart.std

    new_state = TrainState(
        params=params, opt_state=opt_state, carry=carry,
        obs_norm=obs_norm_new, popart=popart, update_key=key,
        ent_state=state.ent_state,
    )
    return new_state, metrics


def _guard_counts(batch) -> Dict[str, jax.Array]:
    """Runtime-guard reductions over the collected rollout.

    The reference PANICS on an empty action mask (utils.rs:115-135) and
    asserts finite log-probs/values every step (ppo.rs:363-366, 754-757).
    Inside jit a broken env would instead silently sample garbage (an
    all-masked row still yields finite uniform log-probs), so the fused
    step counts violations on device — two fused reductions, free — and
    the host loop raises/warns when they are nonzero.
    """
    guards: Dict[str, jax.Array] = {}
    if batch.action_masks is not None:
        guards["invalid_mask_count"] = jnp.sum(
            (jnp.sum(batch.action_masks, axis=-1) == 0.0).astype(jnp.float32)
        )
    nonfinite = jnp.sum(
        (~jnp.isfinite(batch.log_probs)).astype(jnp.float32)
    ) + jnp.sum((~jnp.isfinite(batch.values)).astype(jnp.float32))
    guards["nonfinite_count"] = nonfinite
    return guards


# Metric keys that accumulate (sum) across a fused window rather than
# reporting the last update's value.
GUARD_METRIC_KEYS = ("invalid_mask_count", "nonfinite_count")


def _finish_step(network, env, cfg, tx, state, carry, batch, lr, ent_coef,
                 may_have_invalid=False):
    """Shared post-rollout pipeline: normalizer advance, bootstrap, GAE,
    flatten, PPO update. Returns (new_state, metrics).

    With adaptive entropy configured, ``ent_coef`` is the scheduled
    TARGET entropy; the coefficient is derived on device from
    ``state.ent_state`` and the realized entropy is recorded back —
    reference get_coefficient/record_entropy cadence (entropy.rs:62-87)
    without leaving the fused step."""
    adaptive = cfg.adaptive_entropy is not None
    if adaptive:
        from burn_ppo_tpu.ppo.entropy import (
            adaptive_entropy_record,
            adaptive_entropy_step,
        )

        ent_coef, ent_state = adaptive_entropy_step(
            state.ent_state, ent_coef,
            cfg.adaptive_entropy_min_coef, cfg.adaptive_entropy_max_coef,
            cfg.adaptive_entropy_delta,
        )
        state = state.replace(ent_state=ent_state)
    obs_norm_new, data = _prepare_update(network, env, cfg, state, carry, batch)
    new_state, metrics = _apply_update(
        network, cfg, tx, state, carry, obs_norm_new, data, lr, ent_coef,
        may_have_invalid=may_have_invalid,
    )
    if adaptive:
        new_state = new_state.replace(
            ent_state=adaptive_entropy_record(
                new_state.ent_state, metrics["entropy"]
            )
        )
        metrics["adaptive_ent_coef"] = ent_coef
    if cfg.runtime_guards != "off":
        metrics.update(_guard_counts(batch))
    return new_state, metrics


def make_train_step(
    network: ActorCriticNetwork,
    env: Environment,
    cfg: Config,
    tx,
    compact_stats: bool = False,
):
    """Fused self-play rollout -> GAE -> PPO update, to be jitted.

    With ``compact_stats`` the third output is a dict of on-device
    episode-summary scalars instead of the full [T, E] EpisodeLog —
    ~100MB/update less host traffic at large env counts (the Trainer's
    default path; see ppo/episode_stats.py)."""
    normalize_returns = cfg.effective_normalize_returns(env.spec.num_players)
    has_shaping = "shaping_coef" in getattr(env, "context_fields", ())

    def train_step(state: TrainState, lr, ent_coef, shaping_coef):
        ctx = {"shaping_coef": shaping_coef} if has_shaping else None
        carry, batch, logs = collect_rollouts(
            network, env, state.params, state.carry, state.obs_norm,
            state.popart,
            num_steps=cfg.num_steps, gamma=cfg.gamma,
            normalize_returns=normalize_returns, return_clip=cfg.return_clip,
            env_context=ctx,
        )
        new_state, metrics = _finish_step(
            network, env, cfg, tx, state, carry, batch, lr, ent_coef
        )
        if compact_stats:
            from burn_ppo_tpu.ppo.episode_stats import summarize_episode_logs

            return new_state, metrics, summarize_episode_logs(
                logs, env.spec.num_players
            )
        return new_state, metrics, logs

    return train_step


def make_train_window(
    network: ActorCriticNetwork, env: Environment, cfg: Config, tx
):
    """K fused train steps per host call (K = length of the schedule
    arrays), to be jitted once per distinct K.

    Production training logs every ``log_freq`` steps, not every
    update; chaining the intermediate updates through the host only adds
    dispatch latency. The window
    scans the fused train step K times on device, returns the LAST
    update's metrics (what the reference logs at a boundary,
    main.rs:1026) and the episode summaries summed over the window.
    """
    step = make_train_step(network, env, cfg, tx, compact_stats=True)

    def window(state: TrainState, lrs, ent_coefs, shaping_coefs):
        def body(s, xs):
            lr, ec, sc = xs
            s2, metrics, stats = step(s, lr, ec, sc)
            return s2, (metrics, stats)

        state, (metrics_all, stats_all) = jax.lax.scan(
            body, state, (lrs, ent_coefs, shaping_coefs)
        )
        metrics, stats = _aggregate_window(metrics_all, stats_all)
        return state, metrics, stats

    return window


def largest_pow2_le(n: int) -> int:
    """Largest power of two <= n (n >= 1). Window sizes MUST come from
    this one function: jit caches one executable per window length, and
    the background pool-window precompile warms exactly the power-of-2
    family — a second quantization scheme would mint its own
    multi-minute compile mid-training."""
    k = 1
    while k * 2 <= n:
        k *= 2
    return k


def _aggregate_window(metrics_all, stats_all):
    """Fold per-update window outputs into one boundary report: the LAST
    update's metrics (what the reference logs, main.rs:1026) with guard
    counters SUMMED (a violation in a non-final update must not vanish),
    and episode stats summed/extremized over the window. Shared by the
    pool and non-pool windows so a new stat or guard key can't silently
    drop from one path's logging."""
    metrics = jax.tree_util.tree_map(lambda x: x[-1], metrics_all)
    for gk in GUARD_METRIC_KEYS:
        if gk in metrics_all:
            metrics[gk] = jnp.sum(metrics_all[gk])
    # Window-maxima for the two spike-prone series: the reference logs
    # EVERY update (main.rs:1026), so a one-update KL blow-up inside a
    # fused K-window must stay visible even though only the last
    # update's value is reported as the boundary metric.
    for mk in ("approx_kl", "clip_fraction"):
        if mk in metrics_all:
            metrics[f"{mk}_max"] = jnp.max(metrics_all[mk])
    stats = {
        "count": jnp.sum(stats_all["count"]),
        "ret_sum": jnp.sum(stats_all["ret_sum"], axis=0),
        "ret0_max": jnp.max(stats_all["ret0_max"]),
        "ret0_min": jnp.min(stats_all["ret0_min"]),
        "len_sum": jnp.sum(stats_all["len_sum"]),
        "pts_sum": jnp.sum(stats_all["pts_sum"], axis=0),
        "draws": jnp.sum(stats_all["draws"]),
    }
    return metrics, stats


class PoolRecordLog(struct.PyTreeNode):
    """Compact per-step pool-env record for host bookkeeping.

    Exactly the four fields the win-rate/rating pipeline reads
    (extract_pool_records), packed to int8 on device — placements, seats
    and rotation slots all fit — so a K-update window ships
    [K*T, Ep] * (2P + 2) bytes instead of the full episode log."""

    completed: jax.Array  # [T, Ep] bool
    outcome: jax.Array  # [T, Ep, P] i8 placements (1-indexed)
    learner_seat: jax.Array  # [T, Ep] i8, seat BEFORE reseat (-1 = selfplay)
    seat_opp: jax.Array  # [T, Ep, P] i8 rotation slots BEFORE resample


def make_pool_train_step(
    network: ActorCriticNetwork, env: Environment, cfg: Config, tx,
    num_learner_envs: int, num_slots: int,
):
    """Vs-pool variant: K stacked opponents act on the pool-env block.

    Host traffic is trimmed on device: the self-play (learner) env
    block's episode stats reduce to window scalars (episode_stats.py),
    and only the pool-env columns of the episode/seating logs — the part
    the win-rate/rating bookkeeping actually reads — are returned,
    packed int8 (PoolRecordLog)."""
    has_shaping = "shaping_coef" in getattr(env, "context_fields", ())

    def train_step(state: TrainState, seating: PoolSeating, opp_params,
                   opp_obs_norm, lr, ent_coef, shaping_coef,
                   num_active=None):
        from burn_ppo_tpu.ppo.episode_stats import summarize_episode_logs

        ctx = {"shaping_coef": shaping_coef} if has_shaping else None
        carry, seat_out, batch, pool_logs = collect_rollouts_with_opponents(
            network, env, state.params, opp_params, opp_obs_norm,
            state.carry, seating, state.obs_norm, state.popart,
            num_steps=cfg.num_steps,
            num_learner_envs=num_learner_envs,
            num_slots=num_slots,
            num_active=num_active,
            gamma=cfg.gamma,
            normalize_returns=cfg.effective_normalize_returns(
                env.spec.num_players
            ),
            return_clip=cfg.return_clip,
            env_context=ctx,
        )
        # Pool rollouts mark only learner turns valid: the update must
        # compile the all-invalid-minibatch skip guard.
        new_state, metrics = _finish_step(
            network, env, cfg, tx, state, carry, batch, lr, ent_coef,
            may_have_invalid=True,
        )
        learner_stats = summarize_episode_logs(
            jax.tree_util.tree_map(
                lambda x: x[:, :num_learner_envs], pool_logs.episode
            ),
            env.spec.num_players,
        )
        L = num_learner_envs
        pool_records = PoolRecordLog(
            completed=pool_logs.episode.completed[:, L:],
            outcome=pool_logs.episode.outcome[:, L:].astype(jnp.int8),
            learner_seat=pool_logs.learner_seat[:, L:].astype(jnp.int8),
            seat_opp=pool_logs.seat_opp[:, L:].astype(jnp.int8),
        )
        return new_state, seat_out, metrics, learner_stats, pool_records

    return train_step


def make_pool_train_window(
    network: ActorCriticNetwork, env: Environment, cfg: Config, tx,
    num_learner_envs: int, num_slots: int,
):
    """W fused vs-pool train steps per host call (W = schedule length).

    The opponent rotation is FIXED for the whole window and game records
    fold into win-rate EMAs / the rating history once per window — the
    reference's per-update cadence (opponent_pool.rs:233-246, 628-653)
    generalized to a configurable interval (cfg.pool_rotation_interval;
    W = 1 reproduces it exactly).

    Completed-game records are COMPACTED ON DEVICE into a fixed-capacity
    [C, 2P-1] int8 row buffer (scatter by cumsum position, same row
    layout and order as extract_pool_records over the per-step logs) —
    the host fetches ~hundreds of KB per window instead of the full
    [W*T, Ep] log. The computation is global, so under multi-host
    sharding the buffer already contains every host's games (no Gloo
    allgather needed). C = max(4096, W*T*Ep/8) covers >10x the typical
    completion rate; overflow is counted and surfaced as a warning
    metric (dropped rows would bias win-rate/rating stats, never the
    training math)."""
    step = make_pool_train_step(
        network, env, cfg, tx, num_learner_envs, num_slots
    )
    P = env.spec.num_players
    width = 2 * P - 1

    def compact_records(records_all):
        # Leaves [W, T, Ep, ...] -> flat [N] with N = W*T*Ep; flatten
        # order (w, t, e) matches sequential per-step host extraction.
        completed = records_all.completed.reshape(-1)
        seats = records_all.learner_seat.reshape(-1).astype(jnp.int32)
        outcome = records_all.outcome.reshape(-1, P).astype(jnp.int32)
        slots = records_all.seat_opp.reshape(-1, P).astype(jnp.int32)
        N = completed.shape[0]
        sel = completed & (seats >= 0)

        seat_oh = jax.nn.one_hot(
            jnp.clip(seats, 0, P - 1), P, dtype=jnp.int32
        )
        learner_place = jnp.sum(outcome * seat_oh, axis=1)  # [N]
        # Opponent seat order = seat order skipping the learner seat:
        # column j reads seat j + (j >= learner_seat).
        j = jnp.arange(P - 1)[None, :]
        opp_seat = j + (j >= seats[:, None])  # [N, P-1]
        opp_oh = jax.nn.one_hot(opp_seat, P, dtype=jnp.int32)  # [N,P-1,P]
        opp_slots = jnp.einsum("njp,np->nj", opp_oh, slots)
        opp_places = jnp.einsum("njp,np->nj", opp_oh, outcome)
        rows_full = jnp.concatenate(
            [learner_place[:, None], opp_slots, opp_places], axis=1
        ).astype(jnp.int8)  # [N, width]

        cap = max(4096, N // 8)
        pos = jnp.cumsum(sel.astype(jnp.int32)) - 1
        scatter_idx = jnp.where(sel, pos, cap)  # cap = out of bounds
        buf = jnp.zeros((cap, width), jnp.int8)
        buf = buf.at[scatter_idx].set(rows_full, mode="drop")
        count = jnp.sum(sel.astype(jnp.int32))
        return {"rows": buf, "count": jnp.minimum(count, cap)}, (
            jnp.maximum(count - cap, 0).astype(jnp.float32)
        )

    def window(state: TrainState, seating: PoolSeating, opp_params,
               opp_obs_norm, lrs, ent_coefs, shaping_coefs,
               num_active=None):
        def body(c, xs):
            s, seat = c
            lr, ec, sc = xs
            s2, seat2, metrics, lstats, records = step(
                s, seat, opp_params, opp_obs_norm, lr, ec, sc, num_active
            )
            return (s2, seat2), (metrics, lstats, records)

        (state, seating), (metrics_all, stats_all, records_all) = jax.lax.scan(
            body, (state, seating), (lrs, ent_coefs, shaping_coefs)
        )
        metrics, stats = _aggregate_window(metrics_all, stats_all)
        records, overflow = compact_records(records_all)
        metrics["pool_record_overflow"] = overflow
        return state, seating, metrics, stats, records

    return window


def extract_pool_records(pool_records, num_players: int) -> np.ndarray:
    """Completed pool-env episodes -> fixed-width record rows
    [learner_place | opp_slot x (P-1) | opp_place x (P-1)], int32.

    Vectorized (no per-episode Python loop — reference batches once per
    rotation, opponent_pool.rs:628-653); operates on one host's local
    block of the pool-env columns only (a PoolRecordLog, with the window
    axis already folded into T)."""
    P = num_players
    width = 2 * P - 1
    completed = np.asarray(pool_records.completed)  # [T, Ep_local]
    seats = np.asarray(pool_records.learner_seat, dtype=np.int32)
    sel = completed & (seats >= 0)
    if completed.size == 0 or not sel.any():
        return np.zeros((0, width), np.int32)
    outcomes = np.asarray(pool_records.outcome, dtype=np.int32)  # [T, Ep, P]
    slots = np.asarray(pool_records.seat_opp, dtype=np.int32)  # [T, Ep, P]
    t_idx, e_idx = np.nonzero(sel)
    place = outcomes[t_idx, e_idx]  # [n, P]
    seat = seats[t_idx, e_idx]  # [n]
    slot = slots[t_idx, e_idx]  # [n, P]
    opp_mask = np.arange(P)[None, :] != seat[:, None]
    opp_slots = slot[opp_mask].reshape(-1, P - 1)
    opp_places = place[opp_mask].reshape(-1, P - 1)
    learner_place = place[np.arange(len(seat)), seat]
    return np.concatenate(
        [learner_place[:, None], opp_slots, opp_places], axis=1
    ).astype(np.int32)


class Trainer:
    """Owns the device state + host bookkeeping for one training run."""

    def __init__(
        self,
        cfg: Config,
        run_dir: str | Path,
        *,
        resume_from: Optional[str | Path] = None,
        forked_from_run: Optional[str] = None,
        quiet: bool = False,
        max_checkpoints_this_run: int = 0,
        elapsed_time_offset: float = 0.0,
        profile_dir: Optional[str | Path] = None,
        profile_start: int = 1,
        profile_updates: int = 2,
        profile_phases: bool = False,
        debug_checkify: bool = False,
    ):
        # Supervisor-mode knobs (reference supervisor.rs / main.rs:1700-1784):
        # exit after N checkpoint saves so a parent can respawn; carry the
        # parent's elapsed time for accurate ETA/limit accounting.
        self.max_checkpoints_this_run = max_checkpoints_this_run
        self.elapsed_time_offset = elapsed_time_offset
        cfg.validate()
        self.cfg = cfg
        self.run_dir = Path(run_dir)
        # Host-0 discipline (multi-host runs): only process 0 writes the
        # run dir, metrics, checkpoints, graphs and progress output; the
        # other hosts run the same device program silently.
        from burn_ppo_tpu.parallel.distributed import is_primary

        self.is_primary = is_primary()
        if self.is_primary:
            self.run_dir.mkdir(parents=True, exist_ok=True)
        self.quiet = quiet or not self.is_primary

        self.mesh = make_mesh(cfg.mesh_data)
        self.num_devices = self.mesh.devices.size
        self.num_envs = cfg.resolve_num_envs(self.num_devices)

        self.env = make_env(cfg.env)
        if self.env.spec.variable_player_count:
            self.env = self.env.with_num_players(cfg.player_count.get_fixed_count())
        self.num_players = self.env.spec.num_players
        self.network = build_network_for_env(self.env, cfg)
        self.tx = make_optimizer(_update_cfg(cfg))

        self.multihost = jax.process_count() > 1
        self.seed = cfg.seed if cfg.seed is not None else int(time.time()) % (2**31)
        if self.multihost:
            # Every host must derive the SAME rng streams (params init,
            # rotation sampling): a time-based seed would diverge.
            from burn_ppo_tpu.parallel.distributed import broadcast_from_primary

            self.seed = int(
                broadcast_from_primary(np.asarray([self.seed], np.int64))[0]
            )
        root_key = jax.random.PRNGKey(self.seed)
        k_params, k_carry, k_update, k_seat = jax.random.split(root_key, 4)

        # ONE jitted program builds the whole fresh state: run eagerly,
        # the per-layer orthogonal inits (qr/normal/threefry) and every
        # distinctly-shaped zeros() each mint their own tiny executable —
        # ~40 compiles, re-paid by every supervisor child.
        def _fresh_state(kp, kc):
            params = self.network.init(kp)
            return (
                params,
                self.tx.init(params),
                init_rollout_carry(self.env, self.num_envs, kc),
                ObsNormState.create(self.env.spec.obs_dim)
                if cfg.normalize_obs
                else None,
                PopArtState.create() if cfg.normalize_values else None,
            )

        params, opt_state, carry, obs_norm, popart = jax.jit(_fresh_state)(
            k_params, k_carry
        )

        self.global_step = 0
        self.best_avg_return = float("-inf")
        self.ckpt = CheckpointManager(self.run_dir)

        if resume_from is not None:
            params, opt_state, obs_norm, popart, carry, k_update = self._restore(
                Path(resume_from), params, opt_state, obs_norm, popart, carry
            )

        # Place on the mesh: params/opt replicated, env state sharded.
        params = replicate(params, self.mesh)
        opt_state = replicate(opt_state, self.mesh)
        if obs_norm is not None:
            obs_norm = replicate(obs_norm, self.mesh)
        if popart is not None:
            popart = replicate(popart, self.mesh)
        carry = shard_rollout_carry(carry, self.mesh)

        # Adaptive-entropy controller state lives ON DEVICE (fresh each
        # process, like the reference's in-memory controller) so adaptive
        # runs stay inside fused windows; only the scheduled target
        # crosses the host boundary.
        ent_state = None
        if cfg.adaptive_entropy is not None:
            from burn_ppo_tpu.ppo.entropy import AdaptiveEntropyState

            ent_state = replicate(
                AdaptiveEntropyState.create(cfg.entropy_coef.get(0)), self.mesh
            )
        self.state = TrainState(
            params=params, opt_state=opt_state, carry=carry,
            obs_norm=obs_norm, popart=popart,
            update_key=jax.device_put(
                k_update,
                jax.sharding.NamedSharding(self.mesh, jax.sharding.PartitionSpec()),
            ),
            ent_state=ent_state,
        )

        # Make the epoch-shuffle granularity visible once per run: tiled
        # shuffling (block > 1) is a deliberate semantic switch
        # (see PPOUpdateConfig.shuffle_block_rows).
        from burn_ppo_tpu.ppo.update import resolve_shuffle_block

        _n = cfg.num_steps * self.num_envs
        # Same ceil-and-pad mb_size as ppo_update (update.py) — floor
        # division would report the wrong tile size (or stay silent)
        # for uneven N % num_minibatches.
        _block = resolve_shuffle_block(
            -(-_n // cfg.num_minibatches), cfg.shuffle_block_rows
        )
        if _block > 1 and not self.quiet:
            print(
                f"epoch shuffle: tiled, {_block} rows/tile "
                f"({_n} samples/update; set shuffle_block_rows = 0 for "
                "exact per-sample shuffling)"
            )

        _raw_step = make_train_step(
            self.network, self.env, cfg, self.tx, compact_stats=True
        )
        # Checkify debug mode: functionalized NaN/div checks through the
        # whole fused step — the debug analog of the reference's runtime
        # asserts (ppo.rs:363-366). ~2x slower, so opt-in (--checkify).
        self.debug_checkify = debug_checkify
        if debug_checkify:
            from jax.experimental import checkify as _checkify

            # No donation: on error the pre-step state must stay alive.
            self._train_step = jax.jit(
                _checkify.checkify(_raw_step, errors=_checkify.float_checks)
            )
        else:
            self._train_step = jax.jit(_raw_step, donate_argnums=(0,))

        # Fused multi-update windows (device-side K-step scan between
        # logging boundaries). The pool path windows too (rotation +
        # bookkeeping once per cfg.pool_rotation_interval updates) and
        # adaptive entropy runs on device (TrainState.ent_state), so the
        # only exclusions are the diagnostic modes: phase profiling,
        # trace capture (per-update spans), checkify.
        self._windows: Dict[int, Any] = {}
        self.use_windows = (
            not profile_phases
            and profile_dir is None
            and not debug_checkify
        )

        # ---- profiling (reference src/profile.rs; perf/* main.rs:1092) --
        self.trace_capture = None
        if profile_dir is not None:
            from burn_ppo_tpu.profile import TraceCapture

            self.trace_capture = TraceCapture(
                profile_dir, start_update=profile_start, num_updates=profile_updates
            )
        self.profile_phases = profile_phases  # pool path stays fused
        self._phase_times: Dict[str, float] = {}
        # Wall-clock of host-side work between device windows (rotation
        # re-stack, record fetch+fold, checkpoint sub-phases) — the
        # series that localizes inter-window stalls.
        self._perf_extra: Dict[str, float] = {}
        self._per_update_time: Optional[float] = None
        if profile_phases:
            # Diagnostic mode: rollout / GAE / update as separate jitted
            # programs so each phase can be fenced and timed, mirroring
            # the reference's perf/rollout_time|gae_time|update_time.
            net, e_, c_, tx_ = self.network, self.env, cfg, self.tx
            normalize_returns = cfg.effective_normalize_returns(self.num_players)
            has_shaping = "shaping_coef" in getattr(e_, "context_fields", ())

            def rollout_fn(state, shaping_coef):
                ctx = {"shaping_coef": shaping_coef} if has_shaping else None
                return collect_rollouts(
                    net, e_, state.params, state.carry, state.obs_norm,
                    state.popart, num_steps=c_.num_steps, gamma=c_.gamma,
                    normalize_returns=normalize_returns,
                    return_clip=c_.return_clip, env_context=ctx,
                )

            def gae_fn(state, carry, batch):
                return _prepare_update(net, e_, c_, state, carry, batch)

            def update_fn(state, carry, obs_norm_new, data, lr, ent_coef):
                return _apply_update(
                    net, c_, tx_, state, carry, obs_norm_new, data, lr, ent_coef
                )

            self._phase_rollout = jax.jit(rollout_fn)
            self._phase_gae = jax.jit(gae_fn)
            self._phase_update = jax.jit(update_fn)
            from burn_ppo_tpu.ppo.episode_stats import summarize_episode_logs

            # Jitted ONCE: a per-update jit(lambda) would re-trace every
            # iteration, polluting the very phase timings this mode reports.
            self._phase_summarize = jax.jit(
                lambda lg: summarize_episode_logs(lg, self.num_players)
            )
            # The unfused phase fns don't fold guard counts into their
            # metrics like the fused step does; compute them separately
            # so runtime_guards stays enforced in diagnostic mode too.
            self._phase_guards = jax.jit(_guard_counts)

        # ---- opponent-pool stack (multiplayer only, main.rs:564-654) ----
        self.pool: Optional[Any] = None
        self.rating_history: Optional[Any] = None
        self.seating = None
        self._pool_windows: Dict[Tuple[int, int], Any] = {}  # (K, W) -> jit
        self._last_num_slots: Optional[int] = None
        self.num_learner_envs = self.num_envs
        if cfg.opponent_pool_fraction > 0.0 and self.num_players > 1:
            # Multi-host pool discipline: every host keeps an identical
            # pool-stats replica driven by globally-synced game records
            # (the device-compacted row buffer is computed from the
            # GLOBAL episode log, so each host fetches identical rows)
            # and a seed-locked sampling rng, so rotations stay in
            # lockstep WITHOUT broadcasting checkpoint names; only
            # host 0 persists stats/ratings/graphs.
            # Requires the run dir on shared storage (standard for pods).
            from burn_ppo_tpu.selfplay.opponent_pool import OpponentPool
            from burn_ppo_tpu.selfplay.rating_history import RatingHistory

            pool_envs = int(round(self.num_envs * cfg.opponent_pool_fraction))
            pool_envs = min(max(pool_envs, 1), self.num_envs - 1) if self.num_envs > 1 else 0
            self.num_learner_envs = self.num_envs - pool_envs
            repl = jax.sharding.NamedSharding(
                self.mesh, jax.sharding.PartitionSpec()
            )
            self.pool = OpponentPool(
                self.run_dir,
                select_alpha=cfg.opponent_select_alpha,
                select_exponent=cfg.opponent_select_exponent,
                max_active=cfg.max_active_opponents,
                seed=self.seed,
                persist=self.is_primary,
                # Single-process device cache only: canonicalize every
                # cached entry onto the training mesh so rotations mixing
                # just-seeded and disk-loaded opponents keep one stacked
                # sharding (no pool-window recompile).
                device_put_fn=(
                    (lambda t: jax.device_put(t, repl))
                    if jax.process_count() == 1
                    else None
                ),
            )
            self.rating_history = RatingHistory.load(self.run_dir)
            # jit: eager create mints several tiny executables (randint/
            # iota/where), each its own compile.
            self.seating = jax.jit(
                lambda k: PoolSeating.create(
                    self.num_envs, self.num_learner_envs, self.num_players,
                    num_slots=1, key=k,
                )
            )(k_seat)
            # Commit seating onto its steady-state placement now (env-
            # indexed leaves sharded over 'data' — what the pool-window
            # jit outputs): the first window would otherwise see
            # uncommitted inputs and compile a second executable beyond
            # the background-warmed one.
            from burn_ppo_tpu.parallel.distributed import global_put
            from burn_ppo_tpu.parallel.mesh import data_sharding

            self.seating = global_put(
                self.seating, lambda _: data_sharding(self.mesh)
            )
        self._last_elo: Dict[str, float] = {}

        self.metrics = (
            MetricsLogger(self.run_dir)
            if self.is_primary
            else MetricsLogger.null()
        )
        # Episode stats reduce on device for every path — pool mode
        # summarizes the learner-env block inside the fused step — so no
        # per-episode host data ever transfers (ppo/episode_stats.py).
        from burn_ppo_tpu.ppo.episode_stats import WindowedEpisodeTracker

        self.tracker = WindowedEpisodeTracker(self.num_players)
        restored = getattr(self, "_restored_recent", [])
        if restored:
            # Display-only seed: keeps avg_return continuous across a
            # resume without polluting length/points/draw series or
            # re-counting episodes (supervisor restarts resume often).
            self.tracker.seed(float(np.mean(restored)), len(restored))
        self.adaptive_entropy = None
        if cfg.adaptive_entropy is not None:
            self.adaptive_entropy = AdaptiveEntropyController(
                cfg.adaptive_entropy, self.env.spec.num_actions,
                cfg.entropy_coef.get(0), cfg.adaptive_entropy_min_coef,
                cfg.adaptive_entropy_max_coef, cfg.adaptive_entropy_delta,
            )
        self.forked_from = forked_from_run or cfg.forked_from

    # ------------------------------------------------------------------
    def _restore(self, ckpt_dir, params, opt_state, obs_norm, popart, carry):
        """Resume: model + optimizer + normalizers + RNG (main.rs:270-414)."""
        from burn_ppo_tpu.checkpoint import load_pytree

        meta = CheckpointManager.load_metadata(ckpt_dir)
        params = load_pytree(ckpt_dir / "model.npz", params)
        opt_state = load_pytree(ckpt_dir / "optimizer.npz", opt_state)
        if obs_norm is not None:
            loaded = CheckpointManager.load_component(
                ckpt_dir, "obs_norm", obs_norm
            )
            if loaded is None:
                # Source checkpoint trained without obs normalization
                # (fork + override can enable it): keep the fresh state
                # rather than silently disabling a feature the config
                # asked for.
                if self.is_primary and not self.quiet:
                    print(
                        f"warning: {ckpt_dir} has no obs_norm.npz; "
                        "normalize_obs starts from fresh statistics"
                    )
            else:
                obs_norm = loaded
        if popart is not None:
            loaded = CheckpointManager.load_component(ckpt_dir, "popart", popart)
            if loaded is None:
                if self.is_primary and not self.quiet:
                    print(
                        f"warning: {ckpt_dir} has no popart.npz; "
                        "normalize_values starts from fresh statistics"
                    )
            else:
                popart = loaded
        ret_norm = CheckpointManager.load_component(
            ckpt_dir, "return_norm", carry.return_norm
        )
        rng = CheckpointManager.load_component(
            ckpt_dir, "rng_state",
            {"update_key": jax.random.PRNGKey(0), "carry_key": jax.random.PRNGKey(0)},
        )
        if ret_norm is not None:
            carry = carry.replace(return_norm=ret_norm)
        # rng_state.npz absent (older/external checkpoint): derive a
        # DISTINCT epoch-shuffle stream. Aliasing update_key = carry.key
        # would make the shuffle permutation key equal the rollout's
        # action-sampling key (threefry children of the same parent).
        update_key = jax.random.fold_in(carry.key, 0x5EED)
        if rng is not None:
            carry = carry.replace(key=rng["carry_key"])
            update_key = rng["update_key"]
        self.global_step = int(meta["step"])
        if meta.get("best_avg_return") is not None:
            self.best_avg_return = float(meta["best_avg_return"])
        self._restored_recent = meta.get("recent_returns", [])
        return params, opt_state, obs_norm, popart, carry, update_key

    # ------------------------------------------------------------------
    def save_checkpoint(self) -> Optional[Path]:
        t0 = time.time()
        out = self._save_checkpoint_inner()
        # Wall spent off the device per checkpoint (fetch+write+rating+
        # graphs) — the series that exposed the per-leaf fetch stalls.
        self._last_elo["perf/checkpoint_time"] = time.time() - t0
        return out

    def _save_checkpoint_inner(self) -> Optional[Path]:
        # Env-sharded leaves (the return normalizer's per-env rolling
        # returns) span processes; host 0 cannot fetch them directly. ALL
        # hosts run one replicating identity-jit (a device all-gather)
        # first — this must precede the primary-only early return or the
        # collective deadlocks.
        return_norm = self.state.carry.return_norm
        if self.multihost:
            return_norm = self._replicate_identity()(return_norm)
        if not self.is_primary:
            # Host-0 owns checkpoint IO, but every host must register the
            # new checkpoint in its pool-stats replica at the SAME update
            # (a fresh entry changes selection weights): the name is
            # deterministic (step_%08d), no broadcast needed. Reads of
            # its params wait on the post-checkpoint barrier (train loop).
            if self.pool is not None:
                self.pool.add_checkpoint(
                    self.ckpt.step_dir(self.global_step).name, self.global_step
                )
            return None
        state = self.state
        aux = {
            "obs_norm": state.obs_norm,
            "popart": state.popart,
            "return_norm": return_norm,
            "rng_state": {
                "update_key": state.update_key,
                "carry_key": state.carry.key,
            },
        }
        exploitability = None
        if self.pool is not None:
            perf = self.pool.get_pool_performance(self._best_ckpt_name())
            exploitability = None if perf is None else 1.0 - perf
        meta = build_metadata(
            step=self.global_step,
            env_name=self.cfg.env,
            network=self.network,
            num_players=self.num_players,
            avg_return=self.tracker.avg_return,
            best_avg_return=(
                None if self.best_avg_return == float("-inf") else self.best_avg_return
            ),
            # Episode stats reduce to window scalars on device (no
            # per-episode host log exists), so recent_returns persists
            # the windowed average repeated for the episode count — what
            # a resume needs to reseed avg_return. A supervisor child
            # may checkpoint before any episode completes; fall back to
            # the resume seed's count so the seeded average survives.
            recent_returns=[self.tracker.avg_return] * min(
                100,
                int(self.tracker.window_count)
                or getattr(self.tracker, "seed_count", 0),
            ),
            forked_from=self.forked_from,
            rng_seed=self.seed,
            normalize_obs=self.cfg.normalize_obs,
            normalize_values=self.cfg.normalize_values,
            exploitability_vs_pool=exploitability,
        )
        t_save0 = time.time()
        path = self.ckpt.save(self.global_step, state.params, state.opt_state, aux, meta)
        self._perf_extra["perf/checkpoint_save_time"] = time.time() - t_save0

        if self.num_players == 1:
            # Single-player best = avg-return-driven (main.rs:659, 1276).
            if self.tracker.avg_return > self.best_avg_return:
                self.best_avg_return = self.tracker.avg_return
                self.ckpt.set_best(self.global_step)
        if self.pool is not None:
            name = path.name
            self.pool.add_checkpoint(name, self.global_step)
            # Seed the opponent device cache from the live state: the
            # first rotation sampling this checkpoint skips the disk
            # read + per-leaf upload (a multi-second cost per new
            # checkpoint through a remote device).
            self.pool.seed_device_cache(name, state.params, state.obs_norm)
            t_rate0 = time.time()
            self.rating_history.on_checkpoint_saved(name, self.global_step)
            snap = self.rating_history.compute()
            self._perf_extra["perf/checkpoint_rating_time"] = (
                time.time() - t_rate0
            )
            self._last_elo = {
                "train/current_elo": snap.current_elo,
                "train/best_elo": snap.best_elo,
                "train/best_step": float(snap.best_step),
                "train/rating_games": float(snap.total_games),
                "train/elo_compute_ms": snap.computation_time_ms,
            }
            # Rating-driven best symlink for multiplayer (main.rs:1348-1353).
            if snap.total_games > 0 and self.ckpt.step_dir(snap.best_step).exists():
                self.ckpt.set_best(snap.best_step)
            t_graph0 = time.time()
            self.rating_history.generate_graph(self.run_dir / "elo_graph.png")
            # Per-checkpoint graph + run-root symlink to the newest one
            # (reference opponent_pool.rs:741-891 writes/links the same).
            if self.pool.generate_selection_graph(
                path / "selection_probability.png"
            ):
                from burn_ppo_tpu.checkpoint import _atomic_symlink

                _atomic_symlink(
                    self.run_dir / "selection_probability.png",
                    str(
                        Path("checkpoints")
                        / path.name
                        / "selection_probability.png"
                    ),
                )
            self._perf_extra["perf/checkpoint_graph_time"] = (
                time.time() - t_graph0
            )
        return path

    def _best_ckpt_name(self) -> Optional[str]:
        best = self.ckpt.resolve("best")
        return best.name if best else None

    # ------------------------------------------------------------------
    def _get_window(self, k: int):
        if k not in self._windows:
            self._windows[k] = jax.jit(
                make_train_window(self.network, self.env, self.cfg, self.tx),
                donate_argnums=(0,),
            )
        return self._windows[k]

    def _window_size(
        self,
        next_log: int,
        next_ckpt: int,
        remaining_seconds: Optional[float] = None,
        per_update_seconds: Optional[float] = None,
    ) -> int:
        """Largest power-of-2 update count that stays within every
        boundary (log, checkpoint, total steps), capped at 64. Power-of-2
        quantization bounds the number of distinct compiles."""
        spu = self.cfg.num_steps * self.num_envs
        room = min(
            next_log - self.global_step,
            next_ckpt - self.global_step,
            self.cfg.total_steps - self.global_step,
        )
        max_updates = max(1, room // spu)
        if remaining_seconds is not None and per_update_seconds:
            # A window is one blocking device call; don't overshoot a
            # --max-training-time budget by more than ~one update.
            max_updates = min(
                max_updates,
                max(1, int(remaining_seconds / per_update_seconds)),
            )
        return largest_pow2_le(max(min(max_updates, 64), 1))

    def _choose_window_k(
        self,
        next_log: int,
        next_ckpt: int,
        max_seconds: Optional[float],
        start_time: float,
        cap: Optional[int] = None,
    ) -> int:
        """Pick this iteration's fused-window size and broadcast it.

        Shared by the pool and non-pool window paths so boundary/schedule
        logic can't drift between them. k derives from host-local timing
        state (wall clocks differ across hosts), so multihost runs must
        broadcast it — every host has to enqueue the same K-step program
        or the job's collectives desynchronize and hang."""
        remaining = None
        if max_seconds is not None:
            remaining = max_seconds - (
                time.time() - start_time + self.elapsed_time_offset
            )
        k = self._window_size(
            next_log, next_ckpt, remaining, self._per_update_time
        )
        if cap is not None:
            k = min(k, cap)
        if self.multihost:
            from burn_ppo_tpu.parallel.distributed import (
                broadcast_from_primary,
            )

            k = int(broadcast_from_primary(np.asarray([k], np.int32))[0])
        return k

    # ------------------------------------------------------------------
    def _replicate_identity(self):
        """Cached identity-jit that replicates its input onto the mesh
        (the device all-gather used before host fetches of non-fully-
        addressable outputs).  Built ONCE: a fresh ``jax.jit(lambda..)``
        per call would retrace + recompile every time (jit caches are
        per function object)."""
        fn = getattr(self, "_repl_identity_fn", None)
        if fn is None:
            repl = jax.sharding.NamedSharding(
                self.mesh, jax.sharding.PartitionSpec()
            )
            fn = jax.jit(lambda t: t, out_shardings=repl)
            self._repl_identity_fn = fn
        return fn

    # ------------------------------------------------------------------
    def _get_pool_window(self, num_slots: int, w: int):
        key = (num_slots, w)
        if key not in self._pool_windows:
            raw = make_pool_train_window(
                self.network, self.env, self.cfg, self.tx,
                self.num_learner_envs, num_slots,
            )
            if self.debug_checkify:
                # --checkify must cover the pool path too (it IS the run
                # once the first checkpoint joins the pool). No donation:
                # on error the pre-step state must stay alive.
                from jax.experimental import checkify as _checkify

                self._pool_windows[key] = jax.jit(
                    _checkify.checkify(raw, errors=_checkify.float_checks)
                )
            else:
                self._pool_windows[key] = jax.jit(raw, donate_argnums=(0, 1))
        return self._pool_windows[key]

    def _start_pool_window_precompile(self):
        """Warm the main pool-window executable in a background thread.
        Returns the Thread (tests join it to assert the warmed entry is
        a real cache hit), or None when the pool path is inactive.

        The pool path only activates after the FIRST checkpoint joins
        the pool, so its (large) program otherwise compiles exactly when
        training is mid-flight — a multi-minute stall. A daemon thread
        runs one dummy window on zeroed state (same shapes/dtypes → same
        executable cache entry; outputs
        discarded) while the pre-pool phase trains. Single-process only:
        one-process dispatch would desync a multi-host job."""
        if (
            self.pool is None
            or not self.use_windows
            or self.multihost
            or self.cfg.opponent_pool_fraction <= 0
        ):
            return
        import threading

        pad_slots = max(self.cfg.max_active_opponents, 1)
        spu = self.cfg.num_steps * self.num_envs
        room = max(
            1, min(self.cfg.log_freq, self.cfg.checkpoint_freq) // spu
        )
        k = largest_pow2_le(
            max(min(max(self.cfg.pool_rotation_interval, 1), 64, room), 1)
        )
        window_fn = self._get_pool_window(pad_slots, k)

        # jit caches executables PER INPUT SHARDING: dummies must carry
        # the live leaves' committed shardings or the warm entry is a
        # cache miss and the first real window still compiles inline.
        def zeros_like_tree(t):
            # np.zeros, not jnp.zeros: eager jnp.zeros compiles one tiny
            # broadcast executable PER SHAPE; device_put of a host buffer
            # never compiles.
            return jax.tree_util.tree_map(
                lambda x: jax.device_put(
                    np.zeros(x.shape, x.dtype), x.sharding
                ),
                t,
            )

        repl = jax.sharding.NamedSharding(
            self.mesh, jax.sharding.PartitionSpec()
        )
        state_z = zeros_like_tree(self.state)
        seat_z = zeros_like_tree(self.seating)
        # Stacked opponents are canonicalized onto the replicated mesh
        # sharding by the pool's device_put_fn — mirror that here.
        opp_z = jax.tree_util.tree_map(
            lambda x: jax.device_put(
                jnp.zeros((pad_slots,) + x.shape, x.dtype), repl
            ),
            self.state.params,
        )
        norm_z = (
            jax.tree_util.tree_map(
                lambda x: jax.device_put(
                    jnp.zeros((pad_slots,) + x.shape, x.dtype), repl
                ),
                self.state.obs_norm,
            )
            if self.state.obs_norm is not None
            else None
        )
        # Schedule vectors/k stay uncommitted, matching the real call's
        # plain jnp.asarray inputs.
        sched_z = jnp.zeros((k,), jnp.float32)

        def warm():
            try:
                window_fn(
                    state_z, seat_z, opp_z, norm_z,
                    sched_z, sched_z, sched_z, jnp.asarray(1, jnp.int32),
                )
            except Exception:
                pass  # warm-up only; the real call will surface errors

        t = threading.Thread(target=warm, daemon=True)
        t.start()
        return t

    def _apply_pool_records(self, rows: np.ndarray, active_names) -> None:
        """Fold globally-identical game records into win-rate queues (all
        hosts, keeps stats replicas in lockstep) and the rating history
        (host 0 only — it owns rating_games.jsonl)."""
        if rows.shape[0] == 0:
            return
        P = self.num_players
        learner_place = rows[:, 0]
        opp_slots = rows[:, 1:P]
        opp_places = rows[:, P : 2 * P - 1]
        self.pool.queue_game_results_batch(
            active_names, learner_place, opp_slots, opp_places
        )
        current = self.rating_history.current_checkpoint
        if not self.is_primary or current is None:
            return
        # Array-native record: no per-game Python on the update path
        # (distinct rows serialize once; comparison expansion is one
        # vectorized pass in RatingHistory).
        self.rating_history.record_games_arrays(
            current, active_names, learner_place, opp_slots, opp_places
        )

    # ------------------------------------------------------------------
    def _phase_timed_step(self, lr, ent_coef, shaping):
        """Diagnostic unfused step: rollout / GAE / update each fenced and
        timed (reference perf/rollout_time|gae_time|update_time,
        main.rs:530-533, 1104-1124)."""

        state = self.state
        t0 = time.time()
        carry, batch, logs = self._phase_rollout(
            state, jnp.asarray(shaping, jnp.float32)
        )
        float(jnp.sum(batch.rewards))
        t1 = time.time()
        obs_norm_new, data = self._phase_gae(state, carry, batch)
        float(jnp.sum(data["advantages"]))
        t2 = time.time()
        new_state, metrics = self._phase_update(
            state, carry, obs_norm_new, data,
            jnp.asarray(lr, jnp.float32), jnp.asarray(ent_coef, jnp.float32),
        )
        float(metrics["policy_loss"])
        t3 = time.time()
        self.state = new_state
        # Windowed tracker consumes device summaries, not raw logs.
        stats = self._phase_summarize(logs)
        self.tracker.ingest(jax.device_get(stats))
        if self.cfg.runtime_guards != "off":
            metrics = dict(metrics)
            metrics.update(self._phase_guards(batch))
        total = max(t3 - t0, 1e-9)
        self._phase_times = {
            "perf/rollout_time": t1 - t0,
            "perf/gae_time": t2 - t1,
            "perf/update_time": t3 - t2,
            "perf/rollout_pct": 100.0 * (t1 - t0) / total,
            "perf/gae_pct": 100.0 * (t2 - t1) / total,
            "perf/update_pct": 100.0 * (t3 - t2) / total,
        }
        return metrics

    # ------------------------------------------------------------------
    def train(self) -> Dict[str, float]:
        cfg = self.cfg
        steps_per_update = cfg.num_steps * self.num_envs
        max_seconds = cfg.max_training_seconds()
        start_time = time.time()
        start_step = self.global_step

        if self.is_primary:
            self.metrics.log_hparams(cfg.to_dict())
            cfg.save_toml(self.run_dir / "config.toml")

        from burn_ppo_tpu.progress import TrainingProgress

        self._start_pool_window_precompile()
        progress = TrainingProgress(
            cfg.total_steps,
            start_step=self.global_step,
            elapsed_offset=self.elapsed_time_offset,
            quiet=self.quiet,
        )
        interrupted = {"flag": False}
        prev_handlers: Dict[int, Any] = {}

        def _on_interrupt(sig, frame):
            interrupted["flag"] = True

        # SIGINT = Ctrl-C (reference ctrlc_handler, main.rs:2027);
        # SIGTERM = preemption notice — same graceful exit: break
        # at the next update boundary, save a final checkpoint, resume
        # later with --resume (the preemption-recovery path, SURVEY §5).
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                prev_handlers[sig] = signal.signal(sig, _on_interrupt)
            except ValueError:
                pass  # non-main thread (tests)

        last_metrics: Dict[str, float] = {}
        next_log = self.global_step + cfg.log_freq
        next_ckpt = self.global_step + cfg.checkpoint_freq
        checkpoints_saved = 0
        hit_checkpoint_cap = False
        update_idx = 0

        try:
            while self.global_step < cfg.total_steps:
                update_idx += 1
                if self.trace_capture is not None:
                    self.trace_capture.on_update_start(update_idx)
                stop = interrupted["flag"] or (
                    max_seconds is not None
                    and time.time() - start_time + self.elapsed_time_offset
                    > max_seconds
                )
                if self.multihost:
                    # Wall clocks (and Ctrl-C) are host-local; host 0's
                    # decision governs so every process leaves the loop
                    # at the same update (divergent exits hang the job).
                    from burn_ppo_tpu.parallel.distributed import (
                        broadcast_from_primary,
                    )

                    stop = bool(
                        broadcast_from_primary(
                            np.asarray([1 if stop else 0], np.int32)
                        )[0]
                    )
                if stop:
                    break

                lr = cfg.learning_rate.get(self.global_step)
                # Adaptive entropy: the coefficient is device state
                # (TrainState.ent_state); the host only evaluates the
                # target schedule. The coefficient actually used comes
                # back in metrics["adaptive_ent_coef"]. The unfused
                # phase-profiling diagnostic keeps the host controller.
                adaptive = self.adaptive_entropy is not None
                if adaptive:
                    ent_target = self.adaptive_entropy.target_entropy(
                        self.global_step
                    )
                    ent_coef = ent_target  # placeholder; resolved below
                else:
                    ent_coef = cfg.entropy_coef.get(self.global_step)
                    ent_target = 0.0

                shaping = cfg.reward_shaping_coef.get(self.global_step)

                def schedule_arrays(k):
                    """Device schedule arrays for a k-update window, plus
                    the LAST host-side values (reading them back from the
                    device arrays would cost a round trip per window)."""
                    offsets = [
                        self.global_step + i * steps_per_update for i in range(k)
                    ]
                    lr_list = [cfg.learning_rate.get(o) for o in offsets]
                    if adaptive:
                        ec_list = [
                            self.adaptive_entropy.target_entropy(o)
                            for o in offsets
                        ]
                    else:
                        ec_list = [cfg.entropy_coef.get(o) for o in offsets]
                    sc_list = [
                        cfg.reward_shaping_coef.get(o) for o in offsets
                    ]
                    return (
                        jnp.asarray(lr_list, jnp.float32),
                        jnp.asarray(ec_list, jnp.float32),
                        jnp.asarray(sc_list, jnp.float32),
                        float(lr_list[-1]),
                        float(ec_list[-1]),
                    )

                t0 = time.time()
                updates_done = 1
                # Which entropy controller actually ran this iteration:
                # every fused path keeps it on device; only the unfused
                # phase-profiling diagnostic drives the host controller.
                # (The pool branch preempts profiling, so keying the
                # readback on profile_phases alone would mislabel
                # pool+profiling runs.)
                host_controller_used = False
                # Stacked-slot axis padded to the config maximum: the
                # pool growing 1 -> max_active opponents then costs zero
                # window recompiles (slot sampling is bounded by the
                # traced active count, so padded slots are never seated).
                pad_slots = max(self.cfg.max_active_opponents, 1)
                t_rot0 = time.time()
                rotation = (
                    self.pool.refresh_rotation(pad_to=pad_slots)
                    if self.pool
                    else None
                )
                if rotation is not None:
                    self._perf_extra["perf/pool_rotation_time"] = (
                        time.time() - t_rot0
                    )
                if rotation is not None:
                    opp_params, opp_norm, active_names = rotation
                    if cfg.debug_opponents and not self.quiet:
                        # Reference --debug-opponents: selection diagnostics
                        # per rotation (opponent_pool.rs logging; e2e.rs:1213).
                        weights = self.pool.selection_weights()
                        total_w = sum(weights.values()) or 1.0
                        parts = []
                        for n in active_names:
                            s = self.pool.stats[n]
                            parts.append(
                                f"{n}(wr={s.win_rate:.2f},"
                                f" p={weights[n] / total_w:.2f})"
                            )
                        print(
                            f"[opponents @ step {self.global_step}] "
                            + " ".join(parts)
                        )
                    K = len(active_names)
                    if self._last_num_slots is not None and K < self._last_num_slots:
                        # Remap stale slots into range after K shrank.
                        # Tracked host-side: fetching seat_opp.max() from
                        # the device would cost a round trip per update.
                        self.seating = self.seating.replace(
                            seat_opp=self.seating.seat_opp % K
                        )
                    self._last_num_slots = K
                    # Rotation interval W: this rotation drives up to W
                    # fused updates in one device window; win-rate/rating
                    # folds run once per window (see make_pool_train_window
                    # and cfg.pool_rotation_interval). Boundaries (log /
                    # checkpoint / total / time budget) still cap the
                    # window like the non-pool path.
                    if self.use_windows:
                        # Quantize the rotation-interval cap to the same
                        # power-of-2 family as _window_size and the
                        # background precompile (see largest_pow2_le).
                        k = self._choose_window_k(
                            next_log, next_ckpt, max_seconds, start_time,
                            cap=largest_pow2_le(
                                max(cfg.pool_rotation_interval, 1)
                            ),
                        )
                    else:
                        k = self._choose_window_k(
                            next_log, next_ckpt, max_seconds, start_time,
                            cap=1,
                        )
                    lrs, ecs, scs, lr_last, ec_last = schedule_arrays(k)
                    t_win0 = time.time()
                    window_fn = self._get_pool_window(pad_slots, k)
                    _pool_out = window_fn(
                        self.state, self.seating, opp_params, opp_norm,
                        lrs, ecs, scs, jnp.asarray(K, jnp.int32),
                    )
                    if self.debug_checkify:
                        _err, _pool_out = _pool_out
                        _err.throw()
                    (
                        self.state, self.seating, metrics, learner_stats,
                        pool_records,
                    ) = _pool_out
                    # The device-compacted record buffer is computed from
                    # the GLOBAL log (XLA inserts the collectives), so
                    # every host fetches the same rows — win-rate folds
                    # stay in lockstep with no Gloo allgather. Non-fully-
                    # addressable outputs need one replicating identity
                    # jit before device_get (as in save_checkpoint).
                    if self.multihost:
                        pool_records = self._replicate_identity()(
                            pool_records
                        )
                    # ONE device transfer for everything the host reads
                    # this window (records + stats + metrics): per-leaf
                    # device_get pays a round trip per scalar.
                    fetched = fetch_tree(
                        {
                            "rec": pool_records,
                            "stats": learner_stats,
                            "metrics": metrics,
                        }
                    )
                    rec = fetched["rec"]
                    metrics = fetched["metrics"]
                    self._perf_extra["perf/pool_window_time"] = (
                        time.time() - t_win0
                    )
                    rows = np.asarray(
                        rec["rows"][: int(rec["count"])], np.int32
                    )
                    t_rec0 = time.time()
                    self._apply_pool_records(rows, active_names)
                    self.pool.apply_pending_updates()
                    self._perf_extra["perf/pool_record_time"] = (
                        time.time() - t_rec0
                    )
                    self.tracker.ingest(fetched["stats"])
                    if self._phase_times:
                        # The pool path preempts the phase-timed
                        # diagnostic step; drop the frozen pre-pool
                        # perf/rollout|gae|update_time values instead of
                        # re-logging them as if they were live.
                        self._phase_times = {}
                    updates_done = k
                    lr = lr_last
                    if adaptive:
                        ent_target = ec_last
                    else:
                        ent_coef = ec_last
                elif self.profile_phases:
                    if adaptive:
                        # Diagnostic mode runs the HOST controller (same
                        # semantics, equivalence-tested) since the phase
                        # fns take a concrete coefficient.
                        ent_coef, ent_target = (
                            self.adaptive_entropy.get_coefficient(
                                self.global_step
                            )
                        )
                        host_controller_used = True
                    metrics = self._phase_timed_step(lr, ent_coef, shaping)
                    updates_done = 1
                elif self.use_windows:
                    k = self._choose_window_k(
                        next_log, next_ckpt, max_seconds, start_time
                    )
                    lrs, ecs, scs, lr_last, ec_last = schedule_arrays(k)
                    self.state, metrics, stats = self._get_window(k)(
                        self.state, lrs, ecs, scs
                    )
                    fetched = fetch_tree({"stats": stats, "metrics": metrics})
                    metrics = fetched["metrics"]
                    self.tracker.ingest(fetched["stats"])
                    updates_done = k
                    # metrics come from the window's LAST update; report
                    # the schedule values that produced them.
                    lr = lr_last
                    if adaptive:
                        ent_target = ec_last
                    else:
                        ent_coef = ec_last
                else:
                    step_args = (
                        self.state,
                        jnp.asarray(lr, jnp.float32),
                        jnp.asarray(
                            ent_target if adaptive else ent_coef, jnp.float32
                        ),
                        jnp.asarray(shaping, jnp.float32),
                    )
                    if self.debug_checkify:
                        err, (self.state, metrics, logs) = self._train_step(
                            *step_args
                        )
                        err.throw()
                    else:
                        self.state, metrics, logs = self._train_step(*step_args)
                    fetched = fetch_tree({"logs": logs, "metrics": metrics})
                    metrics = fetched["metrics"]
                    self.tracker.ingest(fetched["logs"])
                metrics = jax.tree_util.tree_map(float, jax.device_get(metrics))
                self._enforce_guards(metrics)
                step_time = time.time() - t0
                self._per_update_time = step_time / max(updates_done, 1)
                if self.trace_capture is not None:
                    self.trace_capture.on_update_end(update_idx)

                self.global_step += steps_per_update * updates_done
                last_metrics = metrics

                if adaptive:
                    if host_controller_used:
                        # Host-controller mode: close its feedback loop.
                        self.adaptive_entropy.record_entropy(
                            metrics["entropy"]
                        )
                    else:
                        # Fused mode: the coefficient the LAST update in
                        # the window actually used, from device state.
                        ent_coef = metrics["adaptive_ent_coef"]

                if self.global_step >= next_log:
                    next_log = self.global_step + cfg.log_freq
                    sps = steps_per_update * updates_done / max(step_time, 1e-9)
                    self._log_metrics(metrics, lr, ent_coef, ent_target, sps)
                    self._print_progress(progress, metrics, sps)

                if self.global_step >= next_ckpt:
                    next_ckpt = self.global_step + cfg.checkpoint_freq
                    self.save_checkpoint()
                    if self.multihost:
                        # Don't let other hosts read the new checkpoint's
                        # params (next rotation) before host 0 finishes
                        # writing it to shared storage.
                        from burn_ppo_tpu.parallel.distributed import barrier

                        barrier(f"ckpt_{self.global_step}")
                    checkpoints_saved += 1
                    if (
                        self.max_checkpoints_this_run > 0
                        and checkpoints_saved >= self.max_checkpoints_this_run
                    ):
                        # Supervisor reload point (main.rs:1411-1417).
                        hit_checkpoint_cap = True
                        break

            if not hit_checkpoint_cap:
                self.save_checkpoint()
            if interrupted["flag"]:
                progress.finish_interrupted()
            else:
                progress.finish("training complete")
        finally:
            for sig, handler in prev_handlers.items():
                if handler is None:
                    # Previous handler installed outside Python (C ext);
                    # signal.signal(sig, None) would raise TypeError.
                    # The trainer's flag-setting handler stays installed
                    # (its closure is now inert) — warn the embedder.
                    if not self.quiet:
                        print(
                            f"warning: signal {sig} had a non-Python "
                            "handler before training; it was not restored"
                        )
                    continue
                try:
                    signal.signal(sig, handler)
                except ValueError:
                    pass
            if self.trace_capture is not None:
                self.trace_capture.close()
            self.metrics.flush()
            # Multi-process debug hook: EVERY process dumps its pool-
            # stats replica so the dryrun can diff them byte-for-byte
            # (the lockstep invariant says they must be identical; only
            # host 0 normally persists, so a desync would be invisible).
            if self.pool is not None and os.environ.get(
                "BURN_PPO_DUMP_POOL_STATS"
            ):
                pid = jax.process_index()
                (self.run_dir / f"pool_stats_proc{pid}.json").write_text(
                    json.dumps(
                        {
                            "opponents": [
                                s.to_dict() for s in self.pool.stats.values()
                            ]
                        },
                        indent=2,
                        sort_keys=True,
                    )
                )

        elapsed = time.time() - start_time
        total_sps = (self.global_step - start_step) / max(elapsed, 1e-9)
        summary = {
            "final_step": self.global_step,
            "avg_return": self.tracker.avg_return,
            "elapsed_seconds": elapsed,
            "sps": total_sps,
            **{f"train/{k}": v for k, v in last_metrics.items()},
        }
        return summary

    # ------------------------------------------------------------------
    def _enforce_guards(self, metrics: Dict[str, float]) -> None:
        """Surface device-side guard violations within one update.

        The reference fails fast (empty-mask panic utils.rs:115-135;
        finite asserts ppo.rs:363-366); ``runtime_guards = "warn"`` keeps
        training but prints loudly."""
        if metrics.get("pool_record_overflow", 0.0) > 0:
            # Warn-only (never raise): dropped rows bias the win-rate /
            # rating bookkeeping but do not touch the training math.
            import sys

            print(
                f"WARNING: pool record buffer overflowed by "
                f"{int(metrics['pool_record_overflow'])} game(s) at step "
                f"{self.global_step}; win-rate/rating stats missed them "
                "(episodes completing faster than 1 per 8 env-steps)",
                file=sys.stderr,
            )
        if self.cfg.runtime_guards == "off":
            return
        problems = []
        if metrics.get("invalid_mask_count", 0.0) > 0:
            problems.append(
                f"{int(metrics['invalid_mask_count'])} rollout step(s) had "
                "an EMPTY action mask (no legal action) — the env is "
                "producing invalid states and sampled actions are garbage"
            )
        if metrics.get("nonfinite_count", 0.0) > 0:
            problems.append(
                f"{int(metrics['nonfinite_count'])} non-finite "
                "log-prob/value output(s) — NaN/Inf in the forward pass"
            )
        if not problems:
            return
        msg = (
            f"runtime guard tripped at step {self.global_step}:\n  "
            + "\n  ".join(problems)
        )
        if self.cfg.runtime_guards == "raise":
            raise RuntimeError(
                msg + "\n(set runtime_guards = 'warn' to continue anyway)"
            )
        import sys

        print(f"WARNING: {msg}", file=sys.stderr)

    # ------------------------------------------------------------------
    def _log_metrics(self, m, lr, ent_coef, ent_target, sps) -> None:
        """~40 scalar series matching the reference names (main.rs:1026-1223)."""
        if not self.is_primary:
            return
        step = self.global_step
        log = self.metrics.log_scalar
        log("train/policy_loss", m["policy_loss"], step)
        log("train/value_loss", m["value_loss"], step)
        log("train/entropy", m["entropy"], step)
        log("train/entropy_coef", ent_coef, step)
        if self.adaptive_entropy is not None:
            log("train/entropy_target", ent_target, step)
        log("train/approx_kl", m["approx_kl"], step)
        log("train/clip_fraction", m["clip_fraction"], step)
        if "approx_kl_max" in m:
            log("train/approx_kl_max", m["approx_kl_max"], step)
            log("train/clip_fraction_max", m["clip_fraction_max"], step)
        log("train/total_loss", m["total_loss"], step)
        log("train/learning_rate", lr, step)
        log("train/explained_variance", m["explained_variance"], step)
        log("train/value_mean", m["value_mean"], step)
        log("train/returns_mean", m["returns_mean"], step)
        log("train/advantage_mean_raw", m["adv_mean_raw"], step)
        log("train/advantage_std_raw", m["adv_std_raw"], step)
        log("train/value_error_mean", m["value_error_mean"], step)
        log("train/value_error_std", m["value_error_std"], step)
        log("train/minibatch_updates", m["num_minibatch_updates"], step)
        if m.get("avg_valid_actions", 0.0):
            log("train/avg_valid_actions", m["avg_valid_actions"], step)
            log("train/entropy_valid_pct", m["entropy_valid_pct"], step)
        if "value_norm/mean" in m:
            log("value_norm/mean", m["value_norm/mean"], step)
            log("value_norm/std", m["value_norm/std"], step)
        for gk in GUARD_METRIC_KEYS:
            if gk in m:
                log(f"train/{gk}", m[gk], step)
        log("perf/sps", sps, step)
        for name, value in self._phase_times.items():
            log(name, value, step)
        for name, value in self._perf_extra.items():
            log(name, value, step)
        self._perf_extra = {}
        # Host RSS (the reference logs allocator net bytes,
        # main.rs:675-681; long-run soaks watch this series for host-side
        # leaks in pool/rating bookkeeping).
        try:
            with open("/proc/self/statm") as f:
                rss_pages = int(f.read().split()[1])
            import resource

            log("perf/host_rss_mb", rss_pages * 4096 / 2**20, step)
            log(
                "perf/host_rss_peak_mb",
                resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0,
                step,
            )
        except Exception:
            pass
        # Device memory (heap-profiling analog of the reference's
        # stats_alloc net-bytes logging, main.rs:675-681).
        try:
            stats = jax.local_devices()[0].memory_stats() or {}
            if "bytes_in_use" in stats:
                log("perf/device_mb_in_use", stats["bytes_in_use"] / 2**20, step)
            if "peak_bytes_in_use" in stats:
                log("perf/device_mb_peak", stats["peak_bytes_in_use"] / 2**20, step)
        except Exception:
            pass
        for name, value in self._last_elo.items():
            log(name, value, step)
        if self.pool is not None:
            perf = self.pool.get_pool_performance(self._best_ckpt_name())
            if perf is not None:
                log("eval/pool_performance", perf, step)

        tr = self.tracker
        if tr.has_data:
            log("episode/return_mean", tr.avg_return, step)
            log("episode/return_max", tr.return_max, step)
            log("episode/return_min", tr.return_min, step)
            log("episode/length_mean", tr.mean_length, step)
            log("episode/count", float(tr.total_episodes), step)
        if self.num_players > 1 and tr.has_data:
            avg_points = tr.avg_points()
            per_player = tr.per_player_returns()
            for p in range(self.num_players):
                log(f"episode/player_{p}_points", float(avg_points[p]), step)
                log(f"episode/player_{p}_return_mean", float(per_player[p]), step)
            log("episode/draw_rate", tr.draw_rate, step)
        self.metrics.flush()

    def _print_progress(self, progress, m, sps) -> None:
        extra = (
            f"kl {m['approx_kl']:.4f} ent {m['entropy']:.3f} "
            f"ev {m['explained_variance']:.2f}"
        )
        tr = self.tracker
        if self.num_players > 1 and tr.has_data:
            elo = self._last_elo.get("train/current_elo")
            progress.update_multiplayer(
                self.global_step, sps, list(tr.avg_points()), tr.draw_rate,
                elo=elo, extra=extra,
            )
        else:
            progress.update(self.global_step, sps, tr.avg_return, extra=extra)
