"""PPO update: scanned minibatch loop around `jax.value_and_grad`.

Behavioral parity with the reference's `ppo_update` (src/ppo.rs:1661-2112):

  * PopArt stats update + value-head rescale before the epochs
    (ppo.rs:1787-1808);
  * per-epoch shuffle, minibatch loop, per-minibatch advantage
    normalization (ppo.rs:1915-1917);
  * clipped surrogate + optional value clip + entropy bonus
    (ppo.rs:1385-1502);
  * Adam with global-norm gradient clipping (AdamConfig w/ Norm clipping,
    src/main.rs:264-268), applied per minibatch;
  * KL early stop: after a minibatch whose approx_kl exceeds target_kl,
    all remaining minibatches AND epochs are skipped (ppo.rs:2019-2023)
    — implemented with a `stop` flag + `lax.cond` so shapes stay static;
  * metrics averaged over the minibatches actually processed.

Where the reference gathers valid (learner-turn) samples into a smaller
dynamic batch (ppo.rs:1694-1727), we keep the full static-size batch and
weight every reduction by the valid mask — identical math, static shapes,
no host round trip.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from burn_ppo_tpu.models.network import ActorCriticNetwork
from burn_ppo_tpu.ops.categorical import (
    apply_action_mask,
    entropy_from_logp,
    log_prob_from_logp,
)
from burn_ppo_tpu.ops.gae import compute_explained_variance
from burn_ppo_tpu.ppo.normalization import (
    PopArtState,
    popart_normalize,
    popart_rescale_value_head,
    popart_update,
)


@dataclass(frozen=True)
class PPOUpdateConfig:
    clip_epsilon: float = 0.2
    clip_value: bool = False
    value_coef: float = 0.5
    max_grad_norm: float = 0.5
    num_epochs: int = 4
    num_minibatches: int = 4
    target_kl: Optional[float] = None
    adam_epsilon: float = 1e-5
    normalize_values: bool = False  # PopArt
    # Epoch-shuffle granularity: rows are shuffled in tiles of this many
    # consecutive samples. 0 or 1 = exact per-sample shuffle (the
    # reference's semantics); > 1 = tiles (a tile spans adjacent envs at
    # one timestep, so only minibatch co-occurrence changes). On an H100
    # the exact row gather costs 0.27% of the skull-CTDE 4096x64 step
    # against 16-row tiles and is within the run-to-run spread at
    # cartpole 4096x128 (PERF.md), so nothing tiles by default.
    shuffle_block_rows: int = 0


def resolve_shuffle_block(mb_size: int, requested: int) -> int:
    """Largest power-of-2 tile size <= ``requested`` that divides
    mb_size; 1 (exact per-sample shuffle) for ``requested`` <= 1."""
    r = 1
    while r * 2 <= requested and mb_size % (r * 2) == 0:
        r *= 2
    return r


def make_optimizer(cfg: PPOUpdateConfig) -> optax.GradientTransformation:
    """Global-norm clip -> Adam direction. The learning rate is applied
    manually per step so it can be a traced scalar from the schedule
    without retracing."""
    return optax.chain(
        optax.clip_by_global_norm(cfg.max_grad_norm),
        optax.scale_by_adam(eps=cfg.adam_epsilon),
    )


def _wmean(x: jax.Array, w: jax.Array) -> jax.Array:
    return jnp.sum(x * w) / jnp.maximum(jnp.sum(w), 1e-8)


def _wstd(x: jax.Array, w: jax.Array) -> jax.Array:
    """Bessel-corrected (sample) std over valid rows: the reference's
    normalize_advantages and stats use Burn's var(0), which divides by
    n-1 (utils.rs:86); population std would shrink every normalized
    advantage by sqrt((n-1)/n)."""
    m = _wmean(x, w)
    n = jnp.sum(w)
    ss = jnp.sum(jnp.square(x - m) * w)
    return jnp.sqrt(ss / jnp.maximum(n - 1.0, 1.0))


METRIC_KEYS = (
    "policy_loss",
    "value_loss",
    "entropy",
    "approx_kl",
    "clip_fraction",
    "total_loss",
    "value_mean",
    "returns_mean",
    "adv_mean_raw",
    "adv_std_raw",
    "value_error_mean",
    "value_error_std",
    "avg_valid_actions",
    "entropy_valid_pct",
)


def _minibatch_loss(
    params,
    network: ActorCriticNetwork,
    mb: Dict[str, jax.Array],
    popart: Optional[PopArtState],
    ent_coef: jax.Array,
    cfg: PPOUpdateConfig,
):
    """Scalar loss + metric aux for one minibatch (ppo.rs:1385-1502)."""
    w = mb["valid"]
    logits, values = network.policy_and_value(
        params, mb["obs"], mb.get("privileged_obs")
    )

    mask = mb.get("action_masks")
    masked_logits = apply_action_mask(logits, mask)
    # ONE log_softmax shared by the log-prob selection and the entropy
    # (log_prob_categorical + entropy_categorical would each compute it).
    logp = jax.nn.log_softmax(masked_logits, axis=-1)
    new_log_probs = log_prob_from_logp(logp, mb["actions"])
    entropy = entropy_from_logp(logp)

    log_ratio = new_log_probs - mb["old_log_probs"]
    ratio = jnp.exp(log_ratio)

    # Per-minibatch advantage normalization over valid samples.
    adv = mb["advantages"]
    adv_mean = _wmean(adv, w)
    adv_std = _wstd(adv, w)
    adv_n = (adv - adv_mean) / (adv_std + 1e-8)

    # Clipped surrogate: max(-A*r, -A*clip(r)).
    pl1 = -adv_n * ratio
    pl2 = -adv_n * jnp.clip(ratio, 1.0 - cfg.clip_epsilon, 1.0 + cfg.clip_epsilon)
    policy_loss = _wmean(jnp.maximum(pl1, pl2), w)

    # Value loss on the PopArt-normalized scale when enabled.
    returns = mb["returns"]
    old_values = mb["old_values"]
    if popart is not None:
        returns = popart_normalize(popart, returns)
        old_values = popart_normalize(popart, old_values)
    if cfg.clip_value:
        v_clipped = old_values + jnp.clip(
            values - old_values, -cfg.clip_epsilon, cfg.clip_epsilon
        )
        vl = jnp.maximum(
            jnp.square(values - returns), jnp.square(v_clipped - returns)
        )
        value_loss = 0.5 * _wmean(vl, w)
    else:
        value_loss = 0.5 * _wmean(jnp.square(values - returns), w)

    entropy_mean = _wmean(entropy, w)
    loss = policy_loss + value_loss * cfg.value_coef - entropy_mean * ent_coef

    # ---- metrics (ppo.rs:1510-1594) ----------------------------------
    approx_kl = _wmean((ratio - 1.0) - log_ratio, w)
    clip_fraction = _wmean(
        (jnp.abs(ratio - 1.0) > cfg.clip_epsilon).astype(jnp.float32), w
    )
    value_errors = jnp.abs(values - returns)
    aux = {
        "policy_loss": policy_loss,
        "value_loss": value_loss,
        "entropy": entropy_mean,
        "approx_kl": approx_kl,
        "clip_fraction": clip_fraction,
        "total_loss": loss,
        "value_mean": _wmean(values, w),
        "returns_mean": _wmean(returns, w),
        "adv_mean_raw": adv_mean,
        "adv_std_raw": adv_std,
        "value_error_mean": _wmean(value_errors, w),
        "value_error_std": _wstd(value_errors, w),
    }
    if mask is not None:
        valid_counts = jnp.sum(mask, axis=-1)
        aux["avg_valid_actions"] = _wmean(valid_counts, w)
        has_choice = (valid_counts > 1.0).astype(jnp.float32) * w
        max_ent = jnp.log(jnp.maximum(valid_counts, 1.0 + 1e-8))
        aux["entropy_valid_pct"] = jnp.sum(
            entropy / jnp.maximum(max_ent, 1e-8) * has_choice
        ) / jnp.maximum(jnp.sum(has_choice), 1e-8)
    else:
        aux["avg_valid_actions"] = jnp.zeros(())
        aux["entropy_valid_pct"] = jnp.zeros(())
    return loss, aux


def ppo_update(
    network: ActorCriticNetwork,
    tx: optax.GradientTransformation,
    params: Any,
    opt_state: Any,
    data: Dict[str, jax.Array],
    popart: Optional[PopArtState],
    key: jax.Array,
    lr: jax.Array,
    ent_coef: jax.Array,
    cfg: PPOUpdateConfig,
    may_have_invalid: bool = False,
) -> Tuple[Any, Any, Optional[PopArtState], Dict[str, jax.Array]]:
    """Run num_epochs x num_minibatches PPO on flattened rollout data.

    ``data`` fields are [N, ...]: obs (already normalized), actions,
    old_log_probs, advantages, returns, old_values, valid, and optionally
    privileged_obs / action_masks.  Returns (params, opt_state, popart,
    metrics).
    """
    N = data["actions"].shape[0]
    nmb = cfg.num_minibatches
    mb_size = N // nmb
    if mb_size == 0:
        raise ValueError(f"batch size {N} < num_minibatches {nmb}")

    # ---- PopArt: update stats on raw returns, rescale value head ------
    new_popart = popart
    if popart is not None:
        new_popart, old_mean, old_std = popart_update(
            popart, data["returns"], data["valid"]
        )
        kernel, bias = network.get_value_head(params)
        kernel, bias = popart_rescale_value_head(
            kernel,
            bias,
            old_mean,
            old_std,
            new_popart.mean,
            new_popart.std,
            do_rescale=new_popart.initialized,
        )
        params = network.with_value_head(params, kernel, bias)

    # ---- pack all per-sample fields into ONE [N, C] buffer -------------
    # Seven separate column gathers per epoch shuffle collapse into one
    # wide row gather.  Semantics are identical to the reference's
    # per-epoch index shuffle (ppo.rs:1815-1816).
    has_priv = "privileged_obs" in data and data["privileged_obs"] is not None
    has_masks = "action_masks" in data and data["action_masks"] is not None

    segments = [("obs", data["obs"].shape[1])]
    if has_priv:
        segments.append(("privileged_obs", data["privileged_obs"].shape[1]))
    if has_masks:
        segments.append(("action_masks", data["action_masks"].shape[1]))
    scalar_fields = (
        "old_log_probs",
        "advantages",
        "returns",
        "old_values",
        "valid",
    )
    parts = [data[name].astype(jnp.float32) for name, _ in segments]
    parts.append(
        jax.lax.bitcast_convert_type(
            data["actions"].astype(jnp.int32), jnp.float32
        )[:, None]
    )
    parts.extend(data[f].astype(jnp.float32)[:, None] for f in scalar_fields)
    packed = jnp.concatenate(parts, axis=1)  # [N, C]
    C = packed.shape[1]

    def unpack(mb2d: jax.Array) -> Dict[str, jax.Array]:
        mb: Dict[str, jax.Array] = {}
        off = 0
        for name, width in segments:
            mb[name] = mb2d[:, off : off + width]
            off += width
        mb["actions"] = jax.lax.bitcast_convert_type(mb2d[:, off], jnp.int32)
        off += 1
        for f in scalar_fields:
            mb[f] = mb2d[:, off]
            off += 1
        return mb

    zero_metrics = {k: jnp.zeros(()) for k in METRIC_KEYS}
    grad_fn = jax.value_and_grad(_minibatch_loss, has_aux=True)

    # Uneven-split padding statics (padding itself happens below): when
    # the pad row count reaches mb_size, a shuffled minibatch can be ALL
    # pad rows — running it would step Adam on stale momentum with zero
    # grads and dilute the metric averages with a zero-sum entry, so
    # mb_body must skip such minibatches.  Statically gated: pad <
    # mb_size guarantees >=1 real row per minibatch and the guard (and
    # its lax.cond) compiles away for evenly-divisible configs.
    # ``may_have_invalid`` forces the guard on for callers whose valid
    # column carries real zeros (pool training: only learner turns are
    # valid, pool_rollout.py:254) — there a shuffled minibatch can be
    # all-invalid even with zero padding, the analog of a zero-length
    # minibatch the reference's valid-index filtering makes impossible.
    if N % nmb != 0:
        mb_size = -(-N // nmb)
        pad = nmb * mb_size - N
    else:
        pad = 0
    can_be_all_pad = pad >= mb_size or may_have_invalid

    def mb_body(carry, mb2d):
        params, opt_state, stop, sums, count = carry
        skip_now = stop
        if can_be_all_pad:
            # valid flag is the last packed column.
            skip_now = stop | (jnp.sum(mb2d[:, C - 1]) <= 0.0)

        def run(operand):
            params, opt_state, sums, count = operand
            mb = unpack(mb2d)
            (loss, aux), grads = grad_fn(
                params, network, mb, new_popart, ent_coef, cfg
            )
            updates, new_opt = tx.update(grads, opt_state, params)
            new_params = jax.tree_util.tree_map(
                lambda p, u: p - lr * u, params, updates
            )
            new_sums = {k: sums[k] + aux[k] for k in METRIC_KEYS}
            return new_params, new_opt, new_sums, count + 1.0, aux["approx_kl"]

        if cfg.target_kl is None and not can_be_all_pad:
            # No early stop or empty-minibatch skip possible — drop the
            # cond wrapper entirely so XLA can fuse across the body.
            params, opt_state, sums, count, _kl = run(
                (params, opt_state, sums, count)
            )
            return (params, opt_state, stop, sums, count), None

        def skip(operand):
            params, opt_state, sums, count = operand
            return params, opt_state, sums, count, jnp.zeros(())

        params, opt_state, sums, count, kl = jax.lax.cond(
            skip_now, skip, run, (params, opt_state, sums, count)
        )
        if cfg.target_kl is not None:
            stop = stop | (kl > cfg.target_kl)
        return (params, opt_state, stop, sums, count), None

    if pad:
        # Uneven-split parity (ppo.rs:1811-1831): the reference uses
        # EVERY sample each epoch, splitting N into minibatches whose
        # sizes differ by <=1. Static shapes can't vary per minibatch, so
        # pad up to nmb*ceil(N/nmb) with wrapped copies of real rows
        # whose valid flag (last packed column) is zeroed — every loss /
        # metric reduction is already valid-weighted, so a minibatch
        # averages over exactly its real samples, same as the reference's
        # shorter minibatch. Pad rows copy real rows (not zeros) so
        # action masks / observations stay well-formed.  (mb_size / pad
        # themselves are computed above mb_body, which also guards the
        # pad >= mb_size all-pad-minibatch case.)
        pad_rows = packed[:pad].at[:, C - 1].set(0.0)
        packed = jnp.concatenate([packed, pad_rows], axis=0)
    R = resolve_shuffle_block(mb_size, cfg.shuffle_block_rows)
    num_blocks = (nmb * mb_size) // R
    packed_tiled = packed[: nmb * mb_size].reshape(num_blocks, R * C)

    epoch_keys = jax.random.split(key, cfg.num_epochs)
    carry = (params, opt_state, jnp.zeros((), jnp.bool_), zero_metrics, jnp.zeros(()))
    for e in range(cfg.num_epochs):
        # Each epoch reshuffles (fresh permutation, one tiled row gather);
        # the whole epoch — gather included — is skipped once KL early
        # stop has triggered (ppo.rs:2019-2023 breaks the epoch loop).
        def run_epoch(carry, ekey=epoch_keys[e]):
            perm = jax.random.permutation(ekey, num_blocks)
            shuffled = packed_tiled[perm].reshape(nmb, mb_size, C)
            return jax.lax.scan(mb_body, carry, shuffled)[0]

        if cfg.target_kl is None:
            carry = run_epoch(carry)
            continue

        def skip_epoch(carry):
            return carry

        carry = jax.lax.cond(carry[2], skip_epoch, run_epoch, carry)
    params, opt_state, _stop, sums, count = carry

    denom = jnp.maximum(count, 1.0)
    metrics = {k: sums[k] / denom for k in METRIC_KEYS}
    metrics["num_minibatch_updates"] = count
    # Explained variance over valid samples, on the raw (denormalized)
    # scale, using pre-update values (ppo.rs:2030-2059).
    metrics["explained_variance"] = compute_explained_variance(
        data["old_values"], data["returns"], data["valid"]
    )
    return params, opt_state, new_popart, metrics
