"""Running normalizers as pure pytree states.

Three normalizers with behavioral parity to the reference
(src/normalization.rs):

  * ObsNormState     — per-dimension running mean/var (Welford), clip,
                       identity until 2 samples (normalization.rs:12-102).
                       Updated *lagged*: stats advance once per rollout
                       with the raw batch, normalization during the
                       rollout uses the previous stats.
  * ReturnNormState  — per-env-per-player rolling discounted returns;
                       rewards divided by sqrt(running var of returns),
                       variance-only, clipped (normalization.rs:115-260).
  * PopArtState      — scalar mean/std of value targets with value-head
                       rescaling (van Hasselt et al. 2016;
                       normalization.rs:275-366, head rescale
                       src/ppo.rs:1599-1653).

All updates use Chan's parallel Welford merge, which is mathematically
identical to the reference's sequential Welford over the same batch, but
runs as one fused reduction on device. The return normalizer goes one
step further: the reference normalizes env e with stats updated through
env e *within* the batch, so its per-env sequence is reproduced exactly
with an inclusive associative_scan of the merge (see return_norm_step).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from burn_ppo_tpu import struct


def _welford_merge(mean_a, m2_a, count_a, mean_b, m2_b, count_b):
    """Merge two Welford accumulators (Chan et al.)."""
    total = count_a + count_b
    safe_total = jnp.maximum(total, 1.0)
    delta = mean_b - mean_a
    mean = mean_a + delta * (count_b / safe_total)
    m2 = m2_a + m2_b + jnp.square(delta) * (count_a * count_b / safe_total)
    keep = count_b > 0
    return (
        jnp.where(keep, mean, mean_a),
        jnp.where(keep, m2, m2_a),
        jnp.where(keep, total, count_a),
    )


# ---------------------------------------------------------------------------
# Observation normalizer
# ---------------------------------------------------------------------------
class ObsNormState(struct.PyTreeNode):
    mean: jax.Array  # f64-as-f32[D]
    m2: jax.Array  # [D]
    count: jax.Array  # scalar

    @staticmethod
    def create(obs_dim: int) -> "ObsNormState":
        return ObsNormState(
            mean=jnp.zeros((obs_dim,), jnp.float32),
            m2=jnp.zeros((obs_dim,), jnp.float32),
            count=jnp.zeros((), jnp.float32),
        )


def obs_norm_update(state: ObsNormState, batch: jax.Array) -> ObsNormState:
    """Merge a raw obs batch [..., D] into the running stats."""
    flat = batch.reshape(-1, batch.shape[-1])
    n = jnp.asarray(flat.shape[0], jnp.float32)
    mean_b = jnp.mean(flat, axis=0)
    m2_b = jnp.sum(jnp.square(flat - mean_b), axis=0)
    mean, m2, count = _welford_merge(state.mean, state.m2, state.count, mean_b, m2_b, n)
    return ObsNormState(mean=mean, m2=m2, count=count)


def obs_norm_apply(state: ObsNormState, obs: jax.Array, clip: float = 10.0) -> jax.Array:
    """Normalize obs [..., D]; identity until count >= 2 (normalization.rs:178)."""
    var = state.m2 / jnp.maximum(state.count, 1.0)
    std = jnp.maximum(jnp.sqrt(var), 1e-8)
    normalized = jnp.clip((obs - state.mean) / std, -clip, clip)
    return jnp.where(state.count < 2.0, obs, normalized)


# ---------------------------------------------------------------------------
# Return (reward) normalizer
# ---------------------------------------------------------------------------
class ReturnNormState(struct.PyTreeNode):
    returns: jax.Array  # [E, P] rolling discounted returns per player
    mean: jax.Array  # scalar Welford mean of observed rolling returns
    m2: jax.Array  # scalar Welford M2
    count: jax.Array  # scalar

    @staticmethod
    def create(num_envs: int, num_players: int) -> "ReturnNormState":
        return ReturnNormState(
            returns=jnp.zeros((num_envs, num_players), jnp.float32),
            mean=jnp.zeros((), jnp.float32),
            m2=jnp.zeros((), jnp.float32),
            count=jnp.zeros((), jnp.float32),
        )


def return_norm_roll(
    returns: jax.Array,  # [E, P] rolling discounted returns
    rewards: jax.Array,  # [E] acting player's raw rewards this step
    acting: jax.Array,  # [E] int player indices
    dones: jax.Array,  # [E] bool / float
    gamma: float,
) -> Tuple[jax.Array, jax.Array]:
    """Elementwise half of the reference's per-step sequence — the part
    that must stay inside the rollout scan (the rolling return is carried
    state): update_return, capture the post-update sample, reset the
    acting player on done (normalization.rs:163-215).

    Returns (new_returns [E, P], samples [E]). The Welford-stats +
    normalize half runs once per rollout in ``return_norm_finalize`` —
    the policy never consumes normalized rewards, only GAE does, after
    the rollout, so there is no reason to pay per-step reduction kernels
    inside the scan.
    """
    P = returns.shape[-1]
    dones = dones.astype(jnp.bool_)
    onehot = jax.nn.one_hot(acting, P, dtype=returns.dtype)
    # returns[e, acting] = returns[e, acting] * gamma + reward
    updated = returns * (1.0 - onehot) + (
        returns * gamma + rewards[:, None]
    ) * onehot
    samples = jnp.sum(updated * onehot, axis=-1)  # [E]
    # Reset the acting player's rolling return on done (after capture).
    updated = jnp.where(dones[:, None], updated * (1.0 - onehot), updated)
    return updated, samples


def return_norm_finalize(
    state: ReturnNormState,
    samples: jax.Array,  # [..., E] post-update rolling-return samples
    rewards: jax.Array,  # [..., E] raw acting-player rewards
    clip: float = 10.0,
    valid: Optional[jax.Array] = None,  # [..., E] learner-turn stats mask
) -> Tuple[ReturnNormState, jax.Array]:
    """Prefix-Welford stats + normalization for a whole rollout in ONE
    fused pass.

    The reference updates its GLOBAL Welford accumulator one env at a
    time (step-major, env index order — src/ppo.rs:390-408) and
    normalizes each reward with stats that INCLUDE its own sample
    (normalization.rs:177-201). Flattening [T, E] row-major reproduces
    that exact visitation order, and the running stats at every position
    come from inclusive prefix sums in shifted coordinates
    (u = x - batch mean, the standard stable closed form). A whole-batch
    Chan merge would instead normalize everything by end-of-batch stats
    — divergent early in a fresh run, where the reference's count<2
    guard visibly passes the first samples through unnormalized.

    ``state.returns`` passes through untouched (it was advanced by
    ``return_norm_roll`` inside the scan). Returns
    (state with updated mean/m2/count, normalized rewards like
    ``rewards``).
    """
    shape = rewards.shape
    x = samples.reshape(-1)
    r = rewards.reshape(-1)
    n = x.shape[0]
    if valid is None:
        w = None
        n_valid = jnp.asarray(float(n), jnp.float32)
        count_e = state.count + jnp.arange(1, n + 1, dtype=jnp.float32)
        shift = jnp.sum(x) / n_valid
        u = x - shift
        s_e = jnp.cumsum(u)
        q_e = jnp.cumsum(jnp.square(u))
    else:
        w = valid.reshape(-1).astype(jnp.float32)
        n_valid = jnp.sum(w)
        count_e = state.count + jnp.cumsum(w)
        shift = jnp.sum(x * w) / jnp.maximum(n_valid, 1.0)
        u = x - shift
        s_e = jnp.cumsum(w * u)
        q_e = jnp.cumsum(w * jnp.square(u))
    safe_c = jnp.maximum(count_e, 1.0)
    base_u = state.mean - shift
    mean_u_e = (state.count * base_u + s_e) / safe_c
    m2_e = (
        state.m2
        + state.count * jnp.square(base_u)
        + q_e
        - count_e * jnp.square(mean_u_e)
    )
    m2_e = jnp.maximum(m2_e, 0.0)  # tiny negatives from rounding

    # Normalize each position with its own post-update prefix stats
    # (variance-only, clipped; identity until that prefix has 2 samples).
    std = jnp.sqrt(m2_e / safe_c + 1e-8)
    normalized = jnp.clip(r / std, -clip, clip)
    normalized = jnp.where(count_e < 2.0, r, normalized)

    # An all-invalid batch must leave the accumulator EXACTLY unchanged
    # (the shift/unshift roundtrip would otherwise perturb it by an ulp).
    any_valid = n_valid > 0.0
    return (
        state.replace(
            mean=jnp.where(any_valid, mean_u_e[-1] + shift, state.mean),
            m2=jnp.where(any_valid, m2_e[-1], state.m2),
            count=jnp.where(any_valid, count_e[-1], state.count),
        ),
        normalized.reshape(shape),
    )


def return_norm_step(
    state: ReturnNormState,
    rewards: jax.Array,  # [E] acting player's raw rewards this step
    acting: jax.Array,  # [E] int player indices
    dones: jax.Array,  # [E] bool / float
    gamma: float,
    clip: float = 10.0,
    valid: Optional[jax.Array] = None,  # [E] learner-turn mask for stats
) -> Tuple[ReturnNormState, jax.Array]:
    """One full step of the reference's per-step sequence
    (normalization.rs:163-215 + src/ppo.rs:390-408):

      update_return -> update_variance_stats (valid turns) -> normalize
      -> reset acting player's rolling return on done.

    Composition of ``return_norm_roll`` + ``return_norm_finalize`` on a
    single step — the rollout scans call the two halves separately so
    the stats/normalize reductions run once per rollout, not per step.

    Returns (new_state, normalized_rewards [E]).
    """
    updated, samples = return_norm_roll(
        state.returns, rewards, acting, dones, gamma
    )
    new_state, normalized = return_norm_finalize(
        state, samples, rewards, clip, valid=valid
    )
    return new_state.replace(returns=updated), normalized


# ---------------------------------------------------------------------------
# PopArt value normalizer
# ---------------------------------------------------------------------------
POPART_EPS = 1e-4


class PopArtState(struct.PyTreeNode):
    mean: jax.Array
    m2: jax.Array
    count: jax.Array

    @staticmethod
    def create() -> "PopArtState":
        return PopArtState(
            mean=jnp.zeros((), jnp.float32),
            m2=jnp.zeros((), jnp.float32),
            count=jnp.zeros((), jnp.float32),
        )

    @property
    def std(self) -> jax.Array:
        """1.0 before 2 samples (normalization.rs:313-320)."""
        s = jnp.sqrt(self.m2 / jnp.maximum(self.count, 1.0) + POPART_EPS)
        return jnp.where(self.count < 2.0, 1.0, s)

    @property
    def initialized(self) -> jax.Array:
        return self.count >= 2.0


def popart_update(
    state: PopArtState, returns: jax.Array, mask: Optional[jax.Array] = None
) -> Tuple[PopArtState, jax.Array, jax.Array]:
    """Merge a batch of raw returns; gives (new_state, old_mean, old_std)."""
    old_mean, old_std = state.mean, state.std
    flat = returns.reshape(-1)
    if mask is None:
        w = jnp.ones_like(flat)
    else:
        w = mask.reshape(-1).astype(flat.dtype)
    n = jnp.sum(w)
    mean_b = jnp.sum(flat * w) / jnp.maximum(n, 1.0)
    m2_b = jnp.sum(jnp.square(flat - mean_b) * w)
    mean, m2, count = _welford_merge(state.mean, state.m2, state.count, mean_b, m2_b, n)
    return PopArtState(mean=mean, m2=m2, count=count), old_mean, old_std


def popart_normalize(state: PopArtState, x: jax.Array) -> jax.Array:
    return jnp.where(state.initialized, (x - state.mean) / state.std, x)


def popart_denormalize(state: PopArtState, x: jax.Array) -> jax.Array:
    return jnp.where(state.initialized, x * state.std + state.mean, x)


def popart_rescale_value_head(
    kernel: jax.Array,
    bias: jax.Array,
    old_mean: jax.Array,
    old_std: jax.Array,
    new_mean: jax.Array,
    new_std: jax.Array,
    do_rescale: jax.Array,
) -> Tuple[jax.Array, jax.Array]:
    """W' = W * s_old/s_new ; b' = (b*s_old + mu_old - mu_new)/s_new.

    Preserves denormalized outputs across a stats shift
    (reference src/ppo.rs:1599-1653). ``do_rescale`` gates the update so
    the head is untouched until the normalizer is initialized.
    """
    new_kernel = kernel * (old_std / new_std)
    new_bias = (bias * old_std + old_mean - new_mean) / new_std
    return (
        jnp.where(do_rescale, new_kernel, kernel),
        jnp.where(do_rescale, new_bias, bias),
    )
