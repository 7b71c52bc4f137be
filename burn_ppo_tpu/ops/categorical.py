"""Masked-categorical primitives: sampling, log-prob, entropy.

Device notes: all ops are pure elementwise/reduction kernels that XLA fuses
into the surrounding network forward pass; masking is additive with a
large-but-finite negative constant (the reference uses the same trick in
its loss path, src/ppo.rs:1437-1441) so every intermediate stays finite
in bf16/f32 and `p * log p` of a masked-out action is exactly 0.

Behavioral parity with reference src/utils.rs:
  * sample_categorical — Gumbel-max sampling (utils.rs:10-31).
  * log_prob_categorical — log-softmax gather (utils.rs:38-45).
  * entropy_categorical — H = -sum p log p from one log-softmax
    (utils.rs:52-58).
  * apply_action_mask — invalid logits -> -inf equivalent (utils.rs:96-135).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Large negative additive mask. exp(-1e9) == 0.0 in f32, so masked actions
# get exactly zero probability, while arithmetic on the logit stays finite.
MASK_NEG = -1.0e9


def apply_action_mask(logits: jax.Array, mask: jax.Array | None) -> jax.Array:
    """Additively mask invalid actions.

    ``mask``: float (1.0 = valid) or bool, broadcastable to ``logits``.
    """
    if mask is None:
        return logits
    valid = mask.astype(jnp.bool_) if mask.dtype != jnp.bool_ else mask
    return logits + jnp.where(valid, 0.0, MASK_NEG).astype(logits.dtype)


def masked_log_softmax(logits: jax.Array, mask: jax.Array | None) -> jax.Array:
    """Log-softmax over the last axis after applying an action mask."""
    return jax.nn.log_softmax(apply_action_mask(logits, mask), axis=-1)


def sample_categorical(key: jax.Array, logits: jax.Array) -> jax.Array:
    """Gumbel-max categorical sample over the last axis -> int32 indices."""
    return jax.random.categorical(key, logits, axis=-1).astype(jnp.int32)


def log_prob_from_logp(logp: jax.Array, actions: jax.Array) -> jax.Array:
    """Select log pi(a|s) from a precomputed log-softmax.

    The selection is a one-hot contraction, not take_along_axis: the
    A-wide multiply-sum fuses into the surrounding elementwise pass
    instead of a separate per-row gather over every update sample.
    ``where()`` keeps -inf-masked rows finite: (-inf * 0.0) would be NaN.
    """
    onehot = jax.nn.one_hot(actions, logp.shape[-1], dtype=logp.dtype)
    return jnp.sum(jnp.where(onehot > 0, logp, 0.0), axis=-1)


def entropy_from_logp(logp: jax.Array) -> jax.Array:
    """Entropy per row from a precomputed log-softmax.

    Probabilities are derived from the log-softmax (single pass), matching
    the reference optimization (utils.rs:52-58). Masked actions contribute
    exactly 0 because p == 0.0 there and ``where`` removes the -inf-like
    log term. Callers that need BOTH the log-prob and the entropy share
    one log_softmax by pairing this with ``log_prob_from_logp``.
    """
    p = jnp.exp(logp)
    return -jnp.sum(jnp.where(p > 0, p * logp, 0.0), axis=-1)


def log_prob_categorical(logits: jax.Array, actions: jax.Array) -> jax.Array:
    """log pi(a|s) for taken actions. logits [..., A], actions [...] int."""
    return log_prob_from_logp(jax.nn.log_softmax(logits, axis=-1), actions)


def entropy_categorical(logits: jax.Array) -> jax.Array:
    """Entropy of the categorical distribution per row."""
    return entropy_from_logp(jax.nn.log_softmax(logits, axis=-1))


def sample_with_temperature(
    key: jax.Array, logits: jax.Array, temperature: jax.Array | float
) -> jax.Array:
    """Temperature sampling with argmax at temperature 0.

    Mirrors eval-time sampling semantics (reference src/eval.rs:223-272):
    temp == 0 -> greedy argmax; otherwise sample from softmax(logits/temp).
    ``temperature`` may be a traced scalar, so both branches are computed
    and selected (cheap: one extra argmax).

    Greedy ties break toward the LAST maximal index: the reference's
    ``Iterator::max_by`` (eval.rs:242-246) keeps the later of equal
    elements, while ``jnp.argmax`` keeps the first — so the argmax runs
    over the reversed axis. (The reference's sum==0 first-valid fallback
    at eval.rs:255-258 is unreachable: with at least one finite masked
    logit the max term contributes exp(0)=1, and an all-masked row goes
    down a NaN path to the LAST index instead. All-masked rows are
    game-logic violations the runtime guards flag; here the additive
    -1e9 mask absorbs any |logit| < 64 in f32 (ulp at 1e9), so such rows
    tie -> last index at temp 0 / ~uniform at temp>0, except that a
    pathological |logit| >= 64 survives rounding and wins.)
    """
    temperature = jnp.asarray(temperature, dtype=logits.dtype)
    if temperature.ndim == logits.ndim - 1:
        temperature = temperature[..., None]  # per-row temperatures
    safe_t = jnp.maximum(temperature, 1e-8)
    sampled = jax.random.categorical(key, logits / safe_t, axis=-1)
    greedy = logits.shape[-1] - 1 - jnp.argmax(logits[..., ::-1], axis=-1)
    temp_rows = temperature[..., 0] if temperature.ndim == logits.ndim else temperature
    return jnp.where(temp_rows <= 0.0, greedy, sampled).astype(jnp.int32)
