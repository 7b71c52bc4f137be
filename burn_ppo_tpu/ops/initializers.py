"""Parameter initializers.

Orthogonal initialization with per-layer gains, matching the reference's
network init discipline (src/network/mlp.rs:16-38): hidden layers use gain
sqrt(2) for relu / 1.0 for tanh, the policy head 0.01, the value head 1.0,
and all biases start at zero.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp


def orthogonal(key: jax.Array, shape: tuple, gain: float = 1.0, dtype=jnp.float32):
    """Orthogonal init for a 2D weight of ``shape`` (in_dim, out_dim).

    For >2D shapes (conv kernels), all leading dims are flattened into the
    input dimension, matching common practice.
    """
    if len(shape) < 2:
        raise ValueError("orthogonal init requires >= 2 dimensions")
    # math.prod, not jnp: this is a compile-time host constant, and every
    # eager jnp op here is a device round trip.
    n_rows = math.prod(shape[:-1])
    n_cols = shape[-1]
    flat_shape = (max(n_rows, n_cols), min(n_rows, n_cols))
    a = jax.random.normal(key, flat_shape, dtype=jnp.float32)
    q, r = jnp.linalg.qr(a)
    # Sign correction makes the distribution uniform over orthogonal mats.
    q = q * jnp.sign(jnp.diagonal(r))
    if n_rows < n_cols:
        q = q.T
    return (gain * q.reshape(shape)).astype(dtype)


def hidden_gain(activation: str) -> float:
    """Gain for hidden layers by activation (mlp.rs:84: sqrt(2) relu, 1.0 tanh)."""
    return math.sqrt(2.0) if activation == "relu" else 1.0


POLICY_HEAD_GAIN = 0.01
VALUE_HEAD_GAIN = 1.0
