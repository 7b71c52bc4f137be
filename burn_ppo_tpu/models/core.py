"""Minimal functional NN primitives.

Parameters are plain pytrees (nested dicts / lists of dicts).  This keeps
the framework free to do the things PPO self-play needs that module
systems make awkward:

  * PopArt value-head surgery (rescale kernel/bias in place while Adam
    moments survive untouched — the reference preserves Burn ParamIds for
    the same reason, src/ppo.rs:1599-1653);
  * stacking K opponent checkpoints' parameters along a leading axis and
    `vmap`-ing one forward over all of them during vs-pool rollouts.

All matmuls go through `dense`, which optionally casts to a compute dtype
(bf16) while keeping parameters and outputs in f32.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import jax
import jax.numpy as jnp

from burn_ppo_tpu.ops.initializers import orthogonal

Params = Any  # nested dict pytree


def dense_init(key, in_dim: int, out_dim: int, gain: float) -> Dict[str, jax.Array]:
    """Orthogonal kernel + zero bias (reference src/network/mlp.rs:16-38)."""
    return {
        "kernel": orthogonal(key, (in_dim, out_dim), gain=gain),
        "bias": jnp.zeros((out_dim,), dtype=jnp.float32),
    }


def dense(params: Dict[str, jax.Array], x: jax.Array, compute_dtype=None) -> jax.Array:
    kernel, bias = params["kernel"], params["bias"]
    if compute_dtype is not None and x.dtype != compute_dtype:
        x = x.astype(compute_dtype)
        kernel = kernel.astype(compute_dtype)
    y = jnp.dot(x, kernel, preferred_element_type=jnp.float32)
    return y + bias


def conv_init(key, kh: int, kw: int, in_ch: int, out_ch: int, gain: float = 1.0):
    """Orthogonal conv kernel in HWIO layout + zero bias."""
    return {
        "kernel": orthogonal(key, (kh, kw, in_ch, out_ch), gain=gain),
        "bias": jnp.zeros((out_ch,), dtype=jnp.float32),
    }


def conv2d_same(params, x: jax.Array, compute_dtype=None) -> jax.Array:
    """Stride-1, SAME-padded 2D convolution in NHWC.

    The reference permutes to NCHW for Burn (src/network/cnn.rs:234-262);
    the obs already arrive channels-last, so we stay NHWC and let XLA
    pick the convolution layout.
    """
    kernel, bias = params["kernel"], params["bias"]
    if compute_dtype is not None and x.dtype != compute_dtype:
        x = x.astype(compute_dtype)
        kernel = kernel.astype(compute_dtype)
    y = jax.lax.conv_general_dilated(
        x,
        kernel,
        window_strides=(1, 1),
        padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32,
    )
    return y + bias


def activation_fn(name: str):
    if name == "relu":
        return jax.nn.relu
    if name == "tanh":
        return jnp.tanh
    raise ValueError(f"Unknown activation '{name}' (expected 'relu' or 'tanh')")


def mlp_stack_init(key, in_dim: int, hidden: int, n_layers: int, gain: float) -> List:
    keys = jax.random.split(key, max(n_layers, 1))
    layers = []
    size = in_dim
    for i in range(n_layers):
        layers.append(dense_init(keys[i], size, hidden, gain))
        size = hidden
    return layers


def mlp_stack_apply(layers: List, x: jax.Array, act, compute_dtype=None) -> jax.Array:
    for layer in layers:
        x = act(dense(layer, x, compute_dtype))
    return x
