"""Unified actor-critic network: MLP / CNN / CTDE.

Mirrors the reference's `ActorCriticNetwork` enum (src/network/mod.rs:28-35)
as a static-config object whose `init`/`forward*` methods are pure
functions over a parameter pytree.  The same apply functions serve
training (inside `jit`/`value_and_grad`), rollouts, evaluation, and
stacked-opponent `vmap`s.

Architectures (behavioral parity, file:line cites to the reference):
  * MLP  — shared backbone or split actor/critic towers; orthogonal init
    with gains sqrt(2)/1.0 hidden, 0.01 policy head, 1.0 value head
    (src/network/mlp.rs:46-206).
  * CNN  — stride-1 SAME conv stack over the spatial slice of the obs,
    flatten, concat extra features, FC stack, heads
    (src/network/cnn.rs:23-300). NHWC (no NCHW permute).
  * CTDE — MAPPO-style: actor(obs) -> logits; critic(concat(priv, obs))
    -> value, with independent critic width/depth
    (src/network/ctde.rs:26-183).

The value head always outputs a single scalar (acting player's value).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp

from burn_ppo_tpu.models.core import (
    activation_fn,
    conv2d_same,
    conv_init,
    dense,
    dense_init,
    mlp_stack_apply,
    mlp_stack_init,
)
from burn_ppo_tpu.ops.initializers import (
    POLICY_HEAD_GAIN,
    VALUE_HEAD_GAIN,
    hidden_gain,
)

Params = Any


@dataclass(frozen=True)
class ActorCriticNetwork:
    """Static network description + pure init/apply functions."""

    network_type: str  # "mlp" | "cnn" | "ctde"
    obs_dim: int
    action_count: int
    hidden_size: int = 64
    num_hidden: int = 2
    activation: str = "tanh"
    split_networks: bool = False
    # CTDE
    privileged_obs_dim: Optional[int] = None
    critic_hidden_size: Optional[int] = None
    critic_num_hidden: Optional[int] = None
    # CNN
    obs_shape: Optional[Tuple[int, int, int]] = None  # (H, W, C)
    num_conv_layers: int = 2
    conv_channels: Tuple[int, ...] = (8, 8)
    kernel_size: int = 3
    cnn_fc_hidden_size: int = 32
    cnn_num_fc_layers: int = 1
    # numeric
    compute_dtype: Optional[str] = None  # None => f32; "bfloat16" matmuls

    # ------------------------------------------------------------------
    @property
    def is_ctde(self) -> bool:
        return self.network_type == "ctde"

    @property
    def _cdtype(self):
        return jnp.bfloat16 if self.compute_dtype == "bfloat16" else None

    def _act(self):
        return activation_fn(self.activation)

    def _conv_channels(self, i: int) -> int:
        """Channel count for conv layer i, repeating the last entry
        (reference src/network/cnn.rs get_channels closure)."""
        if i < len(self.conv_channels):
            return int(self.conv_channels[i])
        return int(self.conv_channels[-1]) if self.conv_channels else 64

    # ------------------------------------------------------------------
    def init(self, key: jax.Array) -> Params:
        gain = hidden_gain(self.activation)
        if self.network_type == "mlp":
            k_trunk, k_critic, k_pi, k_v = jax.random.split(key, 4)
            params = {
                "layers": mlp_stack_init(
                    k_trunk, self.obs_dim, self.hidden_size, self.num_hidden, gain
                ),
                "policy_head": dense_init(
                    k_pi, self.hidden_size, self.action_count, POLICY_HEAD_GAIN
                ),
                "value_head": dense_init(
                    k_v, self.hidden_size, 1, VALUE_HEAD_GAIN
                ),
            }
            if self.split_networks:
                params["critic_layers"] = mlp_stack_init(
                    k_critic, self.obs_dim, self.hidden_size, self.num_hidden, gain
                )
            return params

        if self.network_type == "cnn":
            if self.obs_shape is None:
                raise ValueError("CNN requires obs_shape (H, W, C)")
            if self.num_conv_layers < 1:
                # fc_in below is sized from the final conv's channels;
                # with zero convs the forward flattens raw input channels
                # instead — fail here, not at an opaque trace-time
                # dot_general shape mismatch.
                raise ValueError("CNN requires num_conv_layers >= 1")
            h, w, c = self.obs_shape
            keys = jax.random.split(key, 6)
            final_ch = self._conv_channels(max(self.num_conv_layers - 1, 0))
            fc_in = h * w * final_ch + (self.obs_dim - h * w * c)

            # Conv activations are ALWAYS relu (reference cnn.rs:214
            # applies relu unconditionally; only the FC stack follows the
            # configured activation, cnn.rs:226), so conv kernels get the
            # relu gain sqrt(2) regardless of config.activation.
            conv_gain = hidden_gain("relu")

            def conv_stack(k):
                ks = jax.random.split(k, max(self.num_conv_layers, 1))
                layers, in_ch = [], c
                for i in range(self.num_conv_layers):
                    out_ch = self._conv_channels(i)
                    layers.append(
                        conv_init(ks[i], self.kernel_size, self.kernel_size, in_ch, out_ch, conv_gain)
                    )
                    in_ch = out_ch
                return layers

            params = {
                "conv_layers": conv_stack(keys[0]),
                "fc_layers": mlp_stack_init(
                    keys[1], fc_in, self.cnn_fc_hidden_size, self.cnn_num_fc_layers, gain
                ),
                "policy_head": dense_init(
                    keys[4], self.cnn_fc_hidden_size, self.action_count, POLICY_HEAD_GAIN
                ),
                "value_head": dense_init(
                    keys[5], self.cnn_fc_hidden_size, 1, VALUE_HEAD_GAIN
                ),
            }
            if self.split_networks:
                params["critic_conv_layers"] = conv_stack(keys[2])
                params["critic_fc_layers"] = mlp_stack_init(
                    keys[3], fc_in, self.cnn_fc_hidden_size, self.cnn_num_fc_layers, gain
                )
            return params

        if self.network_type == "ctde":
            if self.privileged_obs_dim is None:
                raise ValueError("CTDE requires privileged_obs_dim")
            ch = self.critic_hidden_size or self.hidden_size
            cn = self.critic_num_hidden or self.num_hidden
            k_a, k_c, k_pi, k_v = jax.random.split(key, 4)
            return {
                "actor_layers": mlp_stack_init(
                    k_a, self.obs_dim, self.hidden_size, self.num_hidden, gain
                ),
                "policy_head": dense_init(
                    k_pi, self.hidden_size, self.action_count, POLICY_HEAD_GAIN
                ),
                "critic_layers": mlp_stack_init(
                    k_c, self.privileged_obs_dim + self.obs_dim, ch, cn, gain
                ),
                "value_head": dense_init(k_v, ch, 1, VALUE_HEAD_GAIN),
            }

        raise ValueError(f"Unknown network_type '{self.network_type}'")

    # ------------------------------------------------------------------
    def _cnn_features(self, params, obs, conv_key: str, fc_key: str) -> jax.Array:
        h, w, c = self.obs_shape
        spatial_size = h * w * c
        batch = obs.shape[0]
        spatial = obs[:, :spatial_size].reshape(batch, h, w, c)
        x = spatial
        for layer in params[conv_key]:
            x = jax.nn.relu(conv2d_same(layer, x, self._cdtype))
        x = x.reshape(batch, -1)
        if self.obs_dim > spatial_size:
            x = jnp.concatenate([x, obs[:, spatial_size:]], axis=1)
        return mlp_stack_apply(params[fc_key], x, self._act(), self._cdtype)

    def forward(self, params: Params, obs: jax.Array) -> Tuple[jax.Array, jax.Array]:
        """obs [B, obs_dim] -> (logits [B, A], values [B]).

        Panics for CTDE (use forward_actor/forward_critic), matching the
        reference (src/network/mod.rs:93-114).
        """
        if self.network_type == "mlp":
            act, cd = self._act(), self._cdtype
            ax = mlp_stack_apply(params["layers"], obs, act, cd)
            logits = dense(params["policy_head"], ax, cd)
            if self.split_networks:
                cx = mlp_stack_apply(params["critic_layers"], obs, act, cd)
            else:
                cx = ax
            values = dense(params["value_head"], cx, cd)[:, 0]
            return logits, values
        if self.network_type == "cnn":
            cd = self._cdtype
            ax = self._cnn_features(params, obs, "conv_layers", "fc_layers")
            logits = dense(params["policy_head"], ax, cd)
            if self.split_networks:
                cx = self._cnn_features(
                    params, obs, "critic_conv_layers", "critic_fc_layers"
                )
            else:
                cx = ax
            values = dense(params["value_head"], cx, cd)[:, 0]
            return logits, values
        raise ValueError("forward() not supported for CTDE; use forward_actor/critic")

    def forward_actor(self, params: Params, obs: jax.Array) -> jax.Array:
        if self.network_type == "ctde":
            x = mlp_stack_apply(
                params["actor_layers"], obs, self._act(), self._cdtype
            )
            return dense(params["policy_head"], x, self._cdtype)
        return self.forward(params, obs)[0]

    def forward_critic(
        self, params: Params, privileged_obs: jax.Array, obs: jax.Array
    ) -> jax.Array:
        """CTDE critic: (priv, obs) concat -> value [B]."""
        if self.network_type == "ctde":
            x = jnp.concatenate([privileged_obs, obs], axis=1)
            x = mlp_stack_apply(params["critic_layers"], x, self._act(), self._cdtype)
            return dense(params["value_head"], x, self._cdtype)[:, 0]
        return self.forward(params, obs)[1]

    def policy_and_value(
        self, params: Params, obs: jax.Array, privileged_obs: Optional[jax.Array]
    ) -> Tuple[jax.Array, jax.Array]:
        """Dispatch helper used by rollout/update code paths."""
        if self.is_ctde:
            logits = self.forward_actor(params, obs)
            values = self.forward_critic(params, privileged_obs, obs)
            return logits, values
        return self.forward(params, obs)

    # --- PopArt value-head access (reference src/network/mod.rs:157-184) --
    @staticmethod
    def get_value_head(params: Params):
        return params["value_head"]["kernel"], params["value_head"]["bias"]

    @staticmethod
    def with_value_head(params: Params, kernel: jax.Array, bias: jax.Array) -> Params:
        out = dict(params)
        out["value_head"] = {"kernel": kernel, "bias": bias}
        return out


def make_network(
    env_spec,
    *,
    network_type: str = "mlp",
    hidden_size: int = 64,
    num_hidden: int = 2,
    activation: str = "tanh",
    split_networks: bool = False,
    critic_hidden_size: Optional[int] = None,
    critic_num_hidden: Optional[int] = None,
    num_conv_layers: int = 2,
    conv_channels=(8, 8),
    kernel_size: int = 3,
    cnn_fc_hidden_size: int = 32,
    cnn_num_fc_layers: int = 1,
    compute_dtype: Optional[str] = None,
) -> ActorCriticNetwork:
    """Build a network description from an environment spec + config knobs."""
    return ActorCriticNetwork(
        network_type=network_type,
        obs_dim=env_spec.obs_dim,
        action_count=env_spec.num_actions,
        hidden_size=hidden_size,
        num_hidden=num_hidden,
        activation=activation,
        split_networks=split_networks,
        privileged_obs_dim=env_spec.privileged_obs_dim,
        critic_hidden_size=critic_hidden_size,
        critic_num_hidden=critic_num_hidden,
        obs_shape=env_spec.obs_shape,
        num_conv_layers=num_conv_layers,
        conv_channels=tuple(conv_channels),
        kernel_size=kernel_size,
        cnn_fc_hidden_size=cnn_fc_hidden_size,
        cnn_num_fc_layers=cnn_num_fc_layers,
        compute_dtype=compute_dtype,
    )
