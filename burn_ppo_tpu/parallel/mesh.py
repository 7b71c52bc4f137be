"""Device mesh + sharding layout for multi-chip data parallelism.

The reference is strictly single-process / single-device (SURVEY.md §2
note; no collectives anywhere). This module supplies the scale-out axis
this build adds: a 1-D ``data`` mesh over which environments and
rollout data are sharded while parameters stay replicated.

Design: the train step is written as a *global-view* program; we place
env-state pytrees with a `NamedSharding(P("data"))` on their leading
(env) dimension and let GSPMD insert the collectives — the Welford
normalizer merges and gradient reductions become `psum`s (all-reduces
over NVLink on a GPU host) automatically. No hand-written collective calls are needed in the hot
path (the "pick a mesh, annotate shardings, let XLA do the rest" recipe).
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def make_mesh(num_devices: int = 0, devices=None) -> Mesh:
    """1-D data-parallel mesh. ``num_devices`` 0 => all local devices.

    Requesting more devices than exist is an ERROR, not a silent clamp:
    a run sized for an 8-wide mesh landing on 1 device (e.g. the GPU
    runtime failed to load) should fail loudly, not train at 1/8
    throughput with mis-sized shards."""
    if devices is None:
        devices = jax.devices()
    if num_devices and num_devices > 0:
        if num_devices > len(devices):
            raise ValueError(
                f"make_mesh: {num_devices} devices requested but only "
                f"{len(devices)} available ({[str(d) for d in devices]})"
            )
        devices = devices[:num_devices]
    return Mesh(np.array(devices), (DATA_AXIS,))


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (env/batch) dimension across the data axis."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_rollout_carry(carry, mesh: Mesh):
    """Place a RolloutCarry: env-indexed leaves sharded over 'data',
    scalar normalizer stats and keys replicated.

    Goes through ``distributed.global_put`` so the same code builds
    globally-sharded arrays in multi-host runs (plain device_put onto a
    global sharding only works single-process)."""
    from burn_ppo_tpu.parallel.distributed import global_put

    shard = data_sharding(mesh)
    repl = replicated_sharding(mesh)

    def place_env_indexed(tree):
        return global_put(tree, lambda _: shard)

    ret_norm = carry.return_norm
    return carry.replace(
        env_states=place_env_indexed(carry.env_states),
        episode_acc=place_env_indexed(carry.episode_acc),
        last_value_per_player=place_env_indexed(carry.last_value_per_player),
        return_norm=ret_norm.replace(
            returns=place_env_indexed(ret_norm.returns),
            mean=global_put(ret_norm.mean, lambda _: repl),
            m2=global_put(ret_norm.m2, lambda _: repl),
            count=global_put(ret_norm.count, lambda _: repl),
        ),
        key=global_put(carry.key, lambda _: repl),
    )


def replicate(tree: Any, mesh: Mesh) -> Any:
    from burn_ppo_tpu.parallel.distributed import global_put

    repl = replicated_sharding(mesh)
    return global_put(tree, lambda _: repl)
