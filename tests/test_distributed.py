"""Multi-host helper tests (single-process paths + shard reassembly).

The reference has no distributed layer (SURVEY.md §2: no collectives);
these cover the scale-out helpers this build adds. True multi-process
behavior can't run here; what can is: single-process equivalences, and
shard reassembly logic against a multi-device CPU mesh.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from burn_ppo_tpu.parallel import distributed as dist
from burn_ppo_tpu.parallel.mesh import make_mesh, replicate, shard_rollout_carry


def test_single_process_defaults():
    assert dist.process_count() == 1
    assert dist.is_primary()


def test_maybe_initialize_noop(monkeypatch):
    monkeypatch.delenv("BURN_PPO_COORDINATOR", raising=False)
    monkeypatch.delenv("BURN_PPO_MULTIHOST", raising=False)
    assert dist.maybe_initialize() is False


def test_maybe_initialize_env_coordinator(monkeypatch):
    calls = {}

    def fake_init(coordinator_address=None, num_processes=None, process_id=None):
        calls.update(
            addr=coordinator_address, n=num_processes, pid=process_id
        )

    monkeypatch.setattr(jax.distributed, "initialize", fake_init)
    monkeypatch.setenv("XLA_FLAGS", "")
    monkeypatch.setenv("BURN_PPO_COORDINATOR", "10.0.0.1:1234")
    monkeypatch.setenv("BURN_PPO_NUM_PROCESSES", "4")
    monkeypatch.setenv("BURN_PPO_PROCESS_ID", "2")
    assert dist.maybe_initialize() is True
    assert calls == {"addr": "10.0.0.1:1234", "n": 4, "pid": 2}


def test_maybe_initialize_force(monkeypatch):
    called = []
    monkeypatch.setattr(jax.distributed, "initialize", lambda: called.append(1))
    monkeypatch.setenv("XLA_FLAGS", "")
    monkeypatch.delenv("BURN_PPO_COORDINATOR", raising=False)
    assert dist.maybe_initialize(force=True) is True
    assert called == [1]


@pytest.mark.parametrize("before,after", [
    (None, "--xla_gpu_shard_autotuning=false"),
    ("--xla_force_host_platform_device_count=4",
     "--xla_force_host_platform_device_count=4 "
     "--xla_gpu_shard_autotuning=false"),
    ("--xla_gpu_shard_autotuning=true", "--xla_gpu_shard_autotuning=true"),
])
def test_multiprocess_init_autotunes_per_process(monkeypatch, before, after):
    """A multi-process run turns XLA's sharded GPU autotuning off before
    the backend starts, keeping other flags and an explicit choice."""
    monkeypatch.setattr(jax.distributed, "initialize", lambda **kw: None)
    monkeypatch.setenv("BURN_PPO_COORDINATOR", "localhost:1234")
    if before is None:
        monkeypatch.delenv("XLA_FLAGS", raising=False)
    else:
        monkeypatch.setenv("XLA_FLAGS", before)
    assert dist.maybe_initialize() is True
    assert os.environ["XLA_FLAGS"] == after


def test_single_process_leaves_xla_flags_alone(monkeypatch):
    monkeypatch.delenv("BURN_PPO_COORDINATOR", raising=False)
    monkeypatch.delenv("BURN_PPO_MULTIHOST", raising=False)
    monkeypatch.setenv("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    assert dist.maybe_initialize() is False
    assert os.environ["XLA_FLAGS"] == "--xla_force_host_platform_device_count=8"


def test_global_put_single_process():
    mesh = make_mesh()
    sharding = NamedSharding(mesh, P("data"))
    x = np.arange(16, dtype=np.float32)
    arr = dist.global_put(x, lambda _: sharding)
    assert isinstance(arr, jax.Array)
    np.testing.assert_array_equal(np.asarray(arr), x)


def test_global_put_multiprocess_path(monkeypatch):
    """Exercise the make_array_from_callback branch by faking 2 processes."""
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    mesh = make_mesh()
    sharding = NamedSharding(mesh, P("data"))
    x = np.arange(32, dtype=np.float32).reshape(8, 4)
    arr = dist.global_put(x, lambda _: sharding)
    np.testing.assert_array_equal(np.asarray(arr), x)


def test_host_local_slice_single_process():
    x = jnp.arange(12.0).reshape(3, 4)
    out = dist.host_local_slice(x, axis=1)
    np.testing.assert_array_equal(out, np.arange(12.0).reshape(3, 4))


def test_host_local_slice_sharded_axis1(monkeypatch):
    """With a data-sharded axis-1 array, local shards reassemble in order
    and replicated copies dedup (fake multi-process to hit the path)."""
    mesh = make_mesh()
    n_dev = mesh.devices.size
    x = jnp.arange(2 * 8 * n_dev, dtype=jnp.float32).reshape(2, 8 * n_dev)
    xs = jax.device_put(x, NamedSharding(mesh, P(None, "data")))
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    out = dist.host_local_slice(xs, axis=1)
    np.testing.assert_array_equal(out, np.asarray(x))


def test_host_local_slice_replicated_dedup(monkeypatch):
    mesh = make_mesh()
    x = jnp.arange(6.0)
    xr = jax.device_put(x, NamedSharding(mesh, P()))
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    out = dist.host_local_slice(xr, axis=0)
    np.testing.assert_array_equal(out, np.arange(6.0))


def test_all_hosts_mean_single():
    assert dist.all_hosts_mean(3.5) == 3.5


def test_shard_rollout_carry_multiprocess_path(monkeypatch):
    """shard_rollout_carry builds global arrays through global_put."""
    from burn_ppo_tpu.envs import make_env
    from burn_ppo_tpu.ppo.rollout import init_rollout_carry

    env = make_env("cartpole")
    carry = init_rollout_carry(env, 16, jax.random.PRNGKey(0))
    host_copy = jax.device_get(carry.last_value_per_player)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    mesh = make_mesh()
    placed = shard_rollout_carry(carry, mesh)
    np.testing.assert_array_equal(
        np.asarray(placed.last_value_per_player), host_copy
    )


def test_host_local_slice_cross_axis_sharding_rejected(monkeypatch):
    """Shards partitioned along a different axis than requested must fail
    loudly instead of silently dropping or duplicating data."""
    mesh = make_mesh()
    n_dev = mesh.devices.size
    x = jnp.arange(8 * n_dev * 2, dtype=jnp.float32).reshape(8 * n_dev, 2)
    xs = jax.device_put(x, NamedSharding(mesh, P("data", None)))
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="another dimension"):
        dist.host_local_slice(xs, axis=1)


def test_broadcast_from_primary_single_process_identity():
    import numpy as np

    v = np.asarray([3, 7], np.int32)
    out = dist.broadcast_from_primary(v)
    np.testing.assert_array_equal(out, v)


def test_barrier_single_process_noop():
    dist.barrier("test")  # must not raise or block


def test_allgather_rows_reshapes_flat_input():
    import numpy as np

    flat = np.arange(6, dtype=np.int64)  # wrong dtype + flat on purpose
    out = dist.allgather_rows(flat, 3)
    assert out.dtype == np.int32
    assert out.shape == (2, 3)


def test_make_mesh_rejects_overrequest():
    """Requesting more devices than exist must fail loudly, not silently
    clamp to a narrower mesh (mis-sized shards at 1/N throughput)."""
    import pytest

    from burn_ppo_tpu.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="requested"):
        make_mesh(len(jax.devices()) + 1)


def test_broadcast_from_primary_int64_coercion(monkeypatch):
    """Multihost transport canonicalizes int64 -> int32 (x64 off). The
    helper must coerce losslessly and restore the caller's dtype — or
    raise loudly when the value cannot survive the round trip."""
    from jax.experimental import multihost_utils

    monkeypatch.setattr(jax, "process_count", lambda: 2)
    seen = {}

    def fake_broadcast(arr):
        seen["dtype"] = np.asarray(arr).dtype
        return np.asarray(arr)

    monkeypatch.setattr(multihost_utils, "broadcast_one_to_all", fake_broadcast)

    out = dist.broadcast_from_primary(np.asarray([12345], np.int64))
    assert seen["dtype"] == np.int32  # transport-safe payload
    assert out.dtype == np.int64 and out[0] == 12345

    with pytest.raises(ValueError, match="int32 range"):
        dist.broadcast_from_primary(np.asarray([2**31 + 7], np.int64))
