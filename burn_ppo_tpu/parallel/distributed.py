"""Multi-host (multi-process) support.

The reference is single-process (SURVEY.md §2 note: no collectives, no
process groups anywhere); this module supplies the scale-out layer this
build adds on top of its feature set (SURVEY.md §5 "distributed
communication backend"):

  * ``maybe_initialize()`` — ``jax.distributed.initialize`` from explicit
    args or the standard env vars; a no-op in single-process runs.
    ``jax.distributed.initialize()`` without arguments auto-detects only
    cluster managers it knows (SLURM, Open MPI); elsewhere, e.g. several
    processes on one GPU host, pass the coordinator explicitly.
  * ``is_primary()`` — process 0 owns logging, checkpoints, graphs and
    stdout; other hosts compute silently (host-0 logging discipline).
  * ``global_put(tree, sharding_fn)`` — build globally-sharded arrays
    from host-local data with ``jax.make_array_from_callback`` (plain
    ``device_put`` onto a global sharding only works single-process).
  * ``host_local_slice(x)`` — the addressable shard block of a globally
    sharded array, for per-host episode bookkeeping without pulling the
    full global array across hosts.

Gradient/normalizer reductions need no code here: the train step is a
global-view jit program, so GSPMD inserts the cross-device psums (NCCL
on GPUs, Gloo on CPU processes) from the sharding annotations alone.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Optional

import jax
import numpy as np


def maybe_initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    force: bool = False,
) -> bool:
    """Initialize jax.distributed when configured; returns True if so.

    Configuration sources, in priority order: explicit args, the
    ``BURN_PPO_COORDINATOR`` / ``BURN_PPO_NUM_PROCESSES`` /
    ``BURN_PPO_PROCESS_ID`` env vars, then JAX's own auto-detection
    (SLURM / Open MPI) when ``BURN_PPO_MULTIHOST=1`` or ``force``.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "BURN_PPO_COORDINATOR"
    )
    if num_processes is None and "BURN_PPO_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["BURN_PPO_NUM_PROCESSES"])
    if process_id is None and "BURN_PPO_PROCESS_ID" in os.environ:
        process_id = int(os.environ["BURN_PPO_PROCESS_ID"])
    if coordinator_address is not None or force or (
        os.environ.get("BURN_PPO_MULTIHOST") == "1"
    ):
        _autotune_per_process()

    if coordinator_address is not None:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        return True
    if force or os.environ.get("BURN_PPO_MULTIHOST") == "1":
        jax.distributed.initialize()  # cluster-manager auto-detection
        return True
    return False


def _autotune_per_process() -> None:
    """Each process autotunes its own GPU programs. XLA's sharded
    autotuning (processes split the GEMM autotuning and swap results
    through the coordinator) crashed in the post-layout HLO passes when
    four one-card H100 processes compiled the trainer's window. Must run
    before the first backend use, which reads ``XLA_FLAGS``."""
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_gpu_shard_autotuning" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_gpu_shard_autotuning=false"
        ).strip()


def process_count() -> int:
    return jax.process_count()


def is_primary() -> bool:
    """Host-0 check: owns metrics, checkpoints, graphs, progress bar."""
    return jax.process_index() == 0


def global_put(tree: Any, sharding_for_leaf: Callable[[Any], jax.sharding.Sharding]):
    """Place host-local leaves onto (possibly multi-host) global shardings.

    Single-process this is plain ``device_put``.  Multi-process, each
    host holds the SAME logical global value (envs are initialized from
    the same seed and partitioned by the sharding), and
    ``make_array_from_callback`` hands every device its slice.
    """
    single = jax.process_count() == 1

    def place(x):
        sharding = sharding_for_leaf(x)
        if single:
            return jax.device_put(x, sharding)
        arr = np.asarray(x)
        return jax.make_array_from_callback(
            arr.shape, sharding, lambda idx: arr[idx]
        )

    return jax.tree_util.tree_map(place, tree)


def host_local_slice(x: jax.Array, axis: int = 0) -> np.ndarray:
    """Concatenate this process's addressable shards along ``axis``.

    For a ``P("data")``-sharded array this is the host's env block
    (episode logs [T, E, ...] shard on axis 1); replicated arrays come
    back whole. Utility for host-local views without cross-host pulls; the
    production logging path instead reduces on device and fetches one
    packed buffer (checkpoint.fetch_tree), so this currently has only
    test callers.
    """
    if jax.process_count() == 1:
        return np.asarray(jax.device_get(x))

    def start_of(s):
        if not s.index or axis >= len(s.index):
            return 0
        return s.index[axis].start or 0

    def region_of(s):
        # Full index tuple: two shards are duplicates only if they cover
        # the SAME region in every dimension (dedup by one axis' start
        # would drop shards split along another axis).
        if not s.index:
            return ()
        return tuple((sl.start, sl.stop) for sl in s.index)

    def off_axis_region(s):
        if not s.index:
            return ()
        return tuple(
            (sl.start, sl.stop) for d, sl in enumerate(s.index) if d != axis
        )

    shards = sorted(x.addressable_shards, key=start_of)
    seen = set()
    parts = []
    off_axis = set()
    for s in shards:
        region = region_of(s)
        if region in seen:
            continue  # replicated across local devices
        seen.add(region)
        off_axis.add(off_axis_region(s))
        parts.append(np.asarray(s.data))
    if len(off_axis) > 1:
        raise ValueError(
            f"host_local_slice(axis={axis}): local shards are partitioned "
            "along another dimension; reassembling along this axis would "
            "corrupt data. Pass the sharded axis explicitly."
        )
    # Contiguity check: a device order that gives this process
    # non-adjacent global blocks (e.g. rows [0:512] and [1024:1536])
    # must not silently splice into one "contiguous" array — callers
    # index the result as a contiguous env range.
    starts = []
    for s in shards:
        if not s.index or axis >= len(s.index):
            continue
        sl = s.index[axis]
        starts.append((sl.start or 0, sl.stop))
    starts = sorted(set(starts))
    for (a_start, a_stop), (b_start, _) in zip(starts, starts[1:]):
        if a_stop != b_start:
            raise ValueError(
                f"host_local_slice(axis={axis}): this process's shards "
                f"cover non-adjacent global blocks {starts}; concatenating "
                "them would misattribute rows. Use a device order that "
                "gives each process one contiguous block."
            )
    if len(parts) == 1:
        return parts[0]
    return np.concatenate(parts, axis=axis)


def all_hosts_mean(value: float) -> float:
    """Average a host-local scalar across processes (logging only)."""
    if jax.process_count() == 1:
        return float(value)
    from jax.experimental import multihost_utils

    arr = multihost_utils.process_allgather(np.asarray([value]))
    return float(np.mean(arr))


def broadcast_from_primary(values: np.ndarray) -> np.ndarray:
    """Broadcast a small host array from process 0 to every process.

    Used for loop-control decisions that must not diverge across hosts
    (time-budget stop, fused-window size): host-local wall clocks differ,
    so each host deciding independently would enqueue different jitted
    collective programs and hang the job."""
    if jax.process_count() == 1:
        return np.asarray(values)
    from jax.experimental import multihost_utils

    arr = np.asarray(values)
    if arr.dtype == np.int64 and not jax.config.jax_enable_x64:
        # broadcast_one_to_all round-trips through jax arrays, which
        # silently canonicalize int64 -> int32 with x64 off — a seed
        # >= 2**31 would wrap multi-process but not single-process. Fail
        # loudly instead of diverging between the two modes.
        if np.any(arr > np.iinfo(np.int32).max) or np.any(
            arr < np.iinfo(np.int32).min
        ):
            raise ValueError(
                "broadcast_from_primary: int64 payload exceeds int32 range "
                "and jax_enable_x64 is off — the multihost transport would "
                "silently truncate it. Use a value that fits int32."
            )
        arr = arr.astype(np.int32)
    out = np.asarray(multihost_utils.broadcast_one_to_all(arr))
    return out.astype(values.dtype) if hasattr(values, "dtype") else out


def allgather_rows(rows: np.ndarray, width: int) -> np.ndarray:
    """Concatenate variable-count, fixed-width host-local int rows from
    every process, in process order (identical result on all hosts).

    The transport pads each host's block to the global max count (shapes
    must match for the allgather) and strips the padding after. Used to
    globalize completed pool-game records so every host folds the SAME
    win-rate updates and the deterministic rotation sampling stays in
    lockstep (the multi-host analog of opponent_pool.rs:578-653's
    single-process queue)."""
    rows = np.asarray(rows, dtype=np.int32).reshape(-1, width)
    if jax.process_count() == 1:
        return rows
    from jax.experimental import multihost_utils

    counts = multihost_utils.process_allgather(
        np.asarray([rows.shape[0]], np.int32)
    ).reshape(-1)
    maxn = int(counts.max())
    if maxn == 0:
        return np.zeros((0, width), np.int32)
    padded = np.zeros((maxn, width), np.int32)
    padded[: rows.shape[0]] = rows
    gathered = np.asarray(
        multihost_utils.process_allgather(padded)
    ).reshape(len(counts), maxn, width)
    return np.concatenate(
        [gathered[p, : int(counts[p])] for p in range(len(counts))], axis=0
    )


def barrier(name: str) -> None:
    """Cross-process sync point (no-op single-process). Placed after
    host-0 checkpoint writes so other hosts never read a half-written
    checkpoint from shared storage at the next pool rotation."""
    if jax.process_count() == 1:
        return
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)
