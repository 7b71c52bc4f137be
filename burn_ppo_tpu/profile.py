"""Profiling: host-side scopes, JAX device traces, memory stats.

The device analog of the reference's Tracy integration (src/profile.rs:
27-64 macros, ProfiledAllocator 8-24) and its always-on wall-clock phase
timing (src/main.rs:530-533, perf/* series 1092-1124):

  * ``profile_scope(name)`` — zero-dependency wall-clock zones aggregated
    into a process-global registry (Tracy zone analog).  Inside jitted
    code use ``jax.named_scope`` instead; these scopes measure *host*
    phases (dispatch, logging, checkpoint IO).
  * ``TraceCapture`` — wraps ``jax.profiler.start_trace/stop_trace`` to
    capture an XLA device trace for a window of training updates, viewable
    in TensorBoard/Perfetto (the Tracy-UI analog).
  * ``device_memory_stats()`` — per-device memory usage, the analog of the
    reference's heap profiling (stats_alloc net-bytes, main.rs:15-17).

The reference syncs the GPU inside profile zones so spans measure real
device time (ppo.rs:1940-1941); the analog here is ``sync=True`` on a
scope, which blocks on a device fence before closing the span.
"""

from __future__ import annotations

import functools
import json
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional


@dataclass
class ScopeStats:
    count: int = 0
    total_seconds: float = 0.0
    max_seconds: float = 0.0

    def record(self, dt: float) -> None:
        self.count += 1
        self.total_seconds += dt
        self.max_seconds = max(self.max_seconds, dt)

    @property
    def mean_seconds(self) -> float:
        return self.total_seconds / self.count if self.count else 0.0


class ScopeRegistry:
    """Process-global registry of named wall-clock scopes."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._stats: Dict[str, ScopeStats] = {}

    def record(self, name: str, dt: float) -> None:
        with self._lock:
            self._stats.setdefault(name, ScopeStats()).record(dt)

    def snapshot(self) -> Dict[str, ScopeStats]:
        with self._lock:
            return {
                k: ScopeStats(v.count, v.total_seconds, v.max_seconds)
                for k, v in self._stats.items()
            }

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()

    def report(self) -> str:
        rows = sorted(
            self.snapshot().items(), key=lambda kv: -kv[1].total_seconds
        )
        lines = [f"{'scope':<40} {'count':>8} {'total_s':>10} {'mean_ms':>10} {'max_ms':>10}"]
        for name, s in rows:
            lines.append(
                f"{name:<40} {s.count:>8} {s.total_seconds:>10.3f} "
                f"{s.mean_seconds * 1e3:>10.3f} {s.max_seconds * 1e3:>10.3f}"
            )
        return "\n".join(lines)


REGISTRY = ScopeRegistry()


def _sync_devices() -> None:
    """Best-effort fence: enqueue + fetch a scalar on EVERY local device.

    On local backends a device executes its stream in order, so fetching
    a freshly enqueued scalar awaits all prior work on that device —
    including sharded programs, which enqueue on each participating
    device. The phase timings (train.py --profile-phases) fetch output
    checksums instead, which await exactly the program that made them.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    # Enqueue on EVERY device first, then fetch: a fetch-per-iteration
    # loop serializes one blocking host round-trip per device and bills
    # ~n_devices RTTs of sync machinery to the measured span.
    # jnp.add on a committed operand runs on d's compute stream (a bare
    # device_put is a transfer and may ride a separate stream).
    pending = [
        jnp.add(jax.device_put(np.zeros(()), d), 0.0)
        for d in jax.local_devices()
    ]
    for x in pending:
        float(np.asarray(x))


@contextmanager
def profile_scope(name: str, *, sync: bool = False) -> Iterator[None]:
    """Wall-clock zone (reference profile_scope!, src/profile.rs:27-40)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync:
            _sync_devices()
        REGISTRY.record(name, time.perf_counter() - t0)


def profiled(name: Optional[str] = None):
    """Decorator form (reference profile_function!, src/profile.rs:43-52)."""

    def wrap(fn):
        scope = name or fn.__qualname__

        @functools.wraps(fn)
        def inner(*a, **kw):
            with profile_scope(scope):
                return fn(*a, **kw)

        return inner

    return wrap


def device_memory_stats() -> List[Dict[str, Any]]:
    """Per-device memory stats (HBM bytes in use / peak / limit).

    Heap-profiling analog of the reference's ProfiledAllocator
    (src/profile.rs:8-24) and per-update net-bytes logging
    (src/main.rs:675-681). Devices without memory_stats report {}.
    """
    import jax

    out = []
    for d in jax.local_devices():
        try:
            stats = d.memory_stats() or {}
        except Exception:
            stats = {}
        out.append(
            {
                "device": str(d),
                "bytes_in_use": stats.get("bytes_in_use"),
                "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
                "bytes_limit": stats.get("bytes_limit"),
            }
        )
    return out


@dataclass
class TraceCapture:
    """Capture a jax.profiler trace for a window of training updates.

    Usage: ``cap = TraceCapture(log_dir, start_update=10, num_updates=3)``
    then call ``cap.on_update(i)`` once per training update; the trace
    starts before update ``start_update`` and stops after
    ``start_update + num_updates - 1``.  The Tracy-equivalent UI is
    TensorBoard's profile plugin or Perfetto on the captured trace.
    """

    log_dir: str | Path
    start_update: int = 1
    num_updates: int = 2
    _active: bool = field(default=False, init=False)
    _done: bool = field(default=False, init=False)
    # Update index the trace ACTUALLY started at: on a resumed run the
    # first on_update_start may arrive far past start_update, and
    # counting the window from the configured start would stop the trace
    # immediately — capturing 1 update instead of num_updates with no
    # warning.
    _started_at: int = field(default=0, init=False)

    def on_update_start(self, update_idx: int) -> None:
        if self._done or self._active:
            return
        if self.num_updates <= 0:
            self._done = True  # zero-length window: capture nothing
            return
        if update_idx >= self.start_update:
            import jax

            Path(self.log_dir).mkdir(parents=True, exist_ok=True)
            jax.profiler.start_trace(str(self.log_dir))
            self._active = True
            self._started_at = update_idx

    def on_update_end(self, update_idx: int) -> None:
        if not self._active:
            return
        if update_idx >= self._started_at + self.num_updates - 1:
            import jax

            jax.profiler.stop_trace()
            self._active = False
            self._done = True

    def close(self) -> None:
        if self._active:
            import jax

            jax.profiler.stop_trace()
            self._active = False
            self._done = True


def write_scope_report(path: str | Path) -> None:
    """Dump the scope registry as JSON (run-dir artifact)."""
    snap = REGISTRY.snapshot()
    data = {
        name: {
            "count": s.count,
            "total_seconds": s.total_seconds,
            "mean_seconds": s.mean_seconds,
            "max_seconds": s.max_seconds,
        }
        for name, s in snap.items()
    }
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_suffix(".tmp")
    tmp.write_text(json.dumps(data, indent=2))
    tmp.replace(p)
