"""Native (C++) runtime components, built on demand with the system
toolchain and bound through ctypes.

The reference's native layer is Burn's backend kernels plus rayon
threading (SURVEY.md §2 native-component note); here the device compute
path is XLA, and the host-side runtime keeps its hot scalar loops in
C++: currently the Plackett-Luce MM rating engine
(native/plackett_luce.cpp), recomputed at every training checkpoint and
over every tournament game.

Build strategy: compile ``native/<name>.cpp`` with ``g++ -O3`` into a
cache directory the first time it is needed (sources ship with the
package; rebuilds trigger on source-hash change). Every native entry
point has a pure-Python fallback, selected automatically when no
compiler is available or ``BURN_PPO_NO_NATIVE=1``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path
from typing import Optional

_REPO_NATIVE = Path(__file__).resolve().parent.parent.parent / "native"
_LOCK = threading.Lock()
_CACHE: dict = {}


def native_disabled() -> bool:
    return os.environ.get("BURN_PPO_NO_NATIVE") == "1"


def _build_dir() -> Path:
    d = os.environ.get("BURN_PPO_NATIVE_CACHE")
    if d:
        return Path(d)
    return Path.home() / ".cache" / "burn_ppo_tpu" / "native"


def load_library(name: str) -> Optional[ctypes.CDLL]:
    """Compile (if needed) and dlopen native/<name>.cpp; None on failure."""
    if native_disabled():
        return None
    with _LOCK:
        if name in _CACHE:
            return _CACHE[name]
        lib = _load_library_locked(name)
        _CACHE[name] = lib
        return lib


def _load_library_locked(name: str) -> Optional[ctypes.CDLL]:
    src = _REPO_NATIVE / f"{name}.cpp"
    if not src.exists():
        return None
    try:
        source = src.read_bytes()
        tag = hashlib.sha256(source).hexdigest()[:16]
        out_dir = _build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        so_path = out_dir / f"_lib{name}-{tag}.so"
        if not so_path.exists():
            tmp = so_path.with_suffix(f".tmp{os.getpid()}.so")
            cmd = [
                os.environ.get("CXX", "g++"),
                "-O3",
                "-std=c++17",
                "-shared",
                "-fPIC",
                str(src),
                "-o",
                str(tmp),
            ]
            res = subprocess.run(
                cmd, capture_output=True, text=True, timeout=120
            )
            if res.returncode != 0:
                print(
                    f"burn_ppo_tpu: native build of {name} failed, using "
                    f"Python fallback:\n{res.stderr}",
                    file=sys.stderr,
                )
                return None
            tmp.replace(so_path)  # atomic publish
        return ctypes.CDLL(str(so_path))
    except Exception as exc:  # compiler missing, FS readonly, ...
        print(
            f"burn_ppo_tpu: native {name} unavailable ({exc}); using Python "
            "fallback",
            file=sys.stderr,
        )
        return None
