"""Test configuration: run the suite on CPU with a virtual 8-device mesh.

Mirrors the reference's test strategy of an ndarray CPU backend for all
tensor tests (e.g. src/ppo.rs:2117-2119): deterministic, no accelerator
needed. Multi-chip sharding logic is exercised against 8 virtual CPU
devices via XLA_FLAGS. Tests marked ``gpu`` drive a GPU through child
processes of their own and skip where none is visible (the ``gpu_env``
fixture decides, at run time).
"""

import os
import shutil
import subprocess

import pytest

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")


@pytest.fixture
def gpu_env():
    """Environment for a child process that runs on the GPU; skips the
    test when nvidia-smi lists no card."""
    smi = shutil.which("nvidia-smi")
    listed = (
        subprocess.run([smi, "-L"], capture_output=True, text=True,
                       timeout=60).stdout
        if smi else ""
    )
    if "GPU" not in listed:
        pytest.skip("no NVIDIA GPU visible (nvidia-smi -L)")
    env = dict(os.environ)
    for var in ("JAX_PLATFORMS", "XLA_FLAGS"):
        env.pop(var, None)
    return env
