"""Host-side bench.py helpers (no device work): the peak table, the
GPU-only device check and iteration-count clamping."""

import sys

import pytest

sys.path.insert(0, ".")  # bench.py lives at the repo root

import bench


@pytest.mark.parametrize("kind", sorted(bench.PEAKS))
def test_device_peaks_known_kind(kind):
    peaks = bench.device_peaks(kind)
    assert peaks["bf16_tflops"] > peaks["tf32_tflops"] > peaks["f32_tflops"]
    assert peaks["hbm_tb_per_s"] > 0


def test_device_peaks_h100_sxm_values():
    """The H100 SXM row carries NVIDIA's published dense rates."""
    peaks = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert (peaks["bf16_tflops"], peaks["tf32_tflops"],
            peaks["f32_tflops"], peaks["hbm_tb_per_s"]) == (
        989.0, 495.0, 67.0, 3.35)


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB"])
def test_device_peaks_unknown_kind_raises(kind):
    with pytest.raises(ValueError, match="no published peaks"):
        bench.device_peaks(kind)


def test_gpu_device_refuses_cpu():
    """No fallback: on the CPU backend the bench raises before measuring."""
    import jax

    with pytest.raises(RuntimeError, match="measures a GPU"):
        bench.gpu_device(jax)


def test_iters_env_clamps_to_two(monkeypatch, capsys):
    """iters=1 degenerates the (dt_N - dt_1)/(iters-1) differencing into
    a ~1e20 env-steps/s headline; the parser must clamp to 2."""
    monkeypatch.setenv("BENCH_ITERS", "1")
    assert bench._iters_env("BENCH_ITERS", "100") == 2
    assert "clamping" in capsys.readouterr().err
    monkeypatch.setenv("BENCH_ITERS", "50")
    assert bench._iters_env("BENCH_ITERS", "100") == 50
    monkeypatch.delenv("BENCH_ITERS")
    assert bench._iters_env("BENCH_ITERS", "100") == 100
