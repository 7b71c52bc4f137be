"""chip_smoke.py off the card: it must fail without a GPU (printing no
result line), and its option must select the phases it promises. The
phases themselves run on the GPU (python chip_smoke.py)."""

import json
import math
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run_script(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_fails_without_gpu():
    proc = _run_script(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "not gpu" in proc.stderr


def test_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_script(str(tmp_path / "chip_smoke.py"), tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no burn_ppo_tpu package" in proc.stderr


@pytest.mark.parametrize("argv,phase,count", [
    ([], "one_card", 1),
    (["--four"], "four_cards", 4),
])
def test_option_selects_phases(monkeypatch, capsys, argv, phase, count):
    called = []

    def fake(name):
        def run(smoke):
            called.append(name)
            return {"platform": "gpu", "kind": "Fake GPU", "count": count,
                    "nvidia_smi": ["Fake GPU, 700.00 W"] * count}
        return run

    monkeypatch.setattr(chip_smoke, "one_card", fake("one_card"))
    monkeypatch.setattr(chip_smoke, "four_cards", fake("four_cards"))
    assert chip_smoke.main(argv) == 0
    assert called == [phase]
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "Fake GPU", "count": count},
    }
    assert lines[-2] == "card: Fake GPU, 700.00 W"


def test_failed_phase_prints_no_result(monkeypatch, capsys):
    def boom(smoke):
        raise chip_smoke.PhaseError("train: exit 1")

    monkeypatch.setattr(chip_smoke, "one_card", boom)
    assert chip_smoke.main([]) == 1
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "train: exit 1" in captured.err


def _write_metrics(run_dir, records):
    run_dir.mkdir(parents=True, exist_ok=True)
    with open(run_dir / "metrics.jsonl", "w") as f:
        f.write(json.dumps({"type": "hparams", "step": 0, "data": {}}) + "\n")
        for name, value in records:
            f.write(json.dumps({"type": "scalar", "name": name,
                                "value": value, "step": 1}) + "\n")


_HEALTHY = [("train/policy_loss", 0.1), ("train/invalid_mask_count", 0.0),
            ("train/nonfinite_count", 0.0), ("perf/sps", 1e6)]


def test_read_scalars_accepts_healthy_run(tmp_path):
    _write_metrics(tmp_path, _HEALTHY)
    assert len(chip_smoke.read_scalars(tmp_path)) == len(_HEALTHY)


@pytest.mark.parametrize("bad", [
    ("train/policy_loss", math.nan),
    ("train/value_loss", math.inf),
    ("train/invalid_mask_count", 3.0),
    ("train/nonfinite_count", 1.0),
])
def test_read_scalars_rejects_unhealthy_run(tmp_path, bad):
    _write_metrics(tmp_path, _HEALTHY + [bad])
    with pytest.raises(chip_smoke.PhaseError):
        chip_smoke.read_scalars(tmp_path)


def test_read_scalars_requires_guard_counters(tmp_path):
    _write_metrics(tmp_path, [("train/policy_loss", 0.1)])
    with pytest.raises(chip_smoke.PhaseError, match="guard"):
        chip_smoke.read_scalars(tmp_path)


@pytest.mark.parametrize("delta,ok", [(0.0, True), (1e-5, True),
                                      (1e-2, False)])
def test_tails_match_tolerance(delta, ok):
    b = {k: 1.0 for k in chip_smoke.TAIL_KEYS}
    a = {k: v + delta for k, v in b.items()}
    if ok:
        chip_smoke.assert_tails_match("t", a, b)
    else:
        with pytest.raises(chip_smoke.PhaseError):
            chip_smoke.assert_tails_match("t", a, b)
