"""burn_ppo_tpu.parity: the cross-backend comparison, driven on the CPU
against itself (identical backends must agree exactly) and against
perturbed outputs (the comparison must catch a mismatch)."""

import numpy as np
import pytest

from burn_ppo_tpu import parity

_CONFIGS = {
    "skull_ctde": """
env = "skull"
network_type = "ctde"
hidden_size = 16
num_hidden = 2
critic_hidden_size = 16
critic_num_hidden = 2
num_steps = 8
num_minibatches = 2
num_epochs = 2
target_kl = 0.02
seed = 3
[player_count]
type = "Fixed"
count = 4
""",
    "cartpole_mlp": """
env = "cartpole"
hidden_size = 16
num_hidden = 2
num_steps = 8
num_minibatches = 2
num_epochs = 2
normalize_obs = true
seed = 4
""",
}


@pytest.fixture(scope="module", params=sorted(_CONFIGS))
def pair(request, tmp_path_factory):
    """(reference npz, replay npz) for one config, both on the CPU."""
    d = tmp_path_factory.mktemp(request.param)
    cfg = d / "cfg.toml"
    cfg.write_text(_CONFIGS[request.param])
    ref, dev = d / "ref.npz", d / "dev.npz"
    parity.run(str(cfg), 8, str(ref))
    parity.run(str(cfg), 8, str(dev), inputs_path=str(ref))
    return ref, dev


def test_same_backend_agrees(pair):
    report = parity.compare(*map(str, pair))
    assert report["ok"], report
    assert report["highest"]["failed"] == []
    assert report["same_actions"] == 1.0
    # On one backend the default precision is the same program.
    assert report["default_precision_drift"] == 0.0


def test_outputs_cover_a_to_d(pair):
    with np.load(pair[1]) as f:
        keys = set(f.files)
    for k in ("a/logits", "a/values", "b/advantages", "b/returns",
              "c/params_l1", "c/policy_loss", "c/approx_kl", "d/actions",
              "default/c/params_l1"):
        assert k in keys, k
    with np.load(pair[0]) as f:
        assert any(k.startswith("in/params/") for k in f.files)
        assert "in/rollout/last_vpp" in f.files


@pytest.mark.parametrize("key,scale", [
    ("a/logits", 1e-2), ("b/returns", 1e-2), ("c/params_l1", 1e-3),
])
def test_compare_catches_a_mismatch(pair, tmp_path, key, scale):
    with np.load(pair[1]) as f:
        dev = {k: f[k] for k in f.files}
    dev[key] = dev[key] * (1.0 + scale) + scale
    bad = tmp_path / "bad.npz"
    np.savez(bad, **dev)
    report = parity.compare(str(pair[0]), str(bad))
    assert not report["ok"]
    assert key in report["highest"]["failed"]


def test_compare_catches_flipped_actions(pair, tmp_path):
    with np.load(pair[1]) as f:
        dev = {k: f[k] for k in f.files}
    actions = dev["d/actions"].copy()
    actions.flat[0] = actions.flat[0] + 1
    dev["d/actions"] = actions
    bad = tmp_path / "bad.npz"
    np.savez(bad, **dev)
    report = parity.compare(str(pair[0]), str(bad))
    # One flip out of 64 actions is far below the 99.9% bar.
    assert report["same_actions"] < parity.MIN_SAME_ACTIONS
    assert not report["ok"]


@pytest.mark.parametrize("got,ref,passes", [
    (5e-5, 0.0, True),          # absolute near zero
    (1000.05, 1000.0, True),    # relative for large values
    (1.001, 1.0, False),
    (2e-4, 0.0, False),
])
def test_deviation_rule(got, ref, passes):
    dev = parity._deviation(np.asarray(got), np.asarray(ref))
    assert (dev <= parity.TOLERANCE) == passes


@pytest.mark.parametrize("delta,ok", [(2.1e-4, True), (5.4e-4, True),
                                      (1.5e-3, False), (2e-3, False)])
def test_clip_fraction_has_count_tolerance(pair, tmp_path, delta, ok):
    """clip_fraction counts threshold decisions: the few flips that
    ulp-level noise causes at |ratio - 1| == clip near-ties pass, a
    real mismatch does not."""
    with np.load(pair[1]) as f:
        dev = {k: f[k] for k in f.files}
    dev["c/clip_fraction"] = dev["c/clip_fraction"] + delta
    path = tmp_path / "dev.npz"
    np.savez(path, **dev)
    report = parity.compare(str(pair[0]), str(path))
    assert report["ok"] == ok
    assert ("c/clip_fraction" in report["highest"]["failed"]) == (not ok)


def test_report_lists_every_key_and_the_drift_over_its_bar(pair, tmp_path):
    """Each compared output carries its own deviation, bar and
    default-precision drift; drift over a bar is named, not failed."""
    with np.load(pair[1]) as f:
        dev = {k: f[k] for k in f.files}
    dev["default/a/values"] = dev["default/a/values"] + 1e-3
    path = tmp_path / "dev.npz"
    np.savez(path, **dev)
    report = parity.compare(str(pair[0]), str(path))
    keys = set(report["highest"]["by_key"])
    assert {"a/logits", "b/returns", "c/clip_fraction"} <= keys
    assert keys == set(report["bars"]) == set(
        report["default_precision"]["by_key"])
    assert report["bars"]["c/clip_fraction"] == 1e-3
    assert report["default_precision"]["over_bar"] == ["a/values"]
    assert report["ok"]


def test_deviation_shape_mismatch_fails():
    assert parity._deviation(np.zeros(3), np.zeros(4)) == float("inf")
