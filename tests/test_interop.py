"""Reference-checkpoint (Burn NamedMpk) import.

No Rust toolchain exists in this environment to produce real reference
artifacts, so these tests synthesize NamedMpk files following Burn's
record layout (externally-tagged enum variant, ParamSerde id/param
wrappers, f32 byte-blob tensor leaves) and assert the importer
reconstructs repo pytrees that produce identical forwards — plus a
decoder unit test over the msgpack type surface."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from burn_ppo_tpu.checkpoint import CheckpointManager
from burn_ppo_tpu.interop import (
    collect_tensors,
    load_reference_checkpoint,
    msgpack_decode,
)
from burn_ppo_tpu.models.network import ActorCriticNetwork


# ---------------------------------------------------------------------------
# Minimal msgpack ENCODER (test-side twin of the decoder)
# ---------------------------------------------------------------------------
def enc(obj) -> bytes:
    import struct as st

    if obj is None:
        return b"\xc0"
    if obj is True:
        return b"\xc3"
    if obj is False:
        return b"\xc2"
    if isinstance(obj, int):
        if 0 <= obj <= 0x7F:
            return bytes([obj])
        if -32 <= obj < 0:
            return bytes([obj & 0xFF])
        return b"\xd3" + st.pack(">q", obj)
    if isinstance(obj, float):
        return b"\xcb" + st.pack(">d", obj)
    if isinstance(obj, str):
        b = obj.encode("utf-8")
        if len(b) <= 31:
            return bytes([0xA0 | len(b)]) + b
        return b"\xdb" + st.pack(">I", len(b)) + b
    if isinstance(obj, (bytes, bytearray)):
        return b"\xc6" + st.pack(">I", len(obj)) + bytes(obj)
    if isinstance(obj, (list, tuple)):
        if len(obj) <= 15:
            head = bytes([0x90 | len(obj)])
        else:
            head = b"\xdd" + st.pack(">I", len(obj))
        return head + b"".join(enc(v) for v in obj)
    if isinstance(obj, dict):
        if len(obj) <= 15:
            head = bytes([0x80 | len(obj)])
        else:
            head = b"\xdf" + st.pack(">I", len(obj))
        return head + b"".join(enc(k) + enc(v) for k, v in obj.items())
    raise TypeError(type(obj))


def tensor_leaf(arr: np.ndarray, pid: str) -> dict:
    """Burn ParamSerde: {'id', 'param': {'bytes', 'shape', 'dtype'}}."""
    a = np.asarray(arr, np.float32)
    return {
        "id": pid,
        "param": {
            "bytes": a.tobytes(),
            "shape": list(a.shape),
            "dtype": "F32",
        },
    }


def linear_rec(layer, pid) -> dict:
    return {
        "weight": tensor_leaf(layer["kernel"], f"{pid}.w"),
        "bias": tensor_leaf(layer["bias"], f"{pid}.b"),
    }


def conv_rec(layer, pid) -> dict:
    # ours HWIO -> burn OIHW
    w = np.transpose(np.asarray(layer["kernel"]), (3, 2, 0, 1))
    return {
        "weight": tensor_leaf(w, f"{pid}.w"),
        "bias": tensor_leaf(layer["bias"], f"{pid}.b"),
    }


def nhwc_to_nchw_rows(kernel: np.ndarray, h, w, c) -> np.ndarray:
    """Inverse of interop._nchw_to_nhwc_rows: write OUR fc kernel rows
    into the reference's NCHW flatten order."""
    spatial = h * w * c
    idx = np.arange(spatial)
    hh, ww, cc = idx // (w * c), (idx // c) % w, idx % c
    ref_rows = cc * h * w + hh * w + ww
    out = np.asarray(kernel).copy()
    out[ref_rows] = kernel[:spatial]
    return out


# ---------------------------------------------------------------------------
def test_msgpack_decoder_type_surface():
    cases = [
        None, True, False, 0, 5, 127, -1, -32, 1_000_000, -1_000_000,
        3.5, "", "abc", "x" * 100, b"\x00\x01\xff",
        [1, 2, 3], list(range(40)), {"a": 1, "b": [2, {"c": None}]},
    ]
    for obj in cases:
        assert msgpack_decode(enc(obj)) == obj
    # float32 wire format decodes too
    import struct as st

    assert msgpack_decode(b"\xca" + st.pack(">f", 1.5)) == 1.5


def test_collect_tensors_descends_wrappers():
    rec = {
        "Mlp": {
            "layers": [linear_rec({"kernel": np.eye(2), "bias": np.zeros(2)}, "0")],
        }
    }
    t = collect_tensors(msgpack_decode(enc(rec)))
    assert ("layers", 0, "weight") in t
    np.testing.assert_array_equal(t[("layers", 0, "weight")], np.eye(2))


def _write_reference_ckpt(tmp_path, variant, record, meta, normalizer=None):
    (tmp_path / "model.mpk").write_bytes(enc({variant: record}))
    (tmp_path / "metadata.json").write_text(json.dumps(meta))
    if normalizer is not None:
        (tmp_path / "normalizer.json").write_text(json.dumps(normalizer))


def test_import_mlp_roundtrip(tmp_path):
    net = ActorCriticNetwork(
        network_type="mlp", obs_dim=5, action_count=3, hidden_size=8,
        num_hidden=2, activation="tanh",
    )
    params = jax.device_get(net.init(jax.random.PRNGKey(0)))
    record = {
        "layers": [linear_rec(l, f"l{i}") for i, l in enumerate(params["layers"])],
        "policy_head": linear_rec(params["policy_head"], "ph"),
        "value_head": linear_rec(params["value_head"], "vh"),
    }
    meta = {
        "step": 100, "obs_dim": 5, "action_count": 3, "num_players": 1,
        "hidden_size": 8, "num_hidden": 2, "activation": "tanh",
        "network_type": "mlp", "env_name": "cartpole", "avg_return": 1.0,
        "rng_seed": 0,
    }
    norm = {"mean": [0.1] * 5, "var": [2.0] * 5, "count": 50.0, "clip": 10.0}
    _write_reference_ckpt(tmp_path, "Mlp", record, meta, norm)

    net2, params2, obs_norm, meta2 = load_reference_checkpoint(tmp_path)
    obs = jnp.asarray(np.random.default_rng(0).normal(size=(4, 5)), jnp.float32)
    l1, v1 = net.forward(params, obs)
    l2, v2 = net2.forward(params2, obs)
    np.testing.assert_allclose(np.asarray(l1), np.asarray(l2), atol=1e-6)
    np.testing.assert_allclose(np.asarray(v1), np.asarray(v2), atol=1e-6)
    np.testing.assert_allclose(np.asarray(obs_norm.m2), 2.0)
    assert float(obs_norm.count) == 50.0
    assert meta2["env_name"] == "cartpole"

    # And through the CheckpointManager routing used by eval/tournament:
    assert CheckpointManager.is_reference_checkpoint(tmp_path)
    net3, params3, _ = CheckpointManager.load_model(tmp_path)
    l3, _ = net3.forward(params3, obs)
    np.testing.assert_allclose(np.asarray(l1), np.asarray(l3), atol=1e-6)
    assert CheckpointManager.load_obs_normalizer(tmp_path) is not None


def test_import_ctde_roundtrip(tmp_path):
    net = ActorCriticNetwork(
        network_type="ctde", obs_dim=6, action_count=4, hidden_size=8,
        num_hidden=1, activation="tanh", privileged_obs_dim=10,
        critic_hidden_size=12, critic_num_hidden=2,
    )
    params = jax.device_get(net.init(jax.random.PRNGKey(1)))
    record = {
        "actor_layers": [
            linear_rec(l, f"a{i}") for i, l in enumerate(params["actor_layers"])
        ],
        "policy_head": linear_rec(params["policy_head"], "ph"),
        "critic_layers": [
            linear_rec(l, f"c{i}") for i, l in enumerate(params["critic_layers"])
        ],
        "value_head": linear_rec(params["value_head"], "vh"),
    }
    meta = {
        "step": 5, "obs_dim": 6, "action_count": 4, "num_players": 4,
        "hidden_size": 8, "num_hidden": 1, "activation": "tanh",
        "network_type": "ctde", "privileged_obs_dim": 10,
        "critic_hidden_size": 12, "critic_num_hidden": 2,
        "env_name": "liars_dice", "avg_return": 0.0, "rng_seed": 0,
    }
    _write_reference_ckpt(tmp_path, "Ctde", record, meta)

    net2, params2, _, _ = load_reference_checkpoint(tmp_path)
    obs = jnp.asarray(np.random.default_rng(1).normal(size=(3, 6)), jnp.float32)
    priv = jnp.asarray(np.random.default_rng(2).normal(size=(3, 10)), jnp.float32)
    np.testing.assert_allclose(
        np.asarray(net.forward_actor(params, obs)),
        np.asarray(net2.forward_actor(params2, obs)),
        atol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(net.forward_critic(params, priv, obs)),
        np.asarray(net2.forward_critic(params2, priv, obs)),
        atol=1e-6,
    )


def test_import_cnn_roundtrip_with_layout_reconciliation(tmp_path):
    """CNN import must fix BOTH the OIHW->HWIO kernel layout and the
    NCHW->NHWC flatten order of the first FC layer's input rows."""
    h, w, c = 6, 7, 2
    net = ActorCriticNetwork(
        network_type="cnn", obs_dim=h * w * c + 2, action_count=7,
        hidden_size=8, num_hidden=1, activation="tanh",
        obs_shape=(h, w, c), num_conv_layers=2, conv_channels=(4, 4),
        kernel_size=3, cnn_fc_hidden_size=16, cnn_num_fc_layers=1,
    )
    params = jax.device_get(net.init(jax.random.PRNGKey(2)))
    fc0_ref = dict(params["fc_layers"][0])
    fc0_ref["kernel"] = nhwc_to_nchw_rows(
        np.asarray(fc0_ref["kernel"]), h, w, 4
    )
    record = {
        "conv_layers": [
            conv_rec(l, f"cv{i}") for i, l in enumerate(params["conv_layers"])
        ],
        "fc_layers": [linear_rec(fc0_ref, "fc0")],
        "policy_head": linear_rec(params["policy_head"], "ph"),
        "value_head": linear_rec(params["value_head"], "vh"),
    }
    meta = {
        "step": 5, "obs_dim": h * w * c + 2, "action_count": 7,
        "num_players": 2, "hidden_size": 8, "num_hidden": 1,
        "activation": "tanh", "network_type": "cnn",
        "obs_shape": [h, w, c], "num_conv_layers": 2,
        "conv_channels": [4, 4], "kernel_size": 3,
        "cnn_fc_hidden_size": 16, "cnn_num_fc_layers": 1,
        "env_name": "connect_four", "avg_return": 0.0, "rng_seed": 0,
    }
    _write_reference_ckpt(tmp_path, "Cnn", record, meta)

    net2, params2, _, _ = load_reference_checkpoint(tmp_path)
    obs = jnp.asarray(
        np.random.default_rng(3).normal(size=(4, h * w * c + 2)), jnp.float32
    )
    l1, v1 = net.forward(params, obs)
    l2, v2 = net2.forward(params2, obs)
    np.testing.assert_allclose(np.asarray(l1), np.asarray(l2), atol=1e-5)
    np.testing.assert_allclose(np.asarray(v1), np.asarray(v2), atol=1e-5)


def test_import_rejects_shape_mismatch(tmp_path):
    net = ActorCriticNetwork(
        network_type="mlp", obs_dim=5, action_count=3, hidden_size=8,
        num_hidden=1, activation="tanh",
    )
    params = jax.device_get(net.init(jax.random.PRNGKey(0)))
    record = {
        "layers": [linear_rec(l, f"l{i}") for i, l in enumerate(params["layers"])],
        "policy_head": linear_rec(params["policy_head"], "ph"),
        "value_head": linear_rec(params["value_head"], "vh"),
    }
    meta = {
        "step": 1, "obs_dim": 5, "action_count": 3, "num_players": 1,
        "hidden_size": 16,  # wrong: record was built with hidden 8
        "num_hidden": 1, "activation": "tanh", "network_type": "mlp",
        "env_name": "cartpole", "avg_return": 0.0, "rng_seed": 0,
    }
    _write_reference_ckpt(tmp_path, "Mlp", record, meta)
    with pytest.raises(ValueError, match="shape"):
        load_reference_checkpoint(tmp_path)


def test_leaf_tensor_int_array_encoded_bytes():
    """rmp-serde without serde_bytes encodes Vec<u8> as a msgpack int
    array; the leaf decoder must reinterpret a byte-valued numeric list
    whose count is itemsize * prod(shape) as raw little-endian bytes
   ."""
    import numpy as np

    from burn_ppo_tpu.interop import _leaf_tensor

    want = np.arange(6, dtype=np.float32).reshape(2, 3)
    as_ints = list(want.tobytes())
    got = _leaf_tensor({"shape": [2, 3], "dtype": "F32", "value": as_ints})
    np.testing.assert_array_equal(got, want)


def test_leaf_tensor_count_mismatch_raises():
    """A leaf whose element count matches neither the shape nor a
    byte-encoded shape must fail loudly, never misload."""
    import numpy as np
    import pytest

    from burn_ppo_tpu.interop import _leaf_tensor

    with pytest.raises(ValueError, match="element count"):
        _leaf_tensor({"shape": [2, 3], "dtype": "F32",
                      "value": [1.0] * 7})


def test_leaf_tensor_plain_value_list_still_decodes():
    import numpy as np

    from burn_ppo_tpu.interop import _leaf_tensor

    got = _leaf_tensor({"shape": [4], "dtype": "F32",
                        "value": [1.5, -2.0, 0.0, 3.25]})
    np.testing.assert_array_equal(got, np.asarray([1.5, -2.0, 0.0, 3.25],
                                                  np.float32))


def test_leaf_tensor_byte_valued_floats_not_reinterpreted():
    """A genuine f32 list that happens to hold small integers with the
    right count must NOT be reinterpreted: count == prod(shape) takes
    the plain-value path."""
    import numpy as np

    from burn_ppo_tpu.interop import _leaf_tensor

    want = np.asarray([0.0, 1.0, 2.0, 255.0], np.float32)
    got = _leaf_tensor({"shape": [4], "dtype": "F32",
                        "value": [0, 1, 2, 255]})
    np.testing.assert_array_equal(got, want)
