"""Read-only import of reference (burn-ppo) checkpoints.

The reference serializes models with Burn's ``NamedMpkFileRecorder``
(MessagePack, /root/reference/src/checkpoint.rs:195-272: ``model.mpk``
holding the module record, ``metadata.json`` holding the architecture,
``normalizer.json`` holding the obs normalizer) — a format this repo
cannot otherwise consume, which blocked cross-framework head-to-heads
. This module maps those artifacts
onto repo pytrees so a reference-trained model can enter eval and
tournaments.

No MessagePack library ships in this environment, so a minimal
spec-complete decoder lives here (``msgpack_decode``). The record
walker is deliberately tolerant of Burn-version differences in the
leaf encoding: a tensor leaf is any map carrying a ``shape`` plus raw
``bytes`` (f32 little-endian), a numeric ``value`` list, or a nested
``data``/``param`` wrapper; enum variants (single-key maps like
``{"Mlp": ...}``) and param-id wrappers are descended through.

Layout reconciliation (documented against the reference source):
  * Burn ``nn::Linear`` weights are [d_input, d_output]
    (burn's Linear docs; matches our ``kernel`` directly, no transpose).
  * Burn ``Conv2d`` weights are OIHW; ours are HWIO
    (models/core.py conv2d_same) -> transpose (2, 3, 1, 0).
  * The reference CNN flattens NCHW features (channel-major,
    cnn.rs:255-262 permute + forward_conv reshape) while ours flattens
    NHWC, so the first FC layer's kernel rows are permuted from
    c*H*W + h*W + w to h*W*C + w*C + c order.
  * ``normalizer.json``'s ``var`` field is the Welford M2 accumulator
    (normalization.rs:28) -> ObsNormState.m2 verbatim.
"""

from __future__ import annotations

import json
import struct as _struct
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Minimal MessagePack decoder (spec-complete for data produced by serde)
# ---------------------------------------------------------------------------


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        b = self.buf[self.pos : self.pos + n]
        if len(b) != n:
            raise ValueError("truncated msgpack buffer")
        self.pos += n
        return b

    def u(self, fmt: str, n: int):
        return _struct.unpack(fmt, self.take(n))[0]


def _decode(r: _Reader) -> Any:
    b = r.take(1)[0]
    if b <= 0x7F:  # positive fixint
        return b
    if b >= 0xE0:  # negative fixint
        return b - 0x100
    if 0x80 <= b <= 0x8F:  # fixmap
        return {_decode(r): _decode(r) for _ in range(b & 0x0F)}
    if 0x90 <= b <= 0x9F:  # fixarray
        return [_decode(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:  # fixstr
        return r.take(b & 0x1F).decode("utf-8")
    if b == 0xC0:
        return None
    if b == 0xC2:
        return False
    if b == 0xC3:
        return True
    if b == 0xC4:
        return r.take(r.u(">B", 1))  # bin8
    if b == 0xC5:
        return r.take(r.u(">H", 2))  # bin16
    if b == 0xC6:
        return r.take(r.u(">I", 4))  # bin32
    if b in (0xC7, 0xC8, 0xC9):  # ext: return raw payload
        n = r.u(">B", 1) if b == 0xC7 else r.u(">H", 2) if b == 0xC8 else r.u(">I", 4)
        r.take(1)  # ext type
        return r.take(n)
    if b == 0xCA:
        return r.u(">f", 4)
    if b == 0xCB:
        return r.u(">d", 8)
    if b == 0xCC:
        return r.u(">B", 1)
    if b == 0xCD:
        return r.u(">H", 2)
    if b == 0xCE:
        return r.u(">I", 4)
    if b == 0xCF:
        return r.u(">Q", 8)
    if b == 0xD0:
        return r.u(">b", 1)
    if b == 0xD1:
        return r.u(">h", 2)
    if b == 0xD2:
        return r.u(">i", 4)
    if b == 0xD3:
        return r.u(">q", 8)
    if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
        r.take(1)
        return r.take(1 << (b - 0xD4))
    if b == 0xD9:
        return r.take(r.u(">B", 1)).decode("utf-8")
    if b == 0xDA:
        return r.take(r.u(">H", 2)).decode("utf-8")
    if b == 0xDB:
        return r.take(r.u(">I", 4)).decode("utf-8")
    if b == 0xDC:
        return [_decode(r) for _ in range(r.u(">H", 2))]
    if b == 0xDD:
        return [_decode(r) for _ in range(r.u(">I", 4))]
    if b == 0xDE:
        return {_decode(r): _decode(r) for _ in range(r.u(">H", 2))}
    if b == 0xDF:
        return {_decode(r): _decode(r) for _ in range(r.u(">I", 4))}
    raise ValueError(f"unknown msgpack byte 0x{b:02x}")


def msgpack_decode(buf: bytes) -> Any:
    r = _Reader(buf)
    obj = _decode(r)
    return obj


# ---------------------------------------------------------------------------
# Record walking: named paths -> numpy tensors
# ---------------------------------------------------------------------------

_DTYPES = {
    "F32": np.float32, "f32": np.float32, "Float32": np.float32,
    "F64": np.float64, "f64": np.float64,
    "I32": np.int32, "I64": np.int64,
}


def _leaf_tensor(node: Dict) -> Optional[np.ndarray]:
    """Decode a Burn tensor leaf: a map with a shape and raw data."""
    if not isinstance(node, dict) or "shape" not in node:
        return None
    shape = node["shape"]
    if not isinstance(shape, list) or not all(
        isinstance(s, int) for s in shape
    ):
        return None
    dtype = _DTYPES.get(str(node.get("dtype", "F32")), np.float32)
    if "bytes" in node and isinstance(node["bytes"], (bytes, bytearray)):
        arr = np.frombuffer(bytes(node["bytes"]), dtype=dtype)
    elif "value" in node and isinstance(node["value"], list):
        arr = np.asarray(node["value"], dtype=dtype)
    elif "data" in node:
        inner = node["data"]
        if isinstance(inner, (bytes, bytearray)):
            arr = np.frombuffer(bytes(inner), dtype=dtype)
        elif isinstance(inner, list):
            arr = np.asarray(inner, dtype=dtype)
        else:
            return None
    else:
        return None
    expected = int(np.prod(shape)) if shape else 1
    itemsize = np.dtype(dtype).itemsize
    if (
        arr.size == expected * itemsize
        and itemsize > 1
        and arr.size != expected
        and np.all((arr >= 0) & (arr <= 255))
        and np.all(arr == np.floor(arr))
    ):
        # rmp-serde encodes Vec<u8> without serde_bytes as a msgpack int
        # array: the list branch then holds RAW BYTES as numbers.
        # Reinterpret instead of misloading (count cross-check below
        # would otherwise reject f32 loudly but misload 1-byte dtypes).
        raw = np.asarray(arr, dtype=np.uint8).tobytes()
        arr = np.frombuffer(raw, dtype=dtype)
    if arr.size != expected:
        raise ValueError(
            f"Burn tensor leaf element count {arr.size} does not match "
            f"shape {shape} (expected {expected}, dtype {np.dtype(dtype).name})"
            " — unrecognized leaf encoding, refusing to misload"
        )
    return arr.reshape(shape).astype(np.float32)


def collect_tensors(obj: Any, path: Tuple = ()) -> Dict[Tuple, np.ndarray]:
    """All named tensors in a decoded record, keyed by structural path.

    Wrapper layers Burn interposes between the module field and the
    tensor (enum variant tags, ``param``/``id`` ParamSerde fields,
    ``item``/``data`` nesting) are descended through without extending
    the path, so paths read like ('layers', 0, 'weight')."""
    out: Dict[Tuple, np.ndarray] = {}
    if isinstance(obj, dict):
        t = _leaf_tensor(obj)
        if t is not None:
            out[path] = t
            return out
        for k, v in obj.items():
            if k == "id":
                continue
            # Transparent wrappers: serde enum variants and param boxes.
            if k in ("param", "item", "data", "value") or (
                isinstance(k, str) and k[:1].isupper()
            ):
                out.update(collect_tensors(v, path))
            else:
                out.update(collect_tensors(v, path + (k,)))
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            out.update(collect_tensors(v, path + (i,)))
    return out


# ---------------------------------------------------------------------------
# Mapping onto repo pytrees
# ---------------------------------------------------------------------------


def _get(tensors: Dict[Tuple, np.ndarray], *path) -> np.ndarray:
    if path in tensors:
        return tensors[path]
    raise KeyError(
        f"reference record is missing tensor {path}; "
        f"present: {sorted(tensors)[:20]}"
    )


def _linear(tensors, base: Tuple) -> Dict[str, np.ndarray]:
    return {
        "kernel": _get(tensors, *base, "weight"),  # [in, out], as burn stores
        "bias": _get(tensors, *base, "bias"),
    }


def _linear_stack(tensors, name: str) -> List[Dict[str, np.ndarray]]:
    layers = []
    i = 0
    while (name, i, "weight") in tensors:
        layers.append(_linear(tensors, (name, i)))
        i += 1
    return layers


def _conv(tensors, base: Tuple) -> Dict[str, np.ndarray]:
    w = _get(tensors, *base, "weight")  # OIHW (burn Conv2d)
    return {
        "kernel": np.transpose(w, (2, 3, 1, 0)),  # -> HWIO
        "bias": _get(tensors, *base, "bias"),
    }


def _conv_stack(tensors, name: str) -> List[Dict[str, np.ndarray]]:
    layers = []
    i = 0
    while (name, i, "weight") in tensors:
        layers.append(_conv(tensors, (name, i)))
        i += 1
    return layers


def _nchw_to_nhwc_rows(kernel: np.ndarray, h: int, w: int, c: int) -> np.ndarray:
    """Permute an FC kernel's input rows from the reference's NCHW
    flatten order (cnn.rs:255-262) to our NHWC flatten order. Rows past
    h*w*c (extra features appended after the flatten in both) stay."""
    spatial = h * w * c
    idx = np.arange(spatial)
    hh, ww, cc = idx // (w * c), (idx // c) % w, idx % c
    ref_rows = cc * h * w + hh * w + ww
    out = kernel.copy()
    out[:spatial] = kernel[ref_rows]
    return out


def params_from_record(record: Any, meta: Dict[str, Any]) -> Any:
    """Decoded model.mpk record + reference metadata -> repo param pytree."""
    tensors = collect_tensors(record)
    ntype = meta.get("network_type", "mlp")
    if ntype == "mlp":
        params = {
            "layers": _linear_stack(tensors, "layers"),
            "policy_head": _linear(tensors, ("policy_head",)),
            "value_head": _linear(tensors, ("value_head",)),
        }
        critic = _linear_stack(tensors, "critic_layers")
        if critic:
            params["critic_layers"] = critic
        return params
    if ntype == "ctde":
        return {
            "actor_layers": _linear_stack(tensors, "actor_layers"),
            "policy_head": _linear(tensors, ("policy_head",)),
            "critic_layers": _linear_stack(tensors, "critic_layers"),
            "value_head": _linear(tensors, ("value_head",)),
        }
    if ntype == "cnn":
        h, w, c = meta["obs_shape"]

        def fc_stack(name, conv_name):
            stack = _linear_stack(tensors, name)
            if stack:
                # Only the spatial prefix of the first FC kernel's rows is
                # permuted; its length is h*w*(last conv's out channels).
                ch = _conv_stack(tensors, conv_name)[-1]["kernel"].shape[-1]
                stack[0] = dict(stack[0])
                stack[0]["kernel"] = _nchw_to_nhwc_rows(
                    stack[0]["kernel"], h, w, ch
                )
            return stack

        params = {
            "conv_layers": _conv_stack(tensors, "conv_layers"),
            "fc_layers": fc_stack("fc_layers", "conv_layers"),
            "policy_head": _linear(tensors, ("policy_head",)),
            "value_head": _linear(tensors, ("value_head",)),
        }
        critic_conv = _conv_stack(tensors, "critic_conv_layers")
        if critic_conv:
            params["critic_conv_layers"] = critic_conv
            params["critic_fc_layers"] = fc_stack(
                "critic_fc_layers", "critic_conv_layers"
            )
        return params
    raise ValueError(f"unknown reference network_type '{ntype}'")


# ---------------------------------------------------------------------------
# Checkpoint-level entry
# ---------------------------------------------------------------------------


def load_reference_checkpoint(ckpt_dir: str | Path):
    """(network, params, obs_norm, metadata) from a reference checkpoint
    directory (model.mpk + metadata.json [+ normalizer.json]) — the
    import twin of CheckpointManager.load_model, enabling reference-
    trained models in eval/tournament (eval.rs:734)."""
    import jax
    import jax.numpy as jnp

    from burn_ppo_tpu.models.network import ActorCriticNetwork
    from burn_ppo_tpu.ppo.normalization import ObsNormState

    ckpt_dir = Path(ckpt_dir)
    meta = json.loads((ckpt_dir / "metadata.json").read_text())
    mpk = ckpt_dir / "model.mpk"
    if not mpk.exists():
        mpk = ckpt_dir / "model"  # burn writes the extension itself
    record = msgpack_decode(mpk.read_bytes())
    params_np = params_from_record(record, meta)

    network = ActorCriticNetwork(
        network_type=meta.get("network_type", "mlp"),
        obs_dim=int(meta["obs_dim"]),
        action_count=int(meta["action_count"]),
        hidden_size=int(meta["hidden_size"]),
        num_hidden=int(meta["num_hidden"]),
        activation=meta.get("activation", "tanh"),
        split_networks=bool(meta.get("split_networks", False)),
        privileged_obs_dim=meta.get("privileged_obs_dim"),
        critic_hidden_size=meta.get("critic_hidden_size"),
        critic_num_hidden=meta.get("critic_num_hidden"),
        obs_shape=tuple(meta["obs_shape"]) if meta.get("obs_shape") else None,
        num_conv_layers=int(meta.get("num_conv_layers", 2)),
        conv_channels=tuple(meta.get("conv_channels", (8, 8))),
        kernel_size=int(meta.get("kernel_size", 3)),
        cnn_fc_hidden_size=int(meta.get("cnn_fc_hidden_size", 32)),
        cnn_num_fc_layers=int(meta.get("cnn_num_fc_layers", 1)),
    )
    # Shape-check against a template init before accepting.
    template = jax.eval_shape(network.init, jax.random.PRNGKey(0))
    t_leaves, t_def = jax.tree_util.tree_flatten(template)
    p_leaves, p_def = jax.tree_util.tree_flatten(params_np)
    if t_def != p_def:
        raise ValueError(
            f"imported record structure does not match {network.network_type} "
            f"template: {p_def} vs {t_def}"
        )
    for tl, pl in zip(t_leaves, p_leaves):
        if tuple(tl.shape) != tuple(pl.shape):
            raise ValueError(
                f"imported tensor shape {pl.shape} != expected {tl.shape}"
            )
    params = jax.tree_util.tree_map(jnp.asarray, params_np)

    return network, params, load_reference_obs_norm(ckpt_dir), meta


def load_reference_obs_norm(ckpt_dir: str | Path):
    """Obs normalizer from a reference checkpoint's ``normalizer.json``
    alone (presence signals normalize_obs, checkpoint.rs:428-439) — the
    cheap path for callers that don't need the model decoded (the full
    model.mpk msgpack walk is ~1000x the work of this one JSON read)."""
    import jax.numpy as jnp

    from burn_ppo_tpu.ppo.normalization import ObsNormState

    norm_path = Path(ckpt_dir) / "normalizer.json"
    if not norm_path.exists():
        return None
    nj = json.loads(norm_path.read_text())
    return ObsNormState(
        mean=jnp.asarray(nj["mean"], jnp.float32),
        m2=jnp.asarray(nj["var"], jnp.float32),  # M2 (normalization.rs:28)
        count=jnp.asarray(nj["count"], jnp.float32),
    )
