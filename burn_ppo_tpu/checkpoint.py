"""Checkpointing: atomic step directories + latest/best symlinks.

Layout parity with the reference (src/checkpoint.rs:147-490):

    runs/<run>/checkpoints/step_00012345/
        model.npz                 (parameter pytree leaves)
        optimizer.npz             (Adam moments)
        train_state.npz           (normalizer states + PRNG keys)
        metadata.json             (arch + env + bookkeeping)
    runs/<run>/checkpoints/latest -> step_00012345
    runs/<run>/checkpoints/best   -> step_...

Writes are atomic (tmp dir + rename, checkpoint.rs:156-177); symlink
updates are atomic via a temp link + rename (checkpoint.rs:298-320).
Pytrees are serialized as ordered npz leaf lists and restored against a
template built from metadata — loading rebuilds the network from
``metadata.json`` exactly like the reference (checkpoint.rs:195-272).
"""

from __future__ import annotations

import io
import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from burn_ppo_tpu.models.network import ActorCriticNetwork

CHECKPOINT_DIR_PREFIX = "step_"


# ---------------------------------------------------------------------------
# Pytree <-> npz
# ---------------------------------------------------------------------------
def save_pytree(path: Path, tree: Any) -> None:
    leaves = jax.tree_util.tree_leaves(tree)
    arrays = {f"leaf_{i:05d}": np.asarray(leaf) for i, leaf in enumerate(leaves)}
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    path.write_bytes(buf.getvalue())


# ---------------------------------------------------------------------------
# Single-transfer device fetch
# ---------------------------------------------------------------------------
# A checkpoint's ~100+ leaves fetched one np.asarray at a time pay one
# device round trip EACH — on a remote or busy device that stall can
# dominate training wall clock (the reference
# never hits this: its state already lives host-side, checkpoint.rs
# serializes from RAM). Packing every leaf into one on-device byte
# buffer makes the whole checkpoint ONE transfer; the host then splits
# it back into leaves by precomputed (offset, dtype, shape).

_pack_cache: Dict[Any, Any] = {}


def _bitcast_u8(leaf: jax.Array) -> jax.Array:
    x = leaf.ravel()
    if x.dtype == jnp.bool_:
        x = x.astype(jnp.uint8)
    if x.dtype == jnp.uint8:
        return x
    # NB: every chunk must be EXACTLY uint8 — concatenating e.g. int8
    # with uint8 would silently type-promote the packed buffer to int16
    # and double every byte offset.
    return jax.lax.bitcast_convert_type(x, jnp.uint8).ravel()


def fetch_tree(tree: Any) -> Any:
    """device -> host copy of a pytree in ONE device transfer.

    Returns a tree of np.ndarrays with identical structure/dtypes/shapes.
    Old-style uint32 PRNG key arrays pack like any other leaf; leaves
    with extended dtypes (new-style typed keys, which bitcast can't
    take) and host numpy/python leaves pass through np.asarray
    individually."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    if jax.process_count() > 1:
        # Multihost: save() runs on host 0 only; a one-process jit over
        # global arrays would deadlock the others. Per-leaf np.asarray
        # reads the addressable replica without a collective.
        return jax.tree_util.tree_unflatten(
            treedef,
            [np.asarray(l) if hasattr(l, "dtype") else l for l in leaves],
        )
    # Pack only device (jax.Array) leaves: host numpy/python leaves need
    # no fetch, and jit would silently canonicalize their dtypes (e.g.
    # int64 -> int32), corrupting the host-side byte offsets.
    arr_idx = [
        i
        for i, l in enumerate(leaves)
        if isinstance(l, jax.Array)
        and int(np.prod(l.shape)) > 0
        and not jax.dtypes.issubdtype(l.dtype, jax.dtypes.extended)
    ]
    if not arr_idx:
        return jax.tree_util.tree_unflatten(
            treedef,
            [np.asarray(l) if hasattr(l, "dtype") else l for l in leaves],
        )
    metas = tuple(
        (np.dtype(leaves[i].dtype), tuple(leaves[i].shape)) for i in arr_idx
    )
    key = (treedef, tuple(arr_idx), metas)
    packer = _pack_cache.get(key)
    if packer is None:
        def _pack(ls):
            return jnp.concatenate([_bitcast_u8(l) for l in ls])

        packer = jax.jit(_pack)
        _pack_cache[key] = packer
    flat = np.asarray(packer([leaves[i] for i in arr_idx]))  # one transfer
    total = sum(int(np.prod(s)) * dt.itemsize for dt, s in metas)
    if flat.dtype != np.uint8 or flat.size != total:
        raise AssertionError(
            f"packed fetch corrupted: dtype={flat.dtype} size={flat.size} "
            f"expected uint8 x {total}"
        )
    out = list(leaves)
    off = 0
    for i, (dt, shape) in zip(arr_idx, metas):
        n = int(np.prod(shape)) * dt.itemsize
        seg = flat[off : off + n]
        off += n
        if dt == np.bool_:
            arr = seg.view(np.uint8).astype(np.bool_).reshape(shape)
        else:
            arr = seg.view(dt).reshape(shape)
        out[i] = arr
    idx_set = set(arr_idx)
    for i, l in enumerate(leaves):
        if i not in idx_set:
            out[i] = np.asarray(l) if hasattr(l, "dtype") else l
    return jax.tree_util.tree_unflatten(treedef, out)


_unpack_cache: Dict[Any, Any] = {}


def put_tree(tree: Any) -> Any:
    """host -> device copy of a pytree in ONE device transfer.

    The upload mirror of fetch_tree: per-leaf jnp.asarray pays one
    device round trip per leaf (a resumed run uploads ~100 checkpoint
    leaves + ~30 per pool opponent — minutes of a supervisor respawn on
    a remote device). Here the host packs every array leaf into one
    uint8 buffer; a jitted unpacker bitcasts static slices back into
    the leaves on device."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    if jax.process_count() > 1:
        # Multihost: keep uploads collective-free and trivially correct
        # (Gloo CPU meshes — transfer cost is irrelevant there).
        return jax.tree_util.tree_unflatten(
            treedef,
            [jnp.asarray(l) if hasattr(l, "dtype") else l for l in leaves],
        )
    arr_idx = [
        i
        for i, l in enumerate(leaves)
        if hasattr(l, "dtype")
        and not isinstance(l, jax.Array)
        and int(np.prod(getattr(l, "shape", ()))) > 0
    ]
    if not arr_idx:
        return jax.tree_util.tree_unflatten(
            treedef,
            [
                jnp.asarray(l) if hasattr(l, "dtype") else l
                for l in leaves
            ],
        )
    # 64-bit host leaves land on device in JAX's canonical dtype
    # (int64 -> int32 unless x64 is enabled); resolve it host-side —
    # an empty jnp.asarray probe would pay a device dispatch per leaf
    # per call, in the function that exists to collapse round trips.
    metas = tuple(
        (
            np.dtype(
                jax.dtypes.canonicalize_dtype(np.asarray(leaves[i]).dtype)
            ),
            tuple(np.asarray(leaves[i]).shape),
        )
        for i in arr_idx
    )
    chunks = []
    for i, (dt, shape) in zip(arr_idx, metas):
        a = np.ascontiguousarray(np.asarray(leaves[i]), dtype=dt)
        chunks.append(a.view(np.uint8).ravel())
    flat = np.concatenate(chunks)
    key = (treedef, tuple(arr_idx), metas)
    unpacker = _unpack_cache.get(key)
    if unpacker is None:
        def _unpack(buf):
            out, off = [], 0
            for dt, shape in metas:
                n = int(np.prod(shape)) * dt.itemsize
                seg = buf[off : off + n]
                off += n
                if dt == np.bool_:
                    leaf = seg.astype(jnp.bool_)
                elif dt.itemsize == 1:
                    leaf = jax.lax.bitcast_convert_type(
                        seg, jnp.dtype(dt)
                    )
                else:
                    leaf = jax.lax.bitcast_convert_type(
                        seg.reshape(-1, dt.itemsize), jnp.dtype(dt)
                    )
                out.append(leaf.reshape(shape))
            return out

        unpacker = jax.jit(_unpack)
        _unpack_cache[key] = unpacker
    device_leaves = unpacker(flat)  # flat is the one transfer
    out = list(leaves)
    for j, i in enumerate(arr_idx):
        out[i] = device_leaves[j]
    idx_set = set(arr_idx)
    for i, l in enumerate(leaves):
        if i not in idx_set and hasattr(l, "dtype"):
            out[i] = jnp.asarray(l) if not isinstance(l, jax.Array) else l
    return jax.tree_util.tree_unflatten(treedef, out)


def load_pytree(path: Path, template: Any) -> Any:
    """Restore a pytree saved by save_pytree using ``template``'s structure."""
    with np.load(io.BytesIO(path.read_bytes())) as data:
        leaves = [data[f"leaf_{i:05d}"] for i in range(len(data.files))]
    treedef = jax.tree_util.tree_structure(template)
    t_leaves = jax.tree_util.tree_leaves(template)
    if len(leaves) != len(t_leaves):
        raise ValueError(
            f"Checkpoint at {path} has {len(leaves)} leaves; template expects "
            f"{len(t_leaves)} (architecture mismatch?)"
        )
    # Cast host-side, then upload the whole file in ONE device transfer
    # (see put_tree) — a resume touches model+optimizer+aux files whose
    # ~100 combined leaves would otherwise each pay a device round trip.
    cast = [
        np.asarray(leaf, dtype=np.dtype(t.dtype)) if hasattr(t, "dtype") else leaf
        for leaf, t in zip(leaves, t_leaves)
    ]
    return put_tree(jax.tree_util.tree_unflatten(treedef, cast))


def _atomic_symlink(link: Path, target: str) -> None:
    tmp = link.parent / f".{link.name}.tmp"
    if tmp.exists() or tmp.is_symlink():
        tmp.unlink()
    tmp.symlink_to(target)
    tmp.rename(link)


# ---------------------------------------------------------------------------
# Metadata
# ---------------------------------------------------------------------------
def build_metadata(
    *,
    step: int,
    env_name: str,
    network: ActorCriticNetwork,
    num_players: int,
    avg_return: float = 0.0,
    best_avg_return: Optional[float] = None,
    recent_returns=(),
    forked_from: Optional[str] = None,
    rng_seed: int = 0,
    exploitability_vs_pool: Optional[float] = None,
    normalize_obs: bool = False,
    normalize_values: bool = False,
) -> Dict[str, Any]:
    """Full architecture + bookkeeping record (checkpoint.rs:26-96)."""
    return {
        "normalize_obs": bool(normalize_obs),
        "normalize_values": bool(normalize_values),
        "step": int(step),
        "avg_return": float(avg_return),
        "rng_seed": int(rng_seed),
        "best_avg_return": (
            None if best_avg_return is None else float(best_avg_return)
        ),
        "recent_returns": [float(r) for r in recent_returns],
        "forked_from": forked_from,
        "obs_dim": network.obs_dim,
        "action_count": network.action_count,
        "num_players": int(num_players),
        "hidden_size": network.hidden_size,
        "num_hidden": network.num_hidden,
        "activation": network.activation,
        "split_networks": network.split_networks,
        "network_type": network.network_type,
        "num_conv_layers": network.num_conv_layers,
        "conv_channels": list(network.conv_channels),
        "kernel_size": network.kernel_size,
        "cnn_fc_hidden_size": network.cnn_fc_hidden_size,
        "cnn_num_fc_layers": network.cnn_num_fc_layers,
        "privileged_obs_dim": network.privileged_obs_dim,
        "critic_hidden_size": network.critic_hidden_size,
        "critic_num_hidden": network.critic_num_hidden,
        "obs_shape": list(network.obs_shape) if network.obs_shape else None,
        "env_name": env_name,
        "exploitability_vs_pool": (
            None
            if exploitability_vs_pool is None
            else float(exploitability_vs_pool)
        ),
    }


def network_from_metadata(meta: Dict[str, Any]) -> ActorCriticNetwork:
    """Rebuild the network description from metadata (checkpoint.rs:195-272)."""
    return ActorCriticNetwork(
        network_type=meta.get("network_type", "mlp"),
        obs_dim=meta["obs_dim"],
        action_count=meta["action_count"],
        hidden_size=meta["hidden_size"],
        num_hidden=meta["num_hidden"],
        activation=meta["activation"],
        split_networks=meta.get("split_networks", False),
        privileged_obs_dim=meta.get("privileged_obs_dim"),
        critic_hidden_size=meta.get("critic_hidden_size"),
        critic_num_hidden=meta.get("critic_num_hidden"),
        obs_shape=tuple(meta["obs_shape"]) if meta.get("obs_shape") else None,
        num_conv_layers=meta.get("num_conv_layers", 2),
        conv_channels=tuple(meta.get("conv_channels", (8, 8))),
        kernel_size=meta.get("kernel_size", 3),
        cnn_fc_hidden_size=meta.get("cnn_fc_hidden_size", 32),
        cnn_num_fc_layers=meta.get("cnn_num_fc_layers", 1),
    )


# ---------------------------------------------------------------------------
# Manager
# ---------------------------------------------------------------------------
class CheckpointManager:
    """Save/load/enumerate checkpoints under ``<run_dir>/checkpoints``."""

    def __init__(self, run_dir: str | Path):
        self.dir = Path(run_dir) / "checkpoints"
        self.dir.mkdir(parents=True, exist_ok=True)

    # -- paths ----------------------------------------------------------
    def step_dir(self, step: int) -> Path:
        return self.dir / f"{CHECKPOINT_DIR_PREFIX}{step:08d}"

    def list_steps(self) -> list:
        steps = []
        for p in self.dir.iterdir():
            if p.is_dir() and p.name.startswith(CHECKPOINT_DIR_PREFIX):
                suffix = p.name[len(CHECKPOINT_DIR_PREFIX):]
                if suffix.isdigit():
                    steps.append(int(suffix))
        return sorted(steps)

    def resolve(self, which: str = "latest") -> Optional[Path]:
        """Resolve 'latest' / 'best' / 'step_NNN' / a step int to a dir."""
        cand = self.dir / str(which)
        if cand.exists():
            return cand.resolve()
        if str(which).isdigit():
            p = self.step_dir(int(which))
            return p if p.exists() else None
        return None

    # -- save / load ------------------------------------------------------
    def save(
        self,
        step: int,
        params: Any,
        opt_state: Any,
        aux_state: Dict[str, Any],
        metadata: Dict[str, Any],
    ) -> Path:
        """aux_state: component name -> pytree (or None to skip). Each
        component is its own file, mirroring the reference's separate
        normalizer.json / return_normalizer.json / popart_normalizer.json
        / rng_state.bin (checkpoint.rs:379-490)."""
        final = self.step_dir(step)
        tmp = Path(
            tempfile.mkdtemp(prefix=f".tmp_{CHECKPOINT_DIR_PREFIX}{step}_", dir=self.dir)
        )
        # One device transfer for the whole checkpoint (see fetch_tree);
        # the npz writes below then serialize pure host arrays.
        host = fetch_tree(
            {
                "model": params,
                "optimizer": opt_state,
                "aux": {k: v for k, v in aux_state.items() if v is not None},
            }
        )
        parked = None
        try:
            save_pytree(tmp / "model.npz", host["model"])
            save_pytree(tmp / "optimizer.npz", host["optimizer"])
            for name, tree in host["aux"].items():
                save_pytree(tmp / f"{name}.npz", tree)
            (tmp / "metadata.json").write_text(json.dumps(metadata, indent=2))
            if final.exists():
                # Overwrite (supervisor child re-saving its resume step):
                # park the old dir with an atomic rename FIRST, so the
                # vulnerable window is two instant renames — not a long
                # rmtree — and a crash in between leaves the previous
                # data recoverable in step_N.old instead of gone. ".old"
                # fails the step-dir digit check, so scans ignore it.
                old = final.with_name(final.name + ".old")
                if old.exists():
                    shutil.rmtree(old)
                final.rename(old)
                parked = old
                tmp.rename(final)
                parked = None
                shutil.rmtree(old, ignore_errors=True)
            else:
                tmp.rename(final)
        except Exception:
            shutil.rmtree(tmp, ignore_errors=True)
            # Rollback: if the old dir was parked but the new one never
            # landed, restore it — otherwise the step dir is gone and
            # 'latest' dangles, which resolve() treats as missing.
            if parked is not None and not final.exists():
                try:
                    parked.rename(final)
                except OSError:
                    pass
            raise
        self.set_latest(step)
        return final

    def set_latest(self, step: int) -> None:
        _atomic_symlink(self.dir / "latest", self.step_dir(step).name)

    def set_best(self, step: int) -> None:
        """Manual best selection, rating-driven for multiplayer
        (checkpoint.rs:286-295)."""
        _atomic_symlink(self.dir / "best", self.step_dir(step).name)

    @staticmethod
    def load_metadata(ckpt_dir: str | Path) -> Dict[str, Any]:
        return json.loads((Path(ckpt_dir) / "metadata.json").read_text())

    @staticmethod
    def is_reference_checkpoint(ckpt_dir: str | Path) -> bool:
        """A reference (burn-ppo) checkpoint: Burn NamedMpk model file
        instead of model.npz (checkpoint.rs:195-272)."""
        d = Path(ckpt_dir)
        return not (d / "model.npz").exists() and (
            (d / "model.mpk").exists() or (d / "model").exists()
        )

    @staticmethod
    def load_model(ckpt_dir: str | Path) -> Tuple[ActorCriticNetwork, Any, Dict[str, Any]]:
        """(network, params, metadata) — the eval/tournament entry point
        (reference eval.rs:734 load_model_from_checkpoint). Reference
        NamedMpk checkpoints route through burn_ppo_tpu.interop, so a
        reference-trained model can enter eval/tournaments directly."""
        ckpt_dir = Path(ckpt_dir)
        if CheckpointManager.is_reference_checkpoint(ckpt_dir):
            from burn_ppo_tpu.interop import load_reference_checkpoint

            network, params, _obs_norm, meta = load_reference_checkpoint(
                ckpt_dir
            )
            return network, params, meta
        meta = CheckpointManager.load_metadata(ckpt_dir)
        network = network_from_metadata(meta)
        # Shapes/dtypes only — eval_shape avoids running the real
        # orthogonal init (device work whose values load_pytree discards;
        # eval/tournament/pool rotations load dozens of checkpoints).
        template = jax.eval_shape(network.init, jax.random.PRNGKey(0))
        params = load_pytree(ckpt_dir / "model.npz", template)
        return network, params, meta

    @staticmethod
    def load_component(ckpt_dir: str | Path, name: str, template: Any) -> Any:
        """Load one aux component (e.g. 'obs_norm'); returns the template's
        None if the file is absent (feature disabled when saved)."""
        path = Path(ckpt_dir) / f"{name}.npz"
        if not path.exists():
            return None
        return load_pytree(path, template)

    @staticmethod
    def load_optimizer(ckpt_dir: str | Path, template: Any) -> Any:
        return load_pytree(Path(ckpt_dir) / "optimizer.npz", template)

    @staticmethod
    def load_obs_normalizer(ckpt_dir: str | Path):
        """Obs normalizer for inference-time use (eval/tournament), or
        None if the checkpoint trained without normalize_obs."""
        from burn_ppo_tpu.ppo.normalization import ObsNormState

        if CheckpointManager.is_reference_checkpoint(ckpt_dir):
            # Reference checkpoints signal the normalizer by the file's
            # presence (normalizer.json, checkpoint.rs:428-439); read it
            # directly rather than msgpack-decoding the whole model.mpk.
            from burn_ppo_tpu.interop import load_reference_obs_norm

            return load_reference_obs_norm(ckpt_dir)
        meta = CheckpointManager.load_metadata(ckpt_dir)
        if not meta.get("normalize_obs"):
            return None
        return CheckpointManager.load_component(
            ckpt_dir, "obs_norm", ObsNormState.create(meta["obs_dim"])
        )
