"""Same program, two JAX backends: a numerical parity check.

No hand-written kernel sits on the training path, so the plain reference
for a device run is the same program on the CPU. Two processes, one per
backend, exchange ``.npz`` files:

    python -m burn_ppo_tpu.parity device
        one JSON line: platform, device_kind and count of the default
        backend.
    python -m burn_ppo_tpu.parity run -c CONFIG --num-envs E --out REF.npz
        reference side: init params from the config's seed, collect one
        rollout, and store it with the outputs computed from it.
    python -m burn_ppo_tpu.parity run -c CONFIG --num-envs E \\
            --inputs REF.npz --out DEV.npz
        device side: the same outputs from the reference's inputs, plus
        this backend's own rollout from the same seed.
    python -m burn_ppo_tpu.parity compare REF.npz DEV.npz
        one JSON report; exit 1 on a mismatch.

What is compared, all on one rollout of the config's env and network:
  (a) policy logits and values of the rollout's observations;
  (b) GAE advantages and returns of the rollout;
  (c) one full PPO update (every epoch and minibatch): its metrics and
      the L1 norm of the updated parameters;
  (d) the share of identical sampled actions when each backend collects
      the rollout itself (Gumbel argmax near-ties may flip).
(a)-(c) run under ``jax.default_matmul_precision("highest")`` and must
agree to |Δ| <= 1e-4 * (1 + |ref|): relative for large values, absolute
near zero, where a mean of cancelling terms (the policy loss of
normalized advantages) keeps only absolute accuracy. The clip fraction
is the exception: it is a share of per-sample threshold decisions
(|ratio - 1| > clip) taken after every Adam step of the update, and one
ulp of noise flips some of them. On the CPU, the reference against
itself with its parameters scaled by (1 + 1.2e-7..5e-7 * N(0, 1))
moved the skull-CTDE clip fraction by up to 4.7e-4 (31 of 65,536
decisions; 14 draws over seeds 17 and 19) while every continuous
output stayed within 1e-5; its bar is therefore 1e-3. It cannot tell TF32 from
float32, so the other outputs carry that check. The device side also
reports, for information only, how far each output drifts under JAX's
default precision (TF32 matmuls on recent NVIDIA GPUs), and which bars
that drift would break.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict

import numpy as np

TOLERANCE = 1e-4
# Per-output exceptions: shares of thresholded per-sample decisions.
COUNT_TOLERANCE = {"c/clip_fraction": 1e-3}
MIN_SAME_ACTIONS = 0.999


def _device_info() -> dict:
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def _build(config_path: str, num_envs: int, num_steps: int | None):
    from burn_ppo_tpu.config import Config
    from burn_ppo_tpu.envs import make_env
    from burn_ppo_tpu.ppo.update import make_optimizer
    from burn_ppo_tpu.train import _update_cfg, build_network_for_env

    overrides = {"num_envs": num_envs}
    if num_steps:
        overrides["num_steps"] = num_steps
    cfg = Config.load(config_path).apply_overrides(overrides)
    env = make_env(cfg.env)
    if env.spec.variable_player_count:
        env = env.with_num_players(cfg.player_count.get_fixed_count())
    network = build_network_for_env(env, cfg)
    return cfg, env, network, make_optimizer(_update_cfg(cfg))


def _rollout_fn(cfg, env, network):
    """Seeded fresh params + one rollout: (params, batch, last_vpp, data)."""
    import jax

    from burn_ppo_tpu.ppo.normalization import ObsNormState
    from burn_ppo_tpu.ppo.rollout import (
        bootstrap_values,
        collect_rollouts,
        init_rollout_carry,
    )
    from burn_ppo_tpu.train import TrainState, _prepare_update

    normalize_returns = cfg.effective_normalize_returns(env.spec.num_players)

    def rollout(seed_key):
        k_params, k_carry = jax.random.split(seed_key)
        params = network.init(k_params)
        carry = init_rollout_carry(env, cfg.num_envs, k_carry)
        obs_norm = (ObsNormState.create(env.spec.obs_dim)
                    if cfg.normalize_obs else None)
        carry, batch, _ = collect_rollouts(
            network, env, params, carry, obs_norm, None,
            num_steps=cfg.num_steps, gamma=cfg.gamma,
            normalize_returns=normalize_returns, return_clip=cfg.return_clip,
        )
        state = TrainState(params=params, opt_state=None, carry=carry,
                           obs_norm=obs_norm, popart=None,
                           update_key=seed_key)
        obs_norm_new, data = _prepare_update(
            network, env, cfg, state, carry, batch)
        _, last_vpp = bootstrap_values(
            network, env, params, carry, obs_norm_new, None)
        return params, batch, last_vpp, data

    return rollout


def _outputs_fn(cfg, env, network, tx):
    """Outputs (a)-(c) from given params, rollout and update data."""
    import jax
    import jax.numpy as jnp

    from burn_ppo_tpu.ops.gae import compute_gae, compute_gae_multiplayer
    from burn_ppo_tpu.ppo.update import ppo_update
    from burn_ppo_tpu.train import _update_cfg

    ucfg = _update_cfg(cfg)
    lr = jnp.float32(cfg.learning_rate.get(0))
    ent_coef = jnp.float32(cfg.entropy_coef.get(0))

    def outputs(params, rollout, data, update_key):
        logits, values = network.policy_and_value(
            params, data["obs"], data.get("privileged_obs"))
        if env.spec.num_players > 1:
            adv, ret = compute_gae_multiplayer(
                rollout["all_rewards"], rollout["values"], rollout["dones"],
                rollout["acting_players"], rollout["last_vpp"],
                cfg.gamma, cfg.gae_lambda)
        else:
            adv, ret = compute_gae(
                rollout["rewards"], rollout["values"], rollout["dones"],
                rollout["last_vpp"][:, 0], cfg.gamma, cfg.gae_lambda)
        new_params, _, _, metrics = ppo_update(
            network, tx, params, tx.init(params), data, None, update_key,
            lr, ent_coef, ucfg)
        out = {"a/logits": logits, "a/values": values,
               "b/advantages": adv, "b/returns": ret,
               "c/params_l1": sum(jnp.sum(jnp.abs(x)) for x in
                                  jax.tree_util.tree_leaves(new_params))}
        out.update({f"c/{k}": v for k, v in metrics.items()})
        return out

    return outputs


_ROLLOUT_FIELDS = ("all_rewards", "rewards", "values", "dones",
                   "acting_players", "actions")


def run(config_path: str, num_envs: int, out_path: str,
        inputs_path: str | None = None, num_steps: int | None = None) -> None:
    """One side of the check; writes inputs (reference side) and outputs."""
    import jax

    cfg, env, network, tx = _build(config_path, num_envs, num_steps)
    seed_key = jax.random.PRNGKey(cfg.seed if cfg.seed is not None else 0)
    rollout = jax.jit(_rollout_fn(cfg, env, network))
    outputs = jax.jit(_outputs_fn(cfg, env, network, tx))

    with jax.default_matmul_precision("highest"):
        params, batch, last_vpp, data = rollout(seed_key)
    saved: Dict[str, np.ndarray] = {"d/actions": np.asarray(batch.actions)}
    if inputs_path is None:
        rollout_in = {f: getattr(batch, f) for f in _ROLLOUT_FIELDS}
        rollout_in["last_vpp"] = last_vpp
        leaves = jax.tree_util.tree_leaves(params)
        saved.update({f"in/params/{i:03d}": np.asarray(x)
                      for i, x in enumerate(leaves)})
        saved.update({f"in/rollout/{k}": np.asarray(v)
                      for k, v in rollout_in.items()})
        saved.update({f"in/data/{k}": np.asarray(v) for k, v in data.items()})
    else:
        with np.load(inputs_path) as f:
            ref = {k: f[k] for k in f.files}
        treedef = jax.tree_util.tree_structure(params)
        params = jax.tree_util.tree_unflatten(
            treedef,
            [ref[f"in/params/{i:03d}"] for i in range(treedef.num_leaves)])
        rollout_in = {k[len("in/rollout/"):]: v for k, v in ref.items()
                      if k.startswith("in/rollout/")}
        data = {k[len("in/data/"):]: v for k, v in ref.items()
                if k.startswith("in/data/")}
    update_key = jax.random.fold_in(seed_key, 1)
    with jax.default_matmul_precision("highest"):
        out = outputs(params, rollout_in, data, update_key)
    saved.update({k: np.asarray(v) for k, v in out.items()})
    if inputs_path is not None:
        out = outputs(params, rollout_in, data, update_key)
        saved.update({f"default/{k}": np.asarray(v) for k, v in out.items()})
    np.savez(out_path, **saved)


def _deviation(got: np.ndarray, ref: np.ndarray) -> float:
    """max |got - ref| / (1 + |ref|) over the elements."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        return float("inf")
    if got.size == 0:
        return 0.0
    return float(np.max(np.abs(got - ref) / (1.0 + np.abs(ref))))


def compare(ref_path: str, dev_path: str) -> dict:
    """Report (a)-(d) for a device-side file against the reference."""
    with np.load(ref_path) as f:
        ref = {k: f[k] for k in f.files}
    with np.load(dev_path) as f:
        dev = {k: f[k] for k in f.files}
    keys = sorted(k for k in ref if k[:2] in ("a/", "b/", "c/"))
    missing = [k for k in keys if k not in dev]
    dev_by_key = {k: _deviation(dev[k], ref[k]) for k in keys if k in dev}
    default_drift = {k: _deviation(dev[f"default/{k}"], ref[k])
                     for k in keys if f"default/{k}" in dev}
    a_ref, a_dev = ref["d/actions"], dev["d/actions"]
    same = (float(np.mean(a_ref == a_dev))
            if a_ref.shape == a_dev.shape else 0.0)
    worst = max(dev_by_key, key=dev_by_key.get) if dev_by_key else None
    bar = {k: COUNT_TOLERANCE.get(k, TOLERANCE) for k in keys}
    report = {
        "highest": {
            "max_deviation": dev_by_key[worst] if worst else None,
            "worst": worst,
            "tolerance": TOLERANCE,
            "failed": sorted(
                k for k, d in dev_by_key.items() if not d <= bar[k])
            + missing,
            "by_key": dev_by_key,
        },
        "bars": bar,
        "same_actions": same,
        "min_same_actions": MIN_SAME_ACTIONS,
        "default_precision_drift": (
            max(default_drift.values()) if default_drift else None),
        "default_precision_worst": (
            max(default_drift, key=default_drift.get)
            if default_drift else None),
        "default_precision": {
            "by_key": default_drift,
            "over_bar": sorted(k for k, d in default_drift.items()
                               if not d <= bar[k]),
        },
    }
    report["ok"] = (not report["highest"]["failed"]
                    and same >= MIN_SAME_ACTIONS)
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m burn_ppo_tpu.parity")
    sub = parser.add_subparsers(dest="command", required=True)
    sub.add_parser("device")
    p = sub.add_parser("run")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--num-envs", type=int, required=True)
    p.add_argument("--num-steps", type=int)
    p.add_argument("--inputs")
    p.add_argument("--out", required=True)
    p = sub.add_parser("compare")
    p.add_argument("reference")
    p.add_argument("device")
    args = parser.parse_args(argv)
    if args.command == "device":
        print(json.dumps(_device_info()))
        return 0
    if args.command == "run":
        run(args.config, args.num_envs, args.out, args.inputs, args.num_steps)
        return 0
    report = compare(args.reference, args.device)
    print(json.dumps(report))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
