"""Headline benchmark: PPO training throughput (env steps/sec).

Three measurements, all full fused train steps (on-device rollout + GAE
+ PPO update) run as ONE jitted `lax.scan` so host dispatch/transport
stays out of the device-throughput number:

  1. cartpole — the reference's CartPole config shape
     (configs/cartpole.toml: 32 envs x 128 steps, hidden 64x2) scaled to
     4096 envs. This is the headline metric.
  2. selfplay_pool — Connect Four, hidden 512, K=8 stacked opponents,
     25% pool envs: guards the stacked-opponent einsum + reseat
     machinery against perf regressions.
  3. skull_ctde — the flagship config shape (Skull 4p, CTDE hidden
     512): guards the heaviest env's one-hot game logic.

MFU context: achieved model FLOP/s = analytic model FLOPs/env-step x
measured steps/s, as a fraction of the card's published peak from
``PEAKS`` (keyed by JAX's ``device_kind``; an unknown kind is an error).
float32 matmuls run at JAX's default precision, TF32 on Hopper, so the
TF32 peak is the divisor. Tiny MLPs are memory-bound, so single-digit
MFU is expected.

The bench measures a GPU only: without one it fails rather than print
CPU numbers under device metric names. The device (platform, kind,
count, power limit) goes to stderr.

Prints ONE JSON line: {"metric", "value", "unit", "extra"}.
"""

from __future__ import annotations

import json
import os
import sys
import time


# Published dense peaks, NVIDIA H100 SXM5 data sheet (no sparsity, at
# the 700 W power limit; a card set lower cannot hold its top clock).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_tflops": 989.0,
        "tf32_tflops": 495.0,
        "f32_tflops": 67.0,
        "hbm_tb_per_s": 3.35,
    },
}


def device_peaks(kind: str) -> dict:
    """Published peaks for a JAX ``device_kind``; unknown kinds raise."""
    if kind not in PEAKS:
        raise ValueError(
            f"no published peaks for device_kind {kind!r}; add the card "
            "to bench.PEAKS with its source"
        )
    return PEAKS[kind]


def gpu_device(jax) -> dict:
    """platform / kind / count of JAX's default device; not a GPU raises."""
    d = jax.devices()[0]
    if d.platform != "gpu":
        raise RuntimeError(
            f"bench.py measures a GPU; JAX's default device is {d.platform}"
            f" ({d.device_kind})"
        )
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def power_limits() -> str:
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return "; ".join(
        ln.strip() for ln in out.stdout.splitlines() if ln.strip()
    ) or "unknown"


REPEATS = int(os.environ.get("BENCH_REPEATS", "3"))


def _iters_env(name: str, default: str) -> int:
    """Parse an iteration-count override, clamped to >= 2: the
    (dt_N - dt_1)/(iters - 1) differencing in time_per_iter degenerates
    at iters=1 (runN == run1, the delta is pure noise clamped to 1e-9,
    and the headline becomes ~1e20 env-steps/s)."""
    iters = int(os.environ.get(name, default))
    if iters < 2:
        print(f"[bench] {name}={iters} < 2: clamping to 2 (differenced "
              "timing needs distinct 1- and N-iteration programs)",
              file=sys.stderr)
        iters = 2
    return iters


def time_per_iter(run1, runN, iters, *args):
    """Steady-state seconds per iteration: median of BENCH_REPEATS
    measurements plus their relative spread.

    Each measurement warms both programs, then (dt_N - dt_1)/(iters - 1)
    cancels the constant dispatch floor. The median + spread
    distinguish real regressions from run-to-run noise. Timing forces
    completion by fetching the scalar result.

    Returns (median_seconds_per_iter, spread_pct) with
    spread_pct = 100 * (max - min) / median over the repeats."""
    float(run1(*args))
    float(runN(*args))
    samples = []
    for _ in range(max(REPEATS, 1)):
        t0 = time.perf_counter()
        float(runN(*args))
        dt_n = time.perf_counter() - t0
        t0 = time.perf_counter()
        float(run1(*args))
        dt_1 = time.perf_counter() - t0
        samples.append(max((dt_n - dt_1) / max(iters - 1, 1), 1e-9))
    samples.sort()
    med = samples[len(samples) // 2]
    spread = 100.0 * (samples[-1] - samples[0]) / med
    return med, spread


def dense_fwd_flops(sizes) -> int:
    """2 * sum(in*out + out) over a dense stack."""
    total = 0
    for i, o in sizes:
        total += 2 * (i * o + o)
    return total


def bench_cartpole(jax, jnp):
    from burn_ppo_tpu.config import Config
    from burn_ppo_tpu.envs import make_env
    from burn_ppo_tpu.parallel.mesh import make_mesh, replicate, shard_rollout_carry
    from burn_ppo_tpu.ppo.normalization import ObsNormState
    from burn_ppo_tpu.ppo.rollout import init_rollout_carry
    from burn_ppo_tpu.ppo.update import PPOUpdateConfig, make_optimizer
    from burn_ppo_tpu.train import TrainState, build_network_for_env, make_train_step

    num_envs = int(os.environ.get("BENCH_NUM_ENVS", "4096"))
    num_steps = int(os.environ.get("BENCH_NUM_STEPS", "128"))
    iters = _iters_env("BENCH_ITERS", "100")

    cfg = Config(
        env="cartpole",
        num_envs=num_envs,
        num_steps=num_steps,
        total_steps=10**9,
        normalize_obs=True,
        hidden_size=64,
        num_hidden=2,
        num_minibatches=4,
        num_epochs=4,
        seed=0,
        opponent_pool_fraction=0.0,
    )
    mesh = make_mesh()
    env = make_env(cfg.env)
    network = build_network_for_env(env, cfg)
    tx = make_optimizer(
        PPOUpdateConfig(max_grad_norm=cfg.max_grad_norm, adam_epsilon=cfg.adam_epsilon)
    )
    key = jax.random.PRNGKey(0)
    k_params, k_carry, k_update = jax.random.split(key, 3)
    params = replicate(network.init(k_params), mesh)
    opt_state = replicate(tx.init(jax.device_get(params)), mesh)
    carry = shard_rollout_carry(init_rollout_carry(env, num_envs, k_carry), mesh)
    state = TrainState(
        params=params,
        opt_state=opt_state,
        carry=carry,
        obs_norm=replicate(ObsNormState.create(env.spec.obs_dim), mesh),
        popart=None,
        update_key=k_update,
    )
    train_step = make_train_step(network, env, cfg, tx, compact_stats=True)

    lr = jnp.asarray(1e-3, jnp.float32)
    ec = jnp.asarray(0.01, jnp.float32)
    sc = jnp.asarray(0.0, jnp.float32)

    # Episode summaries fold into a live checksum so XLA can't dead-code-
    # eliminate the bookkeeping the real Trainer consumes.
    def run_iters(state, n):
        def body(carry, _):
            s, acc = carry
            s2, metrics, stats = train_step(s, lr, ec, sc)
            acc = acc + stats["count"] + metrics["policy_loss"]
            return (s2, acc), None

        (s_final, acc), _ = jax.lax.scan(
            body, (state, jnp.zeros((), jnp.float32)), None, length=n
        )
        return acc

    run1 = jax.jit(lambda s: run_iters(s, 1))
    runN = jax.jit(lambda s: run_iters(s, iters))
    per_iter, spread = time_per_iter(run1, runN, iters, state)
    sps = num_envs * num_steps / per_iter

    # Analytic model FLOPs per env step: rollout forward (1x) + update
    # epochs x (fwd + ~2x fwd for bwd) over the same samples.
    h, d, a = cfg.hidden_size, env.spec.obs_dim, env.spec.num_actions
    fwd = dense_fwd_flops([(d, h), (h, h), (h, a), (h, 1)])
    flops_per_step = fwd * (1 + 3 * cfg.num_epochs)
    return sps, sps * flops_per_step, spread


def bench_selfplay_pool(jax, jnp):
    from burn_ppo_tpu.config import Config
    from burn_ppo_tpu.envs import make_env
    from burn_ppo_tpu.parallel.mesh import make_mesh, replicate, shard_rollout_carry
    from burn_ppo_tpu.ppo.pool_rollout import PoolSeating
    from burn_ppo_tpu.ppo.rollout import init_rollout_carry
    from burn_ppo_tpu.ppo.update import PPOUpdateConfig, make_optimizer
    from burn_ppo_tpu.train import (
        TrainState,
        build_network_for_env,
        make_pool_train_step,
    )

    E = int(os.environ.get("BENCH_SP_NUM_ENVS", "4096"))
    T = int(os.environ.get("BENCH_SP_NUM_STEPS", "64"))
    K = int(os.environ.get("BENCH_SP_OPPONENTS", "8"))
    iters = _iters_env("BENCH_SP_ITERS", "20")

    cfg = Config(
        env="connect_four", num_envs=E, num_steps=T, total_steps=10**9,
        hidden_size=512, num_hidden=2, num_minibatches=4, num_epochs=4,
        seed=0, clip_epsilon=0.1, opponent_pool_fraction=0.25,
    )
    mesh = make_mesh()
    env = make_env(cfg.env)
    net = build_network_for_env(env, cfg)
    tx = make_optimizer(
        PPOUpdateConfig(max_grad_norm=0.5, adam_epsilon=1e-5)
    )
    k = jax.random.split(jax.random.PRNGKey(0), 5)
    params = replicate(net.init(k[0]), mesh)
    opt = replicate(tx.init(jax.device_get(params)), mesh)
    carry = shard_rollout_carry(init_rollout_carry(env, E, k[1]), mesh)
    st = TrainState(
        params=params, opt_state=opt, carry=carry,
        obs_norm=None, popart=None, update_key=k[2],
    )
    L = E - E // 4
    seating = PoolSeating.create(E, L, 2, num_slots=K, key=k[3])
    opp = jax.tree_util.tree_map(
        lambda x: jnp.stack([x] * K), jax.device_get(params)
    )
    opp = replicate(opp, mesh)
    step = make_pool_train_step(net, env, cfg, tx, L, K)

    # ``opp`` enters as a jit ARGUMENT, never a closure: a closed-over
    # K-stacked hidden-512 tree would be baked into the compiled program
    # as a ~10MB constant.
    def run_iters(st, seating, opp, n):
        def body(c, _):
            s, seat, acc = c
            s2, seat2, m, stats, _pool = step(
                s, seat, opp, None,
                jnp.float32(1e-3), jnp.float32(0.05), jnp.float32(0.0),
            )
            return (s2, seat2, acc + m["policy_loss"] + stats["count"]), None

        (sf, seatf, acc), _ = jax.lax.scan(
            body, (st, seating, jnp.zeros(())), None, length=n
        )
        return acc

    run1 = jax.jit(lambda s, seat, o: run_iters(s, seat, o, 1))
    runN = jax.jit(lambda s, seat, o: run_iters(s, seat, o, iters))
    per_iter, sp_spread = time_per_iter(run1, runN, iters, st, seating, opp)
    sps = E * T / per_iter

    # Same config WITHOUT the pool — records the full vs-pool overhead
    # (stacked-opponent forwards + reseat machinery) as a ratio.
    from burn_ppo_tpu.train import make_train_step

    step_np = make_train_step(net, env, cfg, tx, compact_stats=True)

    def run_iters_np(st, n):
        def body(c, _):
            s, acc = c
            s2, m, stats = step_np(
                s, jnp.float32(1e-3), jnp.float32(0.05), jnp.float32(0.0)
            )
            return (s2, acc + m["policy_loss"] + stats["count"]), None

        (sf, acc), _ = jax.lax.scan(
            body, (st, jnp.zeros(())), None, length=n
        )
        return acc

    run1_np = jax.jit(lambda s: run_iters_np(s, 1))
    runN_np = jax.jit(lambda s: run_iters_np(s, iters))
    per_iter_np, _ = time_per_iter(run1_np, runN_np, iters, st)
    nopool_sps = E * T / per_iter_np

    # --- Windowed END-TO-END comparison: the
    # production pool path is a W=8 fused window per host call, plus the
    # real per-window host work (rotation re-stack, compacted-record
    # fetch + slice). Compare against the W=8 non-pool window with the
    # same host-call pattern.
    from burn_ppo_tpu.checkpoint import fetch_tree
    from burn_ppo_tpu.selfplay.opponent_pool import _stack_trees
    from burn_ppo_tpu.train import make_pool_train_window, make_train_window
    import numpy as _np

    W = int(os.environ.get("BENCH_SP_WINDOW", "8"))
    # K device-resident opponent trees, mirroring production: the pool
    # uploads each checkpoint to the device ONCE (_load_params_device)
    # and per-rotation stacking runs on device — not a ~24MB host
    # re-upload per window (which is what device_get'd trees would time).
    host_tree = jax.device_get(params)
    opps = [
        jax.tree_util.tree_map(jnp.asarray, host_tree) for _ in range(K)
    ]
    # No donation here: the same initial state feeds both window paths.
    win = jax.jit(make_pool_train_window(net, env, cfg, tx, L, K))
    lrs = jnp.full((W,), 1e-3, jnp.float32)
    ecs = jnp.full((W,), 0.05, jnp.float32)
    scs = jnp.zeros((W,), jnp.float32)

    def pool_window_call(s, seat):
        o = _stack_trees(opps)
        s, seat, m, stats, rec = win(s, seat, o, None, lrs, ecs, scs)
        # Production parity (train.py window loop): everything the host
        # reads this window comes back in ONE packed transfer.
        fetched = fetch_tree({"rec": rec, "stats": stats, "metrics": m})
        r = fetched["rec"]
        _rows = _np.asarray(r["rows"][: int(r["count"])], _np.int32)
        return s, seat

    s2, seat2 = pool_window_call(st, seating)  # compile
    s2, seat2 = pool_window_call(s2, seat2)  # layout-stable recompile
    reps = []
    for _ in range(max(REPEATS, 1)):
        t0 = time.perf_counter()
        s2, seat2 = pool_window_call(s2, seat2)
        reps.append(time.perf_counter() - t0)
    reps.sort()
    pool_windowed_sps = E * T * W / reps[len(reps) // 2]

    win_np = jax.jit(make_train_window(net, env, cfg, tx))

    def nopool_window_call(s):
        s, m, stats = win_np(s, lrs, ecs, scs)
        fetch_tree({"stats": stats, "metrics": m})
        return s

    s3 = nopool_window_call(st)
    s3 = nopool_window_call(s3)
    reps = []
    for _ in range(max(REPEATS, 1)):
        t0 = time.perf_counter()
        s3 = nopool_window_call(s3)
        reps.append(time.perf_counter() - t0)
    reps.sort()
    nopool_windowed_sps = E * T * W / reps[len(reps) // 2]

    # Learner fwd on all envs + K opponent fwds on the pool 25% + update.
    h, d, a = cfg.hidden_size, env.spec.obs_dim, env.spec.num_actions
    fwd = dense_fwd_flops([(d, h), (h, h), (h, a), (h, 1)])
    flops_per_step = fwd * (1 + 0.25 * K + 3 * cfg.num_epochs)
    return (
        sps, sps * flops_per_step, nopool_sps, sp_spread,
        pool_windowed_sps, nopool_windowed_sps,
    )


def bench_skull_ctde(jax, jnp, compute_dtype=None):
    """Flagship-config throughput: Skull 4p CTDE hidden-512 fused step.

    ``compute_dtype='bfloat16'`` measures the bf16 matmul path at
    production widths; docs/DESIGN.md records the
    adopt/falsify outcome."""
    from burn_ppo_tpu.config import Config
    from burn_ppo_tpu.envs import make_env
    from burn_ppo_tpu.parallel.mesh import make_mesh, replicate, shard_rollout_carry
    from burn_ppo_tpu.ppo.rollout import init_rollout_carry
    from burn_ppo_tpu.ppo.update import PPOUpdateConfig, make_optimizer
    from burn_ppo_tpu.train import TrainState, build_network_for_env, make_train_step

    E = int(os.environ.get("BENCH_SKULL_NUM_ENVS", "4096"))
    T = int(os.environ.get("BENCH_SKULL_NUM_STEPS", "64"))
    iters = _iters_env("BENCH_SKULL_ITERS", "10")

    cfg = Config(
        env="skull", player_count=4, network_type="ctde", num_envs=E,
        num_steps=T, total_steps=10**9, hidden_size=512, num_hidden=2,
        critic_hidden_size=512, critic_num_hidden=2, num_minibatches=4,
        num_epochs=4, seed=0, opponent_pool_fraction=0.0,
        compute_dtype=compute_dtype,
    )
    mesh = make_mesh()
    env = make_env("skull").with_num_players(4)
    net = build_network_for_env(env, cfg)
    tx = make_optimizer(PPOUpdateConfig(max_grad_norm=0.5, adam_epsilon=1e-5))
    k = jax.random.split(jax.random.PRNGKey(0), 3)
    params = replicate(net.init(k[0]), mesh)
    st = TrainState(
        params=params,
        opt_state=replicate(tx.init(jax.device_get(params)), mesh),
        carry=shard_rollout_carry(init_rollout_carry(env, E, k[1]), mesh),
        obs_norm=None, popart=None, update_key=k[2],
    )
    step = make_train_step(net, env, cfg, tx, compact_stats=True)

    def run_iters(st, n):
        def body(c, _):
            s, acc = c
            s2, m, stats = step(
                s, jnp.float32(3e-4), jnp.float32(0.05), jnp.float32(0.0)
            )
            return (s2, acc + m["policy_loss"] + stats["count"]), None

        (sf, acc), _ = jax.lax.scan(body, (st, jnp.zeros(())), None, length=n)
        return acc

    run1 = jax.jit(lambda s: run_iters(s, 1))
    runN = jax.jit(lambda s: run_iters(s, iters))
    per_iter, _ = time_per_iter(run1, runN, iters, st)
    sps = E * T / per_iter

    # Analytic model FLOPs per env step: rollout fwd (actor + critic for
    # GAE values) + epochs x (fwd + ~2x fwd for bwd) over the samples.
    h = cfg.hidden_size
    d, a = env.spec.obs_dim, env.spec.num_actions
    pd = env.spec.privileged_obs_dim
    fwd = dense_fwd_flops(
        [(d, h), (h, h), (h, a)]  # actor
        + [(pd + d, h), (h, h), (h, 1)]  # CTDE critic on cat(priv, obs)
    )
    flops_per_step = fwd * (1 + 3 * cfg.num_epochs)

    # NOTE: XLA's compiled cost_analysis() was evaluated here and
    # dropped — it counts a while/scan body ONCE, not trip-count times,
    # so for a T-step rollout + epoch-loop program it under-reports
    # FLOPs ~4x and would read as fake MFU. The analytic count above is
    # the honest one.
    return sps, sps * flops_per_step, {}


def main() -> int:
    import jax
    import jax.numpy as jnp

    # Progress to stderr (stdout stays the one JSON line): names the path
    # that was compiling if a run stalls.
    def note(msg: str) -> None:
        print(f"[bench] {msg} ({time.strftime('%H:%M:%S')})", file=sys.stderr)

    device = gpu_device(jax)
    peak_tflops = device_peaks(device["kind"])["tf32_tflops"]
    note(f"platform={device['platform']} device_kind={device['kind']} "
         f"count={device['count']} power={power_limits()}")
    note("cartpole: compiling + measuring")
    sps, flops, spread = bench_cartpole(jax, jnp)
    note(f"cartpole done: {sps/1e6:.1f}M sps; selfplay-pool next")
    (
        sp_sps, sp_flops, sp_nopool_sps, sp_spread,
        sp_windowed_sps, sp_nopool_windowed_sps,
    ) = bench_selfplay_pool(jax, jnp)
    note(f"selfplay-pool done: {sp_sps/1e6:.2f}M sps; skull-ctde next")
    skull_sps, skull_flops, skull_cost = bench_skull_ctde(jax, jnp)
    note(f"skull-ctde done: {skull_sps/1e6:.2f}M sps; bf16 variant next")
    skull_bf16_sps, _, _ = bench_skull_ctde(jax, jnp, compute_dtype="bfloat16")
    note("all paths done")

    extra = {
        "spread_pct": round(spread, 1),
        "selfplay_pool_sps": round(sp_sps, 1),
        "selfplay_pool_spread_pct": round(sp_spread, 1),
        "selfplay_nopool_sps": round(sp_nopool_sps, 1),
        "pool_overhead_pct": round(
            100.0 * (sp_nopool_sps / sp_sps - 1.0), 1
        ),
        # End-to-end W=8 windows incl. per-window host work (rotation
        # re-stack + compacted record fetch) — the production pool path.
        "selfplay_pool_windowed_sps": round(sp_windowed_sps, 1),
        "selfplay_nopool_windowed_sps": round(sp_nopool_windowed_sps, 1),
        "pool_windowed_overhead_pct": round(
            100.0 * (sp_nopool_windowed_sps / sp_windowed_sps - 1.0), 1
        ),
        "skull_ctde_sps": round(skull_sps, 1),
        "skull_ctde_bf16_sps": round(skull_bf16_sps, 1),
        "achieved_tflops": round(flops / 1e12, 3),
        "mfu_pct": round(100.0 * flops / (peak_tflops * 1e12), 3),
        "selfplay_achieved_tflops": round(sp_flops / 1e12, 3),
        "selfplay_mfu_pct": round(100.0 * sp_flops / (peak_tflops * 1e12), 3),
        "skull_achieved_tflops": round(skull_flops / 1e12, 3),
        "skull_ctde_mfu_pct": round(
            100.0 * skull_flops / (peak_tflops * 1e12), 3
        ),
        **skull_cost,
        "peak_tflops_tf32": peak_tflops,
        "device": device,
    }
    print(
        json.dumps(
            {
                "metric": "cartpole_train_env_steps_per_sec",
                "value": round(sps, 1),
                "unit": "env_steps/s",
                "extra": extra,
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
