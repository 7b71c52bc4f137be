"""Multi-host opponent-pool bookkeeping, tested with FAKED processes.

The multi-host pool design (train.py): every host keeps an identical
pool-stats replica; completed pool-game records are globalized with an
allgather each update; win-rate EMA folds run on every host in the same
order; the rotation-sampling rng is seed-locked — so rotations stay in
lockstep with NO name broadcasts. These tests simulate 2 hosts by
running two pool replicas side by side and merging their host-local
records the way ``allgather_rows`` does (concatenation in process
order).
"""

import json

import numpy as np
import pytest
from burn_ppo_tpu import struct

from burn_ppo_tpu.parallel.distributed import allgather_rows
from burn_ppo_tpu.selfplay.opponent_pool import OpponentPool
from burn_ppo_tpu.train import extract_pool_records


# ---------------------------------------------------------------------------
# record extraction (vectorized) vs a straight per-episode reference loop
# ---------------------------------------------------------------------------
class _Slice(struct.PyTreeNode):
    """Host-side stand-in for train.PoolRecordLog (flat fields)."""

    completed: np.ndarray
    outcome: np.ndarray
    learner_seat: np.ndarray
    seat_opp: np.ndarray


def _loop_reference(pool_slice, P):
    """The pre-vectorization per-episode loop (round-1 semantics)."""
    rows = []
    completed = np.asarray(pool_slice.completed)
    outcomes = np.asarray(pool_slice.outcome)
    seats = np.asarray(pool_slice.learner_seat)
    slots = np.asarray(pool_slice.seat_opp)
    for t, e in zip(*np.nonzero(completed)):
        seat = int(seats[t, e])
        if seat < 0:
            continue
        placements = outcomes[t, e]
        row = [int(placements[seat])]
        opp_s, opp_p = [], []
        for s in range(P):
            if s == seat:
                continue
            opp_s.append(int(slots[t, e, s]))
            opp_p.append(int(placements[s]))
        rows.append(row + opp_s + opp_p)
    return np.asarray(rows, np.int32).reshape(-1, 2 * P - 1)


def _random_slice(rng, T=7, E=5, P=4):
    return _Slice(
        completed=rng.random((T, E)) < 0.3,
        outcome=rng.integers(1, P + 1, size=(T, E, P)).astype(np.int8),
        learner_seat=rng.integers(-1, P, size=(T, E)).astype(np.int8),
        seat_opp=rng.integers(0, 3, size=(T, E, P)).astype(np.int8),
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_extract_matches_per_episode_loop(seed):
    rng = np.random.default_rng(seed)
    sl = _random_slice(rng)
    got = extract_pool_records(sl, 4)
    want = _loop_reference(sl, 4)
    np.testing.assert_array_equal(got, want)


def test_extract_empty_and_no_completions():
    sl = _Slice(
        completed=np.zeros((3, 2), bool),
        outcome=np.ones((3, 2, 2), np.int8),
        learner_seat=np.zeros((3, 2), np.int8),
        seat_opp=np.zeros((3, 2, 2), np.int8),
    )
    assert extract_pool_records(sl, 2).shape == (0, 3)


# ---------------------------------------------------------------------------
# allgather_rows: single-process identity
# ---------------------------------------------------------------------------
def test_allgather_rows_single_process_identity():
    rows = np.arange(12, dtype=np.int32).reshape(4, 3)
    np.testing.assert_array_equal(allgather_rows(rows, 3), rows)
    assert allgather_rows(np.zeros((0, 3), np.int32), 3).shape == (0, 3)


# ---------------------------------------------------------------------------
# 2-host lockstep: same global records + same seed => identical rotations
# ---------------------------------------------------------------------------
def _mk_pool(tmp_path, tag, persist, names=("step_00000100", "step_00000200",
                                            "step_00000300")):
    run = tmp_path / f"host_{tag}"
    run.mkdir(exist_ok=True)
    pool = OpponentPool(
        run, select_alpha=0.2, select_exponent=2.0, max_active=2,
        seed=7, persist=persist,
    )
    for i, n in enumerate(names):
        pool.add_checkpoint(n, (i + 1) * 100)
    return pool


def _fake_allgather(*host_rows):
    """2-host allgather_rows: concatenate in process order."""
    return np.concatenate([r for r in host_rows], axis=0)


def test_two_host_replicas_stay_in_lockstep(tmp_path):
    P = 3  # players
    host0 = _mk_pool(tmp_path, "a", persist=True)
    host1 = _mk_pool(tmp_path, "b", persist=False)
    rng = np.random.default_rng(0)
    names = list(host0.stats)

    for update in range(6):
        # Rotations sample BEFORE results fold, exactly like the train
        # loop; both replicas must pick the same active set.
        a0 = host0.sample_active()
        a1 = host1.sample_active()
        assert a0 == a1

        # Each host observes different local games.
        def local_rows(n):
            lp = rng.integers(1, P + 1, size=n)
            slots = rng.integers(0, len(a0), size=(n, P - 1))
            places = rng.integers(1, P + 1, size=(n, P - 1))
            return lp, slots, places

        r0 = local_rows(rng.integers(0, 4))
        r1 = local_rows(rng.integers(0, 4))
        # Globalize (same merged order on both hosts), fold on both.
        glp = np.concatenate([r0[0], r1[0]])
        gsl = np.concatenate([r0[1], r1[1]])
        gpl = np.concatenate([r0[2], r1[2]])
        for pool in (host0, host1):
            pool.queue_game_results_batch(a0, glp, gsl, gpl)
            pool.apply_pending_updates()

        for n in names:
            assert host0.stats[n].win_rate == host1.stats[n].win_rate
            assert host0.stats[n].games_played == host1.stats[n].games_played

    # Only the primary replica persisted stats.
    assert (tmp_path / "host_a" / "opponent_stats.json").exists()
    assert not (tmp_path / "host_b" / "opponent_stats.json").exists()


def test_batch_queue_matches_scalar_queue(tmp_path):
    """queue_game_results_batch == N x queue_game_result."""
    batch = _mk_pool(tmp_path, "batch", persist=False)
    scalar = _mk_pool(tmp_path, "scalar", persist=False)
    active = list(batch.stats)[:2]
    rng = np.random.default_rng(3)
    lp = rng.integers(1, 4, size=10)
    slots = rng.integers(-1, 3, size=(10, 2))  # includes stale (-1, 2) slots
    places = rng.integers(1, 4, size=(10, 2))

    batch.queue_game_results_batch(active, lp, slots, places)
    for i in range(10):
        names, pl = [], []
        for s, p in zip(slots[i], places[i]):
            if 0 <= s < len(active):
                names.append(active[s])
                pl.append(int(p))
        if names:
            scalar.queue_game_result(names, int(lp[i]), pl)
    assert batch._pending == scalar._pending
    for n in active:
        assert batch._recent_vs.get(n) == scalar._recent_vs.get(n)


def test_device_cached_rotation_matches_host_stacking(tmp_path):
    """The single-process device-cached rotation must produce the same
    stacked parameters as the multi-host host-array path, and the memo
    must pick up newly added checkpoints (names are step-unique)."""
    import jax
    import numpy as np_

    from burn_ppo_tpu.checkpoint import CheckpointManager, build_metadata
    from burn_ppo_tpu.models.network import ActorCriticNetwork

    run = tmp_path / "run"
    (run / "checkpoints").mkdir(parents=True)
    net = ActorCriticNetwork(
        network_type="mlp", obs_dim=5, action_count=2,
        hidden_size=8, num_hidden=1,
    )
    mgr = CheckpointManager(run)
    for i, step in enumerate((100, 200)):
        params = net.init(jax.random.PRNGKey(i))
        meta = build_metadata(
            step=step, env_name="cartpole", network=net, num_players=1,
            avg_return=0.0, best_avg_return=None, recent_returns=[],
            forked_from=None, rng_seed=0, normalize_obs=False,
            normalize_values=False, exploitability_vs_pool=None,
        )
        mgr.save(step, params, {"dummy": np_.zeros(1)}, {}, meta)

    pool = OpponentPool(run, max_active=2, seed=1)
    dev_stack, dev_norm, names = pool.refresh_rotation()

    pool2 = OpponentPool(run, max_active=2, seed=1)
    host_loaded = [pool2._load_params(n) for n in names]
    host_stack = jax.tree_util.tree_map(
        lambda *xs: np_.stack([np_.asarray(x) for x in xs]),
        *[p for p, _ in host_loaded],
    )
    for a, b in zip(
        jax.tree_util.tree_leaves(dev_stack),
        jax.tree_util.tree_leaves(host_stack),
    ):
        np_.testing.assert_array_equal(np_.asarray(a), b)

    # A new checkpoint changes the candidate set; rotation still works.
    params = net.init(jax.random.PRNGKey(9))
    meta = build_metadata(
        step=300, env_name="cartpole", network=net, num_players=1,
        avg_return=0.0, best_avg_return=None, recent_returns=[],
        forked_from=None, rng_seed=0, normalize_obs=False,
        normalize_values=False, exploitability_vs_pool=None,
    )
    mgr.save(300, params, {"dummy": np_.zeros(1)}, {}, meta)
    pool.add_checkpoint("step_00000300", 300)
    s3, _, names3 = pool.refresh_rotation()
    assert jax.tree_util.tree_leaves(s3)[0].shape[0] == 2


# ---------------------------------------------------------------------------
# REAL 2-process e2e: skull CTDE + pool under jax.distributed (Gloo/CPU)
# ---------------------------------------------------------------------------
def test_two_process_pool_training_e2e(tmp_path):
    """Spawns TWO actual processes (jax.distributed, 2 virtual CPU devices
    each) training a tiny skull-CTDE pool config into a SHARED run dir —
    the r1 guard would have raised NotImplementedError here. Verifies
    both exit cleanly, training reached total_steps, checkpoints +
    pool stats exist exactly once (host-0 IO discipline)."""
    import os
    import socket
    import subprocess
    import sys

    # Free port for the jax.distributed coordinator.
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    run_dir = tmp_path / "run"
    cfg = tmp_path / "skull_tiny.toml"
    cfg.write_text(
        "\n".join(
            [
                'env = "skull"',
                "player_count = 3",
                'network_type = "ctde"',
                "num_envs = 8",
                "num_steps = 8",
                "total_steps = 192",
                "hidden_size = 8",
                "num_hidden = 1",
                "num_minibatches = 2",
                "checkpoint_freq = 64",
                "log_freq = 64",
                "seed = 5",
                "opponent_pool_fraction = 0.25",
                "max_active_opponents = 2",
            ]
        )
        + "\n"
    )

    def spawn(pid):
        env = dict(os.environ)
        env.update(
            XLA_FLAGS="--xla_force_host_platform_device_count=2",
            BURN_PPO_COORDINATOR=f"localhost:{port}",
            BURN_PPO_NUM_PROCESSES="2",
            BURN_PPO_PROCESS_ID=str(pid),
        )
        env.pop("JAX_PLATFORMS", None)
        return subprocess.Popen(
            [
                sys.executable, "-m", "burn_ppo_tpu", "train",
                "-c", str(cfg), "--run-dir", str(run_dir),
                "--platform", "cpu", "--multihost", "--quiet",
            ],
            env=env,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )

    procs = [spawn(0), spawn(1)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-3000:]}"

    meta = json.loads(
        (run_dir / "checkpoints" / "latest" / "metadata.json").read_text()
    )
    assert meta["step"] >= 192
    assert (run_dir / "opponent_stats.json").exists()
    assert (run_dir / "rating_metadata.json").exists()
    stats = json.loads((run_dir / "opponent_stats.json").read_text())
    assert len(stats["opponents"]) >= 2  # checkpoints joined the pool


def test_two_process_preemption_resume(tmp_path):
    """Preemption recovery, end to end with real processes: SIGTERM
    delivered to HOST 0 ONLY must stop BOTH processes at the same update
    (the stop decision is host-0's, broadcast each iteration — a
    host-local exit would hang the other process in a collective), write
    a final checkpoint, and a 2-process --resume must continue from it
    to completion. Certifies the multihost failure-recovery story
    (SURVEY §5: preemption-resume replaces the reference's crash-rerun).
    """
    import os
    import signal
    import socket
    import subprocess
    import sys
    import time

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port0 = s.getsockname()[1]

    run_dir = tmp_path / "run"
    total = 128_000  # ~2000 updates: far more than runs before SIGTERM
    cfg = tmp_path / "skull_tiny.toml"
    cfg.write_text(
        "\n".join(
            [
                'env = "skull"',
                "player_count = 3",
                'network_type = "ctde"',
                "num_envs = 8",
                "num_steps = 8",
                f"total_steps = {total}",
                "hidden_size = 8",
                "num_hidden = 1",
                "num_minibatches = 2",
                "checkpoint_freq = 3200",
                "log_freq = 3200",
                "seed = 5",
                "opponent_pool_fraction = 0.25",
                "max_active_opponents = 2",
                "pool_rotation_interval = 2",
            ]
        )
        + "\n"
    )

    def spawn(pid, port, extra=()):
        env = dict(os.environ)
        env.update(
            XLA_FLAGS="--xla_force_host_platform_device_count=2",
            BURN_PPO_COORDINATOR=f"localhost:{port}",
            BURN_PPO_NUM_PROCESSES="2",
            BURN_PPO_PROCESS_ID=str(pid),
        )
        env.pop("JAX_PLATFORMS", None)
        args = [
            sys.executable, "-m", "burn_ppo_tpu", "train",
            "--platform", "cpu", "--multihost", "--quiet",
        ] + list(extra)
        return subprocess.Popen(
            args,
            env=env,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )

    fresh = ["-c", str(cfg), "--run-dir", str(run_dir)]
    procs = [spawn(0, port0, fresh), spawn(1, port0, fresh)]
    try:
        # Preempt host 0 as soon as the first checkpoint lands (the run
        # still has ~97% of its updates left, so the stop is mid-run).
        ckpt_root = run_dir / "checkpoints"
        deadline = time.time() + 480
        while time.time() < deadline:
            if any(
                p.name.startswith("step_")
                for p in (ckpt_root.iterdir() if ckpt_root.exists() else [])
            ):
                break
            if procs[0].poll() is not None:
                break  # crashed early; assertions below surface output
            time.sleep(0.5)
        procs[0].send_signal(signal.SIGTERM)
        outs = []
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for q in procs:
            q.kill()
        raise
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"preempt proc {pid} failed:\n{out[-3000:]}"
    meta = json.loads(
        (run_dir / "checkpoints" / "latest" / "metadata.json").read_text()
    )
    s1 = int(meta["step"])
    assert s1 < total, "run finished before the preemption signal landed"

    # --- resume with a fresh coordinator; total_steps is one of the two
    # fields the resume-override policy allows.
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port1 = s.getsockname()[1]
    new_total = s1 + 128
    res = [
        "--resume", str(run_dir), "--total-steps", str(new_total),
    ]
    procs = [spawn(0, port1, res), spawn(1, port1, res)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=480)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for q in procs:
            q.kill()
        raise
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"resume proc {pid} failed:\n{out[-3000:]}"
    meta = json.loads(
        (run_dir / "checkpoints" / "latest" / "metadata.json").read_text()
    )
    assert int(meta["step"]) >= new_total
    assert (run_dir / "opponent_stats.json").exists()


def test_nonprimary_trainer_registers_checkpoint(tmp_path, monkeypatch):
    """A non-primary host's save_checkpoint() writes nothing but still
    registers the deterministic checkpoint name in its pool replica."""
    from burn_ppo_tpu.config import Config
    from burn_ppo_tpu.train import Trainer

    cfg = Config(
        env="connect_four", num_envs=4, num_steps=4, total_steps=32,
        hidden_size=8, num_hidden=1, num_minibatches=2, seed=1,
        opponent_pool_fraction=0.5, network_type="mlp",
        checkpoint_freq=16, log_freq=16,
    )
    trainer = Trainer(cfg, tmp_path / "run", quiet=True)
    assert trainer.pool is not None
    # Fake "not primary" after construction.
    trainer.is_primary = False
    trainer.global_step = 16
    before = set(trainer.pool.stats)
    out = trainer.save_checkpoint()
    assert out is None
    name = trainer.ckpt.step_dir(16).name
    assert name in trainer.pool.stats
    assert set(trainer.pool.stats) == before | {name}
    assert not trainer.ckpt.step_dir(16).exists()  # wrote nothing
