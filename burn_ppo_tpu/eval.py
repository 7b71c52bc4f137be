"""Evaluation: stats mode, watch mode, and human-in-the-loop games.

Parity with the reference `eval` subcommand (src/eval.rs):
  * PlayerSource {Checkpoint, Human, Random} (eval.rs:38-67);
  * TempSchedule const/cutoff/decay with env defaults (eval.rs:76-217);
  * stats mode: parallel envs, seat-permutation rotation for fairness,
    model-dedup batching, per-player placement/points tables
    (eval.rs:1541-1800+); self-play broadcast when one checkpoint is
    given for a multiplayer game (eval.rs:893-911);
  * watch mode: ASCII render / step / fps animation (eval.rs:1068-1279);
  * interactive human play in the terminal (eval.rs:947, human.rs).

Design: the stats engine is a jitted `lax.scan` over fixed-size step
chunks; envs never partition dynamically (the reference groups envs per
model on CPU instead, eval.rs:1685-1717). Duplicate sources collapse to
unique models, and same-architecture models stack so each env contracts
its acting model's parameters out of the stack — one batched forward
total (see ``make_acting_logits_fn``).
"""

from __future__ import annotations

import itertools
import math
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import ClassVar, Any, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from burn_ppo_tpu import struct

from burn_ppo_tpu.checkpoint import CheckpointManager
from burn_ppo_tpu.envs import make_env
from burn_ppo_tpu.envs.base import (
    Environment,
    EpisodeAccumulator,
    autoreset_step,
)
from burn_ppo_tpu.ops.categorical import apply_action_mask, sample_with_temperature
from burn_ppo_tpu.ppo.normalization import obs_norm_apply
from burn_ppo_tpu.utils import rewards_to_placements


# ---------------------------------------------------------------------------
# Player sources
# ---------------------------------------------------------------------------
@dataclass
class PlayerSource:
    kind: str  # "checkpoint" | "human" | "random"
    name: str
    path: Optional[Path] = None
    network: Any = None
    params: Any = None
    obs_norm: Any = None

    # Model dedup across sources: the same checkpoint referenced N times
    # (self-play seats, tournament rematches) loads once (the reference
    # dedups per unique path, eval.rs:772-946).
    _load_cache: ClassVar[dict] = {}

    @staticmethod
    def checkpoint(path: str | Path) -> "PlayerSource":
        path = Path(path)
        # Key includes the metadata mtime so a checkpoint re-written at
        # the same path (in-process retrain) is never served stale.
        try:
            mtime = (path / "metadata.json").stat().st_mtime_ns
        except OSError:
            mtime = 0
        cache_key = (str(path.resolve()), mtime)
        cache = PlayerSource._load_cache
        if cache_key in cache:
            network, params, obs_norm = cache.pop(cache_key)  # LRU bump
        else:
            network, params, _meta = CheckpointManager.load_model(path)
            obs_norm = CheckpointManager.load_obs_normalizer(path)
        cache[cache_key] = (network, params, obs_norm)
        while len(cache) > 64:
            cache.pop(next(iter(cache)))
        # runs/<run>/checkpoints/step_X -> "<run>/step_X"
        name = f"{path.parent.parent.name}/{path.name}" if path.name.startswith(
            "step_"
        ) else str(path)
        return PlayerSource(
            kind="checkpoint",
            name=name,
            path=path,
            network=network,
            params=params,
            obs_norm=obs_norm,
        )

    @staticmethod
    def random() -> "PlayerSource":
        return PlayerSource(kind="random", name="Random")

    @staticmethod
    def human(name: str) -> "PlayerSource":
        return PlayerSource(kind="human", name=name)


# ---------------------------------------------------------------------------
# Temperature schedule
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class TempSchedule:
    """Eval-time sampling temperature by move number (eval.rs:76-217)."""

    initial: float
    final_temp: float = 0.0
    cutoff: Optional[int] = None
    decay: bool = False

    @staticmethod
    def from_args(env: Environment, args) -> "TempSchedule":
        if getattr(args, "no_temp_cutoff", False):
            return TempSchedule(
                initial=args.temp if args.temp is not None else env.spec.eval_temp
            )
        env_cutoff = env.spec.eval_temp_cutoff
        cutoff = (
            args.temp_cutoff
            if args.temp_cutoff is not None
            else (env_cutoff[0] if env_cutoff else None)
        )
        if cutoff is None:
            if args.temp_final is not None:
                raise ValueError("--temp-final requires --temp-cutoff (or env default)")
            if getattr(args, "temp_decay", False):
                raise ValueError("--temp-decay requires --temp-cutoff (or env default)")
        final = (
            args.temp_final
            if args.temp_final is not None
            else (env_cutoff[1] if env_cutoff else 0.0)
        )
        return TempSchedule(
            initial=args.temp if args.temp is not None else env.spec.eval_temp,
            final_temp=final,
            cutoff=cutoff,
            decay=getattr(args, "temp_decay", False),
        )

    def get_temp(self, move_num) -> Any:
        """Scalar or vectorized (jnp) temperature lookup."""
        if self.cutoff is None:
            return jnp.full_like(jnp.asarray(move_num, jnp.float32), self.initial)
        move = jnp.asarray(move_num, jnp.float32)
        if self.decay:
            t = jnp.clip(move / self.cutoff, 0.0, 1.0)
            ramp = self.initial + t * (self.final_temp - self.initial)
        else:
            ramp = jnp.full_like(move, self.initial)
        return jnp.where(move >= self.cutoff, self.final_temp, ramp)

    def describe(self) -> str:
        if self.cutoff is None:
            return f"temp={self.initial:.2f} (constant)"
        kind = "decay over" if self.decay else "cutoff at move"
        return f"temp={self.initial:.2f}->{self.final_temp:.2f} ({kind} {self.cutoff})"


# ---------------------------------------------------------------------------
# Stats accumulation
# ---------------------------------------------------------------------------
@dataclass
class EvalStats:
    """Per-source aggregates (reference EvalStats, eval.rs:315-718)."""

    source_names: List[str]
    num_players: int
    placements: List[List[int]] = field(default_factory=list)  # [S][P] counts
    rewards: List[float] = field(default_factory=list)
    games: List[int] = field(default_factory=list)
    outcomes_by_source: List[List[List[int]]] = field(default_factory=list)
    game_records: List[List[Tuple[int, int]]] = field(default_factory=list)
    draws: int = 0
    total_games: int = 0

    def __post_init__(self):
        S = len(self.source_names)
        self.placements = [[0] * self.num_players for _ in range(S)]
        self.rewards = [0.0] * S
        self.games = [0] * S
        self.outcomes_by_source = [[] for _ in range(S)]

    def record_game(self, seat_sources: Sequence[int], placements: Sequence[int],
                    seat_rewards: Sequence[float]) -> None:
        self.total_games += 1
        # Single-player episodes have no draw concept (the sole player is
        # always placed 1st); counting them would report 100% draws.
        if self.num_players > 1 and all(p == 1 for p in placements):
            self.draws += 1
        record = []
        for seat, source in enumerate(seat_sources):
            place = int(placements[seat])
            self.placements[source][min(place - 1, self.num_players - 1)] += 1
            self.rewards[source] += float(seat_rewards[seat])
            self.games[source] += 1
            record.append((source, place))
        self.game_records.append(record)

    def summary_rows(self) -> List[Dict[str, Any]]:
        rows = []
        for s, name in enumerate(self.source_names):
            games = max(self.games[s], 1)
            avg_place = (
                sum((i + 1) * c for i, c in enumerate(self.placements[s])) / games
            )
            rows.append(
                {
                    "name": name,
                    "games": self.games[s],
                    "avg_placement": avg_place,
                    "avg_reward": self.rewards[s] / games,
                    "win_rate": self.placements[s][0] / games,
                    "placements": list(self.placements[s]),
                }
            )
        return rows

    def compute_ratings(self):
        """Plackett-Luce MLE ratings over the recorded games, anchored at
        'Random' if present else the first source (reference stats mode
        prints a ratings table, eval.rs:315-718).

        Intentional divergences from the reference's stats-mode ratings
        (eval.rs:591-607), kept because they make the table strictly more
        informative for the common "checkpoint vs Random" usage:
          * games where one SOURCE holds multiple seats are skipped (the
            reference rates per seat-slot, so self-play seats would
            produce degenerate self-comparisons after the merge-by-source
            this table performs);
          * the anchor is 'Random' when present (a stable absolute
            reference point) instead of always index 0;
          * the interval column is ±2σ (≈95%) instead of ±σ.
        """
        from burn_ppo_tpu.selfplay.plackett_luce import (
            GameResult,
            compute_ratings,
        )

        games = []
        for rec in self.game_records:
            srcs = [src for src, _ in rec]
            # Skip games where one source occupies multiple seats: they
            # would create degenerate self-comparisons (the tournament
            # runner applies the same filter, tournament.rs semantics).
            if len(rec) < 2 or len(set(srcs)) != len(srcs):
                continue
            games.append(GameResult.of(srcs, [pl for _, pl in rec]))
        anchor = 0
        for i, name in enumerate(self.source_names):
            if name == "Random":
                anchor = i
                break
        return compute_ratings(len(self.source_names), games, anchor), len(games)

    def compute_parity_ratings(self):
        """Reference-IDENTICAL stats-mode ratings (eval.rs:591-607):
        rated per SLOT (one rating per lineup entry, duplicates NOT
        merged), over ALL recorded games, anchored at slot 0, reported
        as ±σ. Placements remap seat -> slot by first-seat lookup, the
        reference's ``perm.position()`` (eval.rs:1812-1820); games where
        some slot never sat (possible only in cycled lineups) are
        skipped, since the reference's permutation scheme cannot
        produce them."""
        from burn_ppo_tpu.selfplay.plackett_luce import (
            GameResult,
            compute_ratings,
        )

        S = len(self.source_names)
        games = []
        for rec in self.game_records:
            places = []
            for slot in range(S):
                seat = next(
                    (i for i, (src, _) in enumerate(rec) if src == slot), None
                )
                if seat is None:
                    break
                places.append(rec[seat][1])
            else:
                games.append(GameResult.of(list(range(S)), places))
        return compute_ratings(S, games, 0), len(games)

    def print_parity_ratings(self) -> None:
        """The reference's exact ratings block (eval.rs:591-644):
        computation stats, rating guide, per-slot `name: rating±σ` with
        a strongest marker."""
        from burn_ppo_tpu.selfplay.plackett_luce import print_rating_guide

        result, n_rated = self.compute_parity_ratings()
        if n_rated == 0:
            print("\nNo rateable games recorded.")
            return
        st = result.stats
        status = "converged" if st.converged else "did not converge"
        print(
            f"\nRating computation: {status} in {st.iterations_used} "
            f"iterations ({st.computation_time_ms:.1f}ms), "
            f"final delta: {st.final_delta:.2e}"
        )
        print_rating_guide()
        print("\nRatings:")
        ratings = result.ratings
        strongest = max(range(len(ratings)), key=lambda i: ratings[i].rating)
        for i, (name, pr) in enumerate(zip(self.source_names, ratings)):
            marker = " <- strongest" if i == strongest else ""
            print(f"  {name}: {pr.rating:.0f}±{pr.uncertainty:.0f}{marker}")

    def print_table(self, parity_ratings: bool = False) -> None:
        if self.num_players > 1:
            print(f"\nResults over {self.total_games} games "
                  f"(draw rate {self.draws / max(self.total_games, 1):.1%}):")
        else:
            # Single-player: win/draw columns are meaningless.
            print(f"\nResults over {self.total_games} episodes:")
        header = f"{'Player':<40} {'Games':>6} {'Win%':>7} {'AvgPlace':>9} {'AvgReward':>10}"
        print(header)
        print("-" * len(header))
        for row in self.summary_rows():
            print(
                f"{row['name']:<40} {row['games']:>6} {row['win_rate']:>6.1%} "
                f"{row['avg_placement']:>9.2f} {row['avg_reward']:>10.3f}"
            )
        if parity_ratings:
            # Reference-identical per-slot table (eval.rs:591-644),
            # selected by --parity-ratings.
            self.print_parity_ratings()
            return
        # Ratings need 2+ distinct sources and at least one game with
        # every seat held by a different source.
        if len(set(self.source_names)) > 1 and self.game_records:
            result, n_rated = self.compute_ratings()
            if n_rated > 0:
                print(f"\n{'Player':<40} {'Rating':>8} {'±2σ':>8}"
                      f"   ({n_rated} rated games)")
                print("-" * 58)
                for name, pr in zip(self.source_names, result.ratings):
                    print(
                        f"{name:<40} {pr.rating:>8.0f} {2 * pr.uncertainty:>8.0f}"
                    )


# ---------------------------------------------------------------------------
# Stats-mode engine (shared by tournament, reference eval.rs:1621)
# ---------------------------------------------------------------------------
class _EvalCarry(struct.PyTreeNode):
    env_states: Any
    acc: EpisodeAccumulator
    move_count: jax.Array  # [E]
    perm_idx: jax.Array  # [E]
    key: jax.Array


def generate_permutations(n: int) -> np.ndarray:
    """All n! seat permutations (reference uses Heap's algorithm,
    eval.rs:1591-1619; itertools is equivalent)."""
    return np.array(list(itertools.permutations(range(n))), dtype=np.int32)


def make_acting_logits_fn(env, sources: List[PlayerSource], num_envs: int):
    """Build ``logits_fn(obs_raw [E,D], acting_source [E]) -> [E,A]``.

    The reference partitions envs by acting model on CPU and forwards
    each model only on its envs (eval.rs:1685-1717). The device version
    keeps static shapes and instead removes the waste in two layers:

      1. **Dedup**: sources referencing the same loaded model (self-play
         broadcast, tournament rematches) collapse to one unique model —
         never forwarded twice (the load cache makes identity checks
         exact, eval.rs:772-946's per-path dedup).
      2. **Group**: when every unique model shares one architecture (the
         overwhelmingly common case — a tournament pod of checkpoints
         from the same game), their params stack on a leading axis and
         each env CONTRACTS its acting model's parameters out of the
         stack (one-hot einsum), then one batched per-env forward runs.
         Cost: 1x forward + one param-gather — ~2x a single-source
         forward's FLOPs instead of U-x full-batch forwards.

    Heterogeneous architectures fall back to one full-batch forward per
    unique model + one-hot selection (still deduped).
    """
    A = env.spec.num_actions
    # src -> unique model index (-1 = random). Identity via the load
    # cache: the same checkpoint path yields the same params object.
    uniques: List[PlayerSource] = []
    src_map: List[int] = []
    for s in sources:
        if s.kind == "random":
            src_map.append(-1)
            continue
        for j, u in enumerate(uniques):
            if (
                u.params is s.params
                and u.network == s.network
                and u.obs_norm is s.obs_norm
            ):
                src_map.append(j)
                break
        else:
            uniques.append(s)
            src_map.append(len(uniques) - 1)

    is_random = jnp.asarray([m < 0 for m in src_map])  # [S]
    unique_idx = jnp.asarray([max(m, 0) for m in src_map], jnp.int32)  # [S]
    U = len(uniques)

    if U == 0:
        return lambda obs_raw, acting_source: jnp.zeros((num_envs, A))

    def norm_obs(u: PlayerSource, obs_raw):
        return (
            obs_norm_apply(u.obs_norm, obs_raw)
            if u.obs_norm is not None
            else obs_raw
        )

    if U == 1:
        u0 = uniques[0]

        def single(obs_raw, acting_source):
            logits = u0.network.forward_actor(u0.params, norm_obs(u0, obs_raw))
            rand_e = is_random[acting_source]
            return jnp.where(rand_e[:, None], 0.0, logits)

        return single

    homogeneous = all(u.network == uniques[0].network for u in uniques) and (
        all(u.obs_norm is None for u in uniques)
        or all(u.obs_norm is not None for u in uniques)
    )
    # The grouped path materializes per-env parameter selections
    # (E x |params| floats) and its contraction costs ~E*|params| MACs;
    # that beats U full-batch forwards only while |params| stays modest.
    # Past the cap, the deduped per-unique-model fallback is cheaper and
    # has no memory blow-up.
    n_params = sum(
        int(np.prod(np.shape(x)))
        for x in jax.tree_util.tree_leaves(uniques[0].params)
    )
    if n_params * num_envs > 64_000_000:  # 256MB of f32 selections
        homogeneous = False

    if homogeneous:
        # One fused stacking dispatch; params are already device-resident
        # (load_pytree/put_tree), so per-leaf jnp.stack outside jit would
        # pay one device dispatch PER LEAF (opponent_pool.py:37-42).
        from burn_ppo_tpu.selfplay.opponent_pool import _stack_trees

        net0 = uniques[0].network
        stacked = _stack_trees([u.params for u in uniques])
        stacked_norm = None
        if uniques[0].obs_norm is not None:
            stacked_norm = _stack_trees([u.obs_norm for u in uniques])

        def grouped(obs_raw, acting_source):
            au = unique_idx[acting_source]  # [E]
            rand_e = is_random[acting_source]
            uoh = jax.nn.one_hot(au, U, dtype=obs_raw.dtype)  # [E, U]
            # Per-env parameter/normalizer contraction out of the stack.
            params_e = jax.tree_util.tree_map(
                lambda w: jnp.einsum("eu,u...->e...", uoh, w), stacked
            )
            obs = obs_raw
            if stacked_norm is not None:
                norm_e = jax.tree_util.tree_map(
                    lambda w: jnp.einsum("eu,u...->e...", uoh, w), stacked_norm
                )
                obs = jax.vmap(obs_norm_apply)(norm_e, obs)
            logits = jax.vmap(
                lambda p, o: net0.forward_actor(p, o[None, :])[0]
            )(params_e, obs)
            return jnp.where(rand_e[:, None], 0.0, logits)

        return grouped

    def hetero(obs_raw, acting_source):
        outs = [
            u.network.forward_actor(u.params, norm_obs(u, obs_raw))
            for u in uniques
        ]
        logits_all = jnp.stack(outs)  # [U, E, A]
        au = unique_idx[acting_source]
        rand_e = is_random[acting_source]
        # One-hot SELECT via where(), not an einsum (repo gather rule,
        # ops/categorical.py:51-55) — where() also keeps one source's
        # NaN/Inf logits from poisoning envs acted by healthy sources
        # (0 * NaN would be NaN).
        sel = (jnp.arange(U)[:, None] == au[None, :])[:, :, None]  # [U,E,1]
        logits = jnp.sum(jnp.where(sel, logits_all, 0.0), axis=0)
        return jnp.where(rand_e[:, None], 0.0, logits)

    return hetero


def run_stats_mode(
    env: Environment,
    sources: List[PlayerSource],
    num_games: int,
    num_envs: int = 64,
    temp: Optional[TempSchedule] = None,
    seed: Optional[int] = None,
    chunk_steps: int = 64,
    quiet: bool = False,
) -> EvalStats:
    """Play ``num_games`` with seat rotation; returns per-source stats."""
    P = env.spec.num_players
    S = len(sources)
    temp = temp or TempSchedule(initial=env.spec.eval_temp,
                                final_temp=(env.spec.eval_temp_cutoff or (0, 0.0))[1],
                                cutoff=(env.spec.eval_temp_cutoff or (None,))[0])
    assert all(s.kind in ("checkpoint", "random") for s in sources), (
        "human players use the interactive path"
    )

    # Seat maps: if S == P use all P! permutations of sources over seats;
    # if S == 1, broadcast (self-play). S > P (the reference refuses this
    # case, eval.rs:893-911; supported here as a generalization) uses ALL
    # ordered P-arrangements of distinct sources so every source pair
    # meets in every seat order — a cyclic lineup would pit each pair in
    # one fixed seat order (first-mover bias) and skip most pairs
    # entirely for S > P+1. 1 < S < P cycles sources over seats (every
    # game necessarily repeats sources across seats).
    if S == 1:
        perms = np.zeros((1, P), dtype=np.int32)
    elif S == P:
        perms = generate_permutations(P)
    elif S > P:
        n_arr = math.perm(S, P)
        if n_arr > 1_000_000:
            raise ValueError(
                f"stats mode with {S} sources in {P} seats needs "
                f"{n_arr} seat arrangements for fair coverage; use "
                "tournament mode for fields this large"
            )
        perms = np.array(
            list(itertools.permutations(range(S), P)), dtype=np.int32
        )
    else:
        perms = np.array(
            [[(i + r) % S for i in range(P)] for r in range(S)], dtype=np.int32
        )
    perm_table = jnp.asarray(perms)
    n_perms = perms.shape[0]

    key = jax.random.PRNGKey(seed if seed is not None else int(time.time()) % 2**31)
    key, k_reset = jax.random.split(key)
    env_states = jax.vmap(env.reset)(jax.random.split(k_reset, num_envs))
    carry = _EvalCarry(
        env_states=env_states,
        acc=jax.vmap(lambda _: EpisodeAccumulator.zero(P))(jnp.arange(num_envs)),
        move_count=jnp.zeros((num_envs,), jnp.int32),
        # Stagger starting permutations across envs for coverage.
        perm_idx=jnp.arange(num_envs, dtype=jnp.int32) % n_perms,
        key=key,
    )

    v_obs = jax.vmap(env.obs)
    v_mask = jax.vmap(env.action_mask)
    v_player = jax.vmap(env.current_player)

    acting_logits = make_acting_logits_fn(env, sources, num_envs)

    def step_fn(c: _EvalCarry, _):
        k, k_sample, k_reset = jax.random.split(c.key, 3)
        obs_raw = v_obs(c.env_states)
        mask = v_mask(c.env_states).astype(jnp.float32)
        players = v_player(c.env_states)

        acting_source = perm_table[c.perm_idx, players]  # [E]
        logits = acting_logits(obs_raw, acting_source)  # [E, A]
        masked = apply_action_mask(logits, mask)
        temps = temp.get_temp(c.move_count)
        actions = sample_with_temperature(k_sample, masked, temps)

        next_states, next_acc, terminal, log = jax.vmap(
            lambda s, a, act, rk: autoreset_step(env, s, a, act, rk)
        )(c.env_states, c.acc, actions, jax.random.split(k_reset, num_envs))

        done = terminal.done
        out = (log, c.perm_idx)  # perm BEFORE advance maps seats->sources
        new_carry = _EvalCarry(
            env_states=next_states,
            acc=next_acc,
            move_count=jnp.where(done, 0, c.move_count + 1),
            perm_idx=jnp.where(done, (c.perm_idx + 1) % n_perms, c.perm_idx),
            key=k,
        )
        return new_carry, out

    @jax.jit
    def run_chunk(c):
        return jax.lax.scan(step_fn, c, None, length=chunk_steps)

    from burn_ppo_tpu.checkpoint import fetch_tree

    stats = EvalStats([s.name for s in sources], P)
    while stats.total_games < num_games:
        carry, (logs, perm_hist) = run_chunk(carry)
        fetched = fetch_tree({"logs": logs, "perm": perm_hist})
        logs = fetched["logs"]
        perm_hist = np.asarray(fetched["perm"])  # [T, E]
        completed = np.asarray(logs.completed)  # [T, E]
        outcomes = np.asarray(logs.outcome)  # [T, E, P]
        totals = np.asarray(logs.total_rewards)  # [T, E, P]
        for t, e in zip(*np.nonzero(completed)):
            if stats.total_games >= num_games:
                break
            if np.any(outcomes[t, e] < 1):
                # No-outcome sentinel (invalid-action termination): the
                # reference excludes such games from stats entirely.
                continue
            seat_sources = perms[perm_hist[t, e]]
            stats.record_game(seat_sources, outcomes[t, e], totals[t, e])
        if not quiet:
            print(f"\r  games: {stats.total_games}/{num_games}", end="", flush=True)
    if not quiet:
        print()
    return stats


# ---------------------------------------------------------------------------
# Watch mode (eval.rs:1068-1279)
# ---------------------------------------------------------------------------
def run_watch_mode(
    env: Environment,
    sources: List[PlayerSource],
    num_games: int,
    temp: TempSchedule,
    seed: Optional[int],
    step_mode: bool = False,
    fps: int = 10,
    animate: bool = False,
) -> None:
    P = env.spec.num_players
    key = jax.random.PRNGKey(seed if seed is not None else int(time.time()) % 2**31)
    jit_step = jax.jit(env.step)
    for game in range(num_games):
        key, k = jax.random.split(key)
        state = env.reset(k)
        move = 0
        print(f"\n=== Game {game + 1}/{num_games} ===")
        # Rotate seat assignments between watched games for fairness,
        # as the reference's watch loop does (eval.rs:1068-1279).
        seat_of = [(p + game) % len(sources) for p in range(P)]
        if len(sources) > 1:
            print(
                "Seats: "
                + ", ".join(
                    f"P{p}={sources[seat_of[p]].name}" for p in range(P)
                )
            )
        while not bool(state.done):
            rendered = env.render(state)
            if rendered:
                print(rendered)
            player = int(env.current_player(state))
            source = sources[seat_of[player]]
            key, k_s = jax.random.split(key)
            action = _select_action(env, state, source, temp.get_temp(move), k_s)
            print(f"{source.name} (P{player}): {env.describe_action(int(action))}")
            state = jit_step(state, jnp.asarray(action, jnp.int32))
            move += 1
            if step_mode:
                input("  [Enter to continue]")
            elif animate:
                time.sleep(1.0 / max(fps, 1))
        rendered = env.render(state)
        if rendered:
            print(rendered)
        print(f"Final rewards: {np.asarray(state.rewards)}")


def _select_action(env, state, source: PlayerSource, temperature, key) -> int:
    mask = env.action_mask(state).astype(jnp.float32)[None, :]
    if source.kind == "random":
        logits = jnp.zeros((1, env.spec.num_actions))
    elif source.kind == "human":
        from burn_ppo_tpu.human import prompt_human_action

        return prompt_human_action(env, state, hint_source=None)
    else:
        obs = env.obs(state)[None, :]
        if source.obs_norm is not None:
            obs = obs_norm_apply(source.obs_norm, obs)
        logits = source.network.forward_actor(source.params, obs)
    masked = apply_action_mask(logits, mask)
    return int(sample_with_temperature(key, masked, jnp.asarray(temperature))[0])


# ---------------------------------------------------------------------------
# Interactive (human) evaluation (eval.rs:947, 1293)
# ---------------------------------------------------------------------------
def run_interactive_evaluation(
    env: Environment,
    sources: List[PlayerSource],
    num_games: int,
    temp: TempSchedule,
    seed: Optional[int],
) -> None:
    from burn_ppo_tpu.human import prompt_human_action

    P = env.spec.num_players
    if len(sources) != P:
        raise ValueError(f"need {P} players for {env.spec.name}, got {len(sources)}")
    key = jax.random.PRNGKey(seed if seed is not None else int(time.time()) % 2**31)
    model_sources = [s for s in sources if s.kind == "checkpoint"]
    hint = model_sources[0] if model_sources else None
    wins = [0] * len(sources)
    for game in range(num_games):
        key, k = jax.random.split(key)
        state = env.reset(k)
        move = 0
        print(f"\n=== Game {game + 1}/{num_games} ===")
        while not bool(state.done):
            player = int(env.current_player(state))
            source = sources[player]
            rendered = env.render(state)
            if rendered and source.kind == "human":
                print(rendered)
            key, k_s = jax.random.split(key)
            if source.kind == "human":
                action = prompt_human_action(env, state, hint_source=hint)
            else:
                action = _select_action(env, state, source, temp.get_temp(move), k_s)
                print(f"{source.name}: {env.describe_action(int(action))}")
            state = env.step(state, jnp.asarray(action, jnp.int32))
            move += 1
        rendered = env.render(state)
        if rendered:
            print(rendered)
        placements = rewards_to_placements([float(r) for r in np.asarray(state.rewards)])
        for i, pl in enumerate(placements):
            if pl == 1:
                wins[i] += 1
        print(f"Final rewards: {np.asarray(state.rewards)}")
    print("\nWins:", {sources[i].name: wins[i] for i in range(len(sources))})


# ---------------------------------------------------------------------------
# CLI entry (reference run_evaluation, eval.rs:772)
# ---------------------------------------------------------------------------
def build_sources(args, env_name_hint: Optional[str] = None):
    sources: List[PlayerSource] = []
    env_name = env_name_hint
    for path in args.checkpoints:
        src = PlayerSource.checkpoint(_resolve_checkpoint(path))
        sources.append(src)
        meta = CheckpointManager.load_metadata(src.path)
        env_name = env_name or meta["env_name"]
    for name in getattr(args, "humans", []):
        sources.append(PlayerSource.human(name))
    if getattr(args, "random", False):
        sources.append(PlayerSource.random())
    return sources, env_name


def _resolve_checkpoint(path: str | Path) -> Path:
    """Accept a checkpoint dir, a run dir (uses best, then latest), or a
    checkpoints dir."""
    p = Path(path)
    if (p / "metadata.json").exists():
        return p
    for sub in ("checkpoints/best", "checkpoints/latest", "best", "latest"):
        cand = p / sub
        if (cand / "metadata.json").exists():
            return cand.resolve()
    raise FileNotFoundError(f"No checkpoint found at {path}")


def run_evaluation_cli(args) -> int:
    sources, env_name = build_sources(args, getattr(args, "env_name", None))
    if env_name is None:
        print("error: no checkpoint given and no --env specified")
        return 1
    env = make_env(env_name)
    if env.spec.variable_player_count and getattr(args, "players", None):
        env = env.with_num_players(args.players)
    P = env.spec.num_players

    temp = TempSchedule.from_args(env, args)
    print(f"Evaluating {env_name} with {temp.describe()}")

    humans = [s for s in sources if s.kind == "human"]
    if humans:
        if len(humans) > P:
            print(
                f"error: {len(humans)} humans requested but {env_name} "
                f"seats only {P} players"
            )
            return 1
        # Humans always get seats: if there are more sources than seats,
        # drop excess NON-human sources from the end (seats[:P] used to
        # silently truncate the human off the tail); fill any shortfall
        # by cycling non-human sources.
        seats = list(sources)
        dropped = 0
        while len(seats) > P:
            for j in range(len(seats) - 1, -1, -1):
                if seats[j].kind != "human":
                    del seats[j]
                    dropped += 1
                    break
        if dropped:
            print(f"note: only {P} seats; dropping {dropped} extra non-human source(s)")
        non_human = [s for s in sources if s.kind != "human"] or [PlayerSource.random()]
        i = 0
        while len(seats) < P:
            seats.append(non_human[i % len(non_human)])
            i += 1
        run_interactive_evaluation(env, seats, args.num_games, temp, args.seed)
        return 0

    if not sources:
        print("error: need at least one --checkpoint / --random player")
        return 1

    if args.watch or args.step or args.animate:
        seats = [sources[i % len(sources)] for i in range(P)]
        run_watch_mode(
            env, seats, args.num_games, temp, args.seed,
            step_mode=args.step, fps=args.fps, animate=args.animate,
        )
        return 0

    stats = run_stats_mode(
        env, sources, args.num_games, num_envs=args.num_envs,
        temp=temp, seed=args.seed,
    )
    stats.print_table(
        parity_ratings=getattr(args, "parity_ratings", False)
    )
    return 0
