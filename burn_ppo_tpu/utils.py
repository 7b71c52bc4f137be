"""Host-side helpers: Swiss points, placements, duration formatting.

Behavioral parity with reference src/env.rs:208-261 (compute_avg_points)
and src/eval.rs:276-306 (rewards_to_placements).
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple


def compute_avg_points(
    outcomes: Iterable[Sequence[int]], max_players: int
) -> Tuple[List[float], List[int], float]:
    """Average Swiss points per player + game counts + draw rate.

    ``outcomes``: iterable of placement vectors (1-indexed, ties share a
    placement, '1224' competition ranking). Swiss points use fractional
    ranking: points = n_players_in_game - avg_position, where tied
    players average the positions they span (env.rs:225-246).
    """
    outcomes = list(outcomes)
    total_points = [0.0] * max_players
    game_counts = [0] * max_players
    draws = 0
    if not outcomes:
        return [0.0] * max_players, game_counts, 0.0
    for placements in outcomes:
        placements = list(placements)
        n = len(placements)
        if all(p == 1 for p in placements):
            draws += 1
        for player, place in enumerate(placements):
            if player >= max_players:
                break
            tied = sum(1 for p in placements if p == place)
            avg_position = place + (tied - 1) / 2.0
            total_points[player] += n - avg_position
            game_counts[player] += 1
    avg = [
        (total_points[p] / game_counts[p]) if game_counts[p] else 0.0
        for p in range(max_players)
    ]
    return avg, game_counts, draws / len(outcomes)


def rewards_to_placements(rewards: Sequence[float]) -> List[int]:
    """Final per-player rewards -> 1-indexed competition-ranked placements
    (reference src/eval.rs:276-306): higher reward = better placement;
    rewards within 1e-6 of a tie group's leader share its placement
    ('1224' style). The tolerance matters for accumulated float rewards
    — exact comparison would split near-ties the reference groups."""
    indexed = sorted(enumerate(rewards), key=lambda t: -t[1])
    n = len(indexed)
    placements = [0] * n
    i = 0
    while i < n:
        leader = indexed[i][1]
        j = i
        # Group membership is measured against the group's LEADER, as in
        # the reference's inner while (eval.rs:290-293).
        while j < n and abs(indexed[j][1] - leader) < 1e-6:
            j += 1
        for k in range(i, j):
            placements[indexed[k][0]] = i + 1
        i = j
    return placements


def format_duration(seconds: float) -> str:
    seconds = int(seconds)
    h, rem = divmod(seconds, 3600)
    m, s = divmod(rem, 60)
    if h:
        return f"{h}h{m:02d}m{s:02d}s"
    if m:
        return f"{m}m{s:02d}s"
    return f"{s}s"


def enable_compilation_cache(spec: str | None = "auto"):
    """Point JAX's persistent compilation cache at a directory.

    The reference has no compile step to amortize; XLA does, and this
    framework's supervisor mode (reference main.rs:1700-1784 respawn
    semantics) pays a full retrace+compile in every child. A persistent
    cache turns those into disk hits shared across processes and runs.

    ``$JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX already reads it,
    so no directory is set here. Otherwise ``spec`` "off"/None disables;
    "auto" uses ``<checkout>/.cache/xla`` on a GPU backend and stays off
    elsewhere — XLA:CPU caches AOT machine code whose target features
    may not match the executing host (SIGILL-risk warnings, wedged
    processes), so CPU caching takes an explicit directory; anything
    else is a directory path. Returns the directory in use or None.
    """
    import os
    from pathlib import Path

    import jax

    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        path = env_dir
    elif spec in (None, "off"):
        return None
    elif spec == "auto":
        if jax.default_backend() != "gpu":
            return None
        path = str(Path(__file__).resolve().parents[1] / ".cache" / "xla")
    else:
        path = spec
    if not env_dir:
        Path(path).mkdir(parents=True, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    # Cache every executable: training programs are few and large, and
    # supervisor children re-hit identical keys.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
