"""Bounded-memory rating engine: weight-aggregated comparisons, the
array-native record path, and dict-path equivalence.

The reference recomputes ratings from the full game log every checkpoint
(rating_history.rs); memory there is the log. Here the resident state
must be O(distinct matchups), not O(games): raw game dicts are dropped
once expanded and identical comparisons merge by summed weight (the PL
likelihood is a product over comparisons, so merging is exact up to fp
associativity)."""

import json

import numpy as np

from burn_ppo_tpu.selfplay.plackett_luce import (
    GameResult,
    aggregate_comparison_arrays,
    arrays_to_comparisons,
    compute_ratings,
    compute_ratings_from_comparisons,
    comparisons_to_arrays,
    expand_games_to_comparisons,
)
from burn_ppo_tpu.selfplay.rating_history import (
    RatingHistory,
    _expand_placements_vectorized,
)


def _random_games(rng, n_games, n_players, max_per_game=4):
    games = []
    for _ in range(n_games):
        m = int(rng.integers(2, max_per_game + 1))
        players = rng.choice(n_players, size=m, replace=False).tolist()
        placements = rng.integers(1, m + 1, size=m).tolist()  # ties allowed
        games.append(GameResult.of(players, placements))
    return games


def _canon(arrays):
    """Order-free canonical form: {(winner, sorted losers): weight}."""
    out = {}
    for c in arrays_to_comparisons(arrays):
        key = (c.winner, tuple(sorted(c.losers)))
        out[key] = out.get(key, 0.0) + c.weight
    return out


def test_aggregate_preserves_total_weight_and_keys():
    rng = np.random.default_rng(0)
    games = _random_games(rng, 500, 8)
    arrays = comparisons_to_arrays(expand_games_to_comparisons(games))
    agg = aggregate_comparison_arrays(arrays)
    assert len(agg) < len(arrays)  # duplicates existed and merged
    raw, merged = _canon(arrays), _canon(agg)
    assert set(raw) == set(merged)
    for k in raw:
        np.testing.assert_allclose(merged[k], raw[k], rtol=1e-12)
    # Aggregated output has no duplicate keys at all.
    assert len(merged) == len(agg)


def test_aggregate_ratings_match_unaggregated():
    rng = np.random.default_rng(1)
    games = _random_games(rng, 2000, 6)
    games_played = np.zeros(6, np.int64)
    for g in games:
        for p in g.players:
            games_played[p] += 1
    arrays = comparisons_to_arrays(expand_games_to_comparisons(games))
    agg = aggregate_comparison_arrays(arrays)
    r_raw = compute_ratings_from_comparisons(6, arrays, games_played, 0)
    r_agg = compute_ratings_from_comparisons(6, agg, games_played, 0)
    for a, b in zip(r_raw.ratings, r_agg.ratings):
        assert abs(a.rating - b.rating) < 1e-2
        assert abs(a.uncertainty - b.uncertainty) < 1e-3


def test_aggregate_idempotent_and_empty():
    rng = np.random.default_rng(2)
    games = _random_games(rng, 100, 5)
    arrays = comparisons_to_arrays(expand_games_to_comparisons(games))
    agg1 = aggregate_comparison_arrays(arrays)
    agg2 = aggregate_comparison_arrays(agg1)
    assert len(agg1) == len(agg2)
    np.testing.assert_array_equal(agg1.winners, agg2.winners)
    np.testing.assert_allclose(agg1.weights, agg2.weights, rtol=1e-15)
    empty = comparisons_to_arrays([])
    assert len(aggregate_comparison_arrays(empty)) == 0


def test_vectorized_expansion_matches_per_game():
    """Random multi-player games with ties and absent seats expand to the
    same comparison multiset as expand_games_to_comparisons."""
    rng = np.random.default_rng(3)
    N, M = 400, 4
    players = rng.integers(0, 9, size=(N, M)).astype(np.int64)
    places = rng.integers(1, M + 1, size=(N, M)).astype(np.int64)
    present = rng.random((N, M)) < 0.8
    present[:, 0] = True  # learner always seated

    vec = _expand_placements_vectorized(players, places, present)

    games = []
    for i in range(N):
        ps = [int(players[i, j]) for j in range(M) if present[i, j]]
        pl = [int(places[i, j]) for j in range(M) if present[i, j]]
        games.append(GameResult.of(ps, pl))
    ref = comparisons_to_arrays(expand_games_to_comparisons(games))

    raw, v = _canon(ref), _canon(vec)
    assert set(raw) == set(v)
    for k in raw:
        np.testing.assert_allclose(v[k], raw[k], rtol=1e-12)


def test_record_games_arrays_jsonl_matches_dict_path(tmp_path):
    """The array path's jsonl lines are byte-identical to
    record_games_batch's, and a cold reload rates both identically."""
    names = ["step_00000100", "step_00000200", "step_00000300"]
    rng = np.random.default_rng(4)
    N = 60
    learner_place = rng.integers(1, 4, size=N)
    opp_slots = rng.integers(-1, 3, size=(N, 2))  # -1 = empty seat
    opp_places = rng.integers(1, 4, size=(N, 2))
    # Ensure at least one row with zero valid opponents (skipped).
    opp_slots[0] = [-1, -1]

    a = RatingHistory(tmp_path / "arrays")
    (tmp_path / "arrays").mkdir()
    for i, n in enumerate(names):
        a.on_checkpoint_saved(n, (i + 1) * 100)
    a.record_games_arrays(
        "step_00000300", names, learner_place, opp_slots, opp_places
    )

    b = RatingHistory(tmp_path / "dicts")
    (tmp_path / "dicts").mkdir()
    for i, n in enumerate(names):
        b.on_checkpoint_saved(n, (i + 1) * 100)
    games = []
    for i in range(N):
        pairs = [
            (names[s], int(p))
            for s, p in zip(opp_slots[i], opp_places[i])
            if 0 <= s < 3
        ]
        if pairs:
            games.append(
                (
                    [n for n, _ in pairs],
                    [int(learner_place[i])] + [p for _, p in pairs],
                )
            )
    b.record_games_batch("step_00000300", games)

    la = (tmp_path / "arrays" / "rating_games.jsonl").read_text()
    lb = (tmp_path / "dicts" / "rating_games.jsonl").read_text()
    assert la == lb
    assert a.num_games == b.num_games == len(games)

    sa, sb = a.compute(), b.compute()
    assert abs(sa.current_elo - sb.current_elo) < 1e-2
    assert abs(sa.best_elo - sb.best_elo) < 1e-2
    assert sa.total_games == sb.total_games

    # Cold reload of the array-path dir re-parses identically.
    cold = RatingHistory.load(tmp_path / "arrays")
    sc = cold.compute()
    assert abs(sa.current_elo - sc.current_elo) < 1e-2
    assert sc.total_games == sa.total_games


def test_resident_memory_bounded_by_distinct_matchups(tmp_path):
    """50k duplicate-heavy games leave O(distinct) comparisons and zero
    retained game dicts after compute()."""
    h = RatingHistory(tmp_path)
    names = [f"step_{i:08d}" for i in range(1, 5)]
    for i, n in enumerate(names):
        h.on_checkpoint_saved(n, (i + 1) * 100)
    rng = np.random.default_rng(5)
    N = 50_000
    learner_place = rng.integers(1, 3, size=N)
    opp_slots = rng.integers(0, 4, size=(N, 1))
    opp_places = np.where(learner_place[:, None] == 1, 2, 1)
    h.record_games_arrays(
        names[-1], names, learner_place, opp_slots, opp_places
    )
    h.compute()
    assert h._pending == []
    assert len(h._chunks) == 1
    # 4 opponents x 2 outcomes (+ ties impossible here) = <= 8 distinct.
    assert len(h._chunks[0]) <= 8
    assert h.num_games == N
    # And the full log is still on disk, one line per game.
    n_lines = sum(
        1 for l in (tmp_path / "rating_games.jsonl").read_text().splitlines() if l
    )
    assert n_lines == N


def test_mixed_dict_and_array_paths_keep_prefix_semantics(tmp_path):
    """Dict-path games recorded before an array-path batch fold in first
    (the cache watermark must stay a jsonl prefix)."""
    h = RatingHistory(tmp_path)
    names = ["step_00000100", "step_00000200"]
    for i, n in enumerate(names):
        h.on_checkpoint_saved(n, (i + 1) * 100)
    h.record_games_batch(names[-1], [([names[0]], [1, 2])] * 5)
    assert len(h._pending) == 5
    h.record_games_arrays(
        names[-1],
        names,
        np.asarray([1, 2]),
        np.asarray([[0], [0]]),
        np.asarray([[2], [1]]),
    )
    assert h._pending == []  # flushed before the array batch
    assert h.num_games == 7
    assert h._expanded_upto == 7
    snap = h.compute()
    assert snap.total_games == 7
    # Cold reload agrees.
    cold = RatingHistory.load(tmp_path)
    assert cold.compute().total_games == 7

def test_shrunken_log_under_cache_rebuilds_from_log(tmp_path):
    """A jsonl that lost a tail write (crash) while the comparison cache
    covers more games must trigger a full cache-discarding rebuild —
    detected at EOF of the single tail-parse pass, not via a separate
    line-counting stream."""
    h = RatingHistory(tmp_path)
    names = ["step_00000100", "step_00000200"]
    for i, n in enumerate(names):
        h.on_checkpoint_saved(n, (i + 1) * 100)
    rng = np.random.default_rng(6)
    N = 200
    h.record_games_arrays(
        names[-1],
        names,
        rng.integers(1, 3, size=N),
        np.zeros((N, 1), np.int64),
        rng.integers(1, 3, size=(N, 1)),
    )
    h.compute()
    h._save_cache()
    h._cache_saved_upto = h._expanded_upto
    assert h.cache_path.exists()

    # Truncate the log to 120 lines — fewer than the cache's 200.
    log = tmp_path / "rating_games.jsonl"
    lines = [l for l in log.read_text().splitlines() if l]
    log.write_text("\n".join(lines[:120]) + "\n")

    cold = RatingHistory.load(tmp_path)
    assert cold.num_games == 120
    snap = cold.compute()
    assert snap.total_games == 120
    # Ratings still computable and anchored.
    assert np.isfinite(snap.current_elo)


def test_intact_log_under_cache_loads_single_pass(tmp_path):
    """Normal path: cache + intact log reload matches a cache-less cold
    rebuild."""
    h = RatingHistory(tmp_path)
    names = ["step_00000100", "step_00000200"]
    for i, n in enumerate(names):
        h.on_checkpoint_saved(n, (i + 1) * 100)
    rng = np.random.default_rng(7)
    N = 150
    h.record_games_arrays(
        names[-1],
        names,
        rng.integers(1, 3, size=N),
        np.zeros((N, 1), np.int64),
        rng.integers(1, 3, size=(N, 1)),
    )
    h.compute()
    h._save_cache()
    h._cache_saved_upto = h._expanded_upto

    with_cache = RatingHistory.load(tmp_path)
    assert with_cache.num_games == N
    s1 = with_cache.compute()

    h.cache_path.unlink()
    without_cache = RatingHistory.load(tmp_path)
    assert without_cache.num_games == N
    s2 = without_cache.compute()
    assert abs(s1.current_elo - s2.current_elo) < 1e-2
    assert s1.total_games == s2.total_games
