"""Million-game-regime load test for the rating engine.

Simulates a long training run's rating traffic: C checkpoints, each
recording a large batch of vs-pool games through the array-native path
(record_games_arrays) followed by a full rating recompute — the exact
per-checkpoint cadence of train.py. Reports peak RSS, final recompute
time, resident comparison count, and cold-load time.

The reference recomputes from the full game log each checkpoint
(rating_history.rs); its memory is O(games). Here the resident state
must stay O(distinct matchups) no matter how many games are played.

Usage: python scripts/load_test_rating.py [num_games] [num_checkpoints]
"""

import json
import resource
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from burn_ppo_tpu.selfplay.rating_history import RatingHistory


def rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def main() -> None:
    total_games = int(sys.argv[1]) if len(sys.argv) > 1 else 5_000_000
    num_ckpts = int(sys.argv[2]) if len(sys.argv) > 2 else 40
    per_ckpt = total_games // num_ckpts
    rng = np.random.default_rng(0)

    with tempfile.TemporaryDirectory() as d:
        h = RatingHistory(d)
        names = []
        t_start = time.perf_counter()
        rss0 = rss_mb()
        compute_ms = 0.0
        for ci in range(num_ckpts):
            name = f"step_{(ci + 1) * 1_000_000:010d}"
            h.on_checkpoint_saved(name, (ci + 1) * 1_000_000)
            names.append(name)
            K = len(names)
            # 4-player skull-style games: learner + up to 3 pool seats.
            lp = rng.integers(1, 5, size=per_ckpt)
            slots = rng.integers(-1, K, size=(per_ckpt, 3))
            places = rng.integers(1, 5, size=(per_ckpt, 3))
            h.record_games_arrays(name, names, lp, slots, places)
            t0 = time.perf_counter()
            snap = h.compute()
            compute_ms = (time.perf_counter() - t0) * 1000.0
            if (ci + 1) % 10 == 0:
                print(
                    f"  ckpt {ci + 1:3d}/{num_ckpts}: games={snap.total_games:>9,} "
                    f"resident_comparisons={len(h._chunks[0]):>7,} "
                    f"recompute={compute_ms:7.1f}ms rss={rss_mb():7.1f}MB",
                    flush=True,
                )
        wall = time.perf_counter() - t_start
        resident = len(h._chunks[0])
        jsonl_mb = (Path(d) / "rating_games.jsonl").stat().st_size / 2**20

        h._save_cache()
        t0 = time.perf_counter()
        cold = RatingHistory.load(d)
        cold_snap = cold.compute()
        cold_s = time.perf_counter() - t0
        assert cold_snap.total_games == snap.total_games

        out = {
            "total_games": snap.total_games,
            "num_checkpoints": num_ckpts,
            "resident_comparisons": resident,
            "final_recompute_ms": round(compute_ms, 1),
            "peak_rss_mb": round(rss_mb(), 1),
            "rss_growth_mb": round(rss_mb() - rss0, 1),
            "jsonl_disk_mb": round(jsonl_mb, 1),
            "cold_load_plus_compute_s": round(cold_s, 2),
            "total_wall_s": round(wall, 1),
            "current_elo": round(snap.current_elo, 1),
        }
        print(json.dumps(out))
        assert out["peak_rss_mb"] < 1024, "RSS bound violated"


if __name__ == "__main__":
    main()
