"""On-device episode statistics.

The reference ingests every completed episode on the host (last-100
deques, main.rs:840-875). At 64k+ envs the per-update episode
logs are ~100MB; fetching them to feed host deques dominates real
training time. Instead the train step reduces the [T, E] logs to a
handful of scalars on device (masked sums over completed rows) and the
host tracker accumulates those per-update summaries, reporting over a
trailing window of >=100 episodes at update granularity.

Swiss points use the reference's fractional-tie formula
(env.rs:225-246): points = n_players - (place + (tied - 1) / 2).
"""

from __future__ import annotations

from collections import deque
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np


def summarize_episode_logs(logs, num_players: int) -> Dict[str, jax.Array]:
    """Reduce EpisodeLog [T, E] leaves to window scalars, on device."""
    done = logs.completed  # [T, E] bool
    donef = done.astype(jnp.float32)
    count = jnp.sum(donef)
    totals = logs.total_rewards  # [T, E, P]
    mask3 = donef[..., None]

    ret_sum = jnp.sum(totals * mask3, axis=(0, 1))  # [P]
    ret0 = totals[..., 0]
    ret0_max = jnp.max(jnp.where(done, ret0, -jnp.inf))
    ret0_min = jnp.min(jnp.where(done, ret0, jnp.inf))
    len_sum = jnp.sum(logs.length.astype(jnp.float32) * donef)

    place = logs.outcome  # [T, E, P] 1-indexed placements
    # Zero placements are the no-outcome sentinel (invalid-action
    # termination, e.g. connect_four.game_outcome): the game completed
    # but has no result — exclude it from points, as the reference does
    # by leaving game_outcome None.
    has_outcome = jnp.all(place >= 1, axis=-1).astype(jnp.float32)  # [T, E]
    # tied[j] = #players sharing place j ('1224' competition ranking)
    eq = place[..., :, None] == place[..., None, :]
    tied = jnp.sum(eq.astype(jnp.float32), axis=-1)  # [T, E, P]
    n = jnp.asarray(num_players, jnp.float32)
    pts = n - (place.astype(jnp.float32) + (tied - 1.0) / 2.0)
    pts_sum = jnp.sum(pts * mask3 * has_outcome[..., None], axis=(0, 1))  # [P]

    draws = jnp.sum(donef * jnp.all(place == 1, axis=-1).astype(jnp.float32))
    return {
        "count": count,
        "ret_sum": ret_sum,
        "ret0_max": ret0_max,
        "ret0_min": ret0_min,
        "len_sum": len_sum,
        "pts_sum": pts_sum,
        "draws": draws,
    }


class WindowedEpisodeTracker:
    """Trailing >=100-episode window over per-update device summaries.

    Same reporting surface as the host tracker (avg_return, per-player
    means, Swiss points, draw rate, lengths) without per-episode host
    data; the window is trimmed at update granularity, so it always
    covers at least ``window`` episodes once that many have completed.
    """

    def __init__(self, num_players: int, window: int = 100):
        self.num_players = num_players
        self.window = window
        self.updates: deque = deque()
        self.total_episodes = 0
        # Resume seed: display-only average until real episodes arrive
        # (checkpoint metadata's recent_returns; never mixed into the
        # length/points/draw series, which it has no data for).
        self._seed_avg: float = 0.0
        self._seed_count: int = 0

    def seed(self, avg_return: float, count: int) -> None:
        self._seed_avg = float(avg_return)
        self._seed_count = int(count)

    @property
    def seed_count(self) -> int:
        """Episodes represented by the resume seed (no real data yet)."""
        return self._seed_count

    def ingest(self, stats: Dict[str, np.ndarray]) -> None:
        s = {k: np.asarray(v) for k, v in stats.items()}
        cnt = float(s["count"])
        if cnt <= 0:
            return
        self.total_episodes += int(cnt)
        self.updates.append(s)
        # Trim: keep at least `window` episodes.
        total = sum(float(u["count"]) for u in self.updates)
        while (
            len(self.updates) > 1
            and total - float(self.updates[0]["count"]) >= self.window
        ):
            total -= float(self.updates[0]["count"])
            self.updates.popleft()

    # -- reporting ------------------------------------------------------
    @property
    def window_count(self) -> float:
        return sum(float(u["count"]) for u in self.updates)

    @property
    def has_data(self) -> bool:
        return bool(self.updates)

    @property
    def avg_return(self) -> float:
        c = self.window_count
        if c <= 0:
            return self._seed_avg if self._seed_count else 0.0
        return sum(float(u["ret_sum"][0]) for u in self.updates) / c

    @property
    def return_max(self) -> float:
        # Neutral on an empty window like every other property — raising
        # from max() on an empty sequence would crash any caller that
        # reads before the first ingest (e.g. right after resume).
        if not self.updates:
            return 0.0
        return max(float(u["ret0_max"]) for u in self.updates)

    @property
    def return_min(self) -> float:
        if not self.updates:
            return 0.0
        return min(float(u["ret0_min"]) for u in self.updates)

    @property
    def mean_length(self) -> float:
        c = self.window_count
        return sum(float(u["len_sum"]) for u in self.updates) / c if c else 0.0

    def per_player_returns(self) -> np.ndarray:
        c = self.window_count
        if c <= 0:
            return np.zeros(self.num_players)
        return (
            sum(np.asarray(u["ret_sum"], dtype=np.float64) for u in self.updates)
            / c
        )

    def avg_points(self) -> np.ndarray:
        c = self.window_count
        if c <= 0:
            return np.zeros(self.num_players)
        return (
            sum(np.asarray(u["pts_sum"], dtype=np.float64) for u in self.updates)
            / c
        )

    @property
    def draw_rate(self) -> float:
        c = self.window_count
        return sum(float(u["draws"]) for u in self.updates) / c if c else 0.0
