"""Environment abstraction: pure-functional games stepped on-device.

The reference's `Environment` trait (src/env.rs:24-173) is a mutable
object stepped by a rayon thread pool on CPU, crossing the host<->device
boundary twice per step.  Here an environment is a set of *pure
functions* over an immutable state pytree:

    reset(key)        -> state
    step(state, a)    -> state       (state carries rewards/done emitted)
    obs(state)        -> f32[obs_dim]
    action_mask(state)-> bool[A]
    ...

All functions are written for a *single* environment and vectorized with
`jax.vmap` by the rollout layer, so the entire vec-env lives in HBM and
steps inside the jitted rollout scan.  Stochasticity (resets, dice) flows
through a PRNG key stored in the state.

Auto-reset (the reference's VecEnv, src/env.rs:267-488) is the
`autoreset_step` function below: terminal info (episode rewards, length,
game outcome placements) is captured from the terminal state *before* the
reset state replaces it — same ordering as the reference's capture of
`game_outcome()` before reset (env.rs:442-451).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
from burn_ppo_tpu import struct

State = Any


# --------------------------------------------------------------------------
# One-hot read/write primitives for env code.
#
# Under vmap, `arr[i]` / `arr.at[i].set(v)` with a traced index lowers to
# a per-env gather/scatter. Game steps perform dozens of seat-indexed
# accesses, and these helpers keep every such access a small elementwise
# op that fuses with its neighbours (the arrays are 4-24 wide). Whether
# plain indexing ties on the GPU is not measured yet.
# --------------------------------------------------------------------------
def onehot_eq(i: jax.Array, size: int) -> jax.Array:
    """Boolean one-hot row: arange(size) == i (all-False when i is out
    of range, unlike a clamping gather)."""
    return jnp.arange(size) == i


def read_at(arr: jax.Array, i: jax.Array, size: int) -> jax.Array:
    """arr[i] as a one-hot contraction (bool arrays use any-of)."""
    oh = onehot_eq(i, size)
    if arr.dtype == jnp.bool_:
        return jnp.any(arr & oh)
    return jnp.sum(jnp.where(oh, arr, 0))


def write_at(arr: jax.Array, i: jax.Array, val, size: int) -> jax.Array:
    """arr.at[i].set(val) as a where()."""
    return jnp.where(onehot_eq(i, size), val, arr)


def read_row(arr2d: jax.Array, i: jax.Array, size: int) -> jax.Array:
    """arr2d[i] (row select) as a one-hot contraction over axis 0."""
    oh = onehot_eq(i, size)
    return jnp.sum(jnp.where(oh[:, None], arr2d, 0), axis=0)


def first_true_clockwise(ok: jax.Array, frm: jax.Array, n) -> jax.Array:
    """Index of the first True in ``ok`` clockwise after ``frm``
    (wrapping through frm itself last); (frm+1) % n when none are True.

    ``ok`` may be longer than the active player count ``n`` (padded seat
    arrays) as long as padded entries are False. Distance-argmin
    formulation — no gather. Shared turn-order primitive for the
    multiplayer envs (liars_dice next-alive, skull next-alive /
    next-non-passed)."""
    size = ok.shape[-1]
    idx = jnp.arange(size)
    dist = (idx - frm - 1) % n
    d = jnp.where(ok, dist, size + 1)
    return jnp.where(
        jnp.any(ok), jnp.argmin(d), (frm + 1) % n
    ).astype(jnp.int32)


def push_ring_row(
    hist: jax.Array, hist_len: jax.Array, entry: jax.Array, size: int
):
    """Append ``entry`` (int row [W]) to a fixed ``[size, W]`` history
    ring: shift-on-full, one-hot row write (no scatter). Shared by the
    bid histories the games encode into observations (liars_dice.rs
    BidHistory:93-130, skull.rs:46-49). Returns (hist, hist_len)."""
    full = hist_len >= size
    shifted = jnp.where(full, jnp.roll(hist, -1, axis=0), hist)
    at = jnp.where(full, size - 1, hist_len)
    row = jnp.arange(size)[:, None] == at
    return (
        jnp.where(row, entry[None, :], shifted),
        jnp.minimum(hist_len + 1, size),
    )


@dataclass(frozen=True)
class EnvSpec:
    """Static environment description.

    Mirrors the reference trait's associated consts (src/env.rs:26-76).
    """

    name: str
    obs_dim: int
    num_actions: int
    num_players: int = 1
    obs_shape: Optional[Tuple[int, int, int]] = None  # (H, W, C) for CNN
    privileged_obs_dim: Optional[int] = None  # CTDE critic input (padded)
    # Reference trait default (env.rs:53); skull/liars_dice override to
    # 1.0, connect_four to 0.4 — cartpole inherits this.
    eval_temp: float = 0.3
    # (move_number, temp) — after move_number, eval temperature switches
    eval_temp_cutoff: Optional[Tuple[int, float]] = None
    variable_player_count: bool = False
    max_episode_steps: Optional[int] = None


class Environment:
    """Base class: subclasses provide pure functions over their state."""

    spec: EnvSpec
    # State fields preserved across auto-resets and settable per rollout by
    # the trainer (e.g. a scheduled reward-shaping coefficient — the
    # reference's set_step + Schedule mechanism, env.rs:167-172).
    context_fields: Tuple[str, ...] = ()

    # -- core ----------------------------------------------------------
    def reset(self, key: jax.Array) -> State:
        raise NotImplementedError

    def step(self, state: State, action: jax.Array) -> State:
        """Apply ``action`` for the current player; returns the new state.

        The new state must expose ``rewards`` (f32[P], rewards emitted by
        this step), ``done`` (bool), and ``step_idx`` (i32).
        """
        raise NotImplementedError

    def obs(self, state: State) -> jax.Array:
        raise NotImplementedError

    # -- optional surface ------------------------------------------------
    def action_mask(self, state: State) -> jax.Array:
        """bool[A]; True = legal. Default: everything legal."""
        return jnp.ones((self.spec.num_actions,), dtype=jnp.bool_)

    def current_player(self, state: State) -> jax.Array:
        return jnp.zeros((), dtype=jnp.int32)

    def privileged_obs(self, state: State) -> jax.Array:
        raise NotImplementedError(
            f"{self.spec.name} does not provide privileged observations"
        )

    def game_outcome(self, state: State) -> jax.Array:
        """Final placements i32[P] (1-indexed, 1 = winner; ties share a
        placement — '1224' competition ranking, src/env.rs:21). Valid only
        when ``state.done``; single-player envs return all-ones."""
        return jnp.ones((self.spec.num_players,), dtype=jnp.int32)

    def active_player_count(self, state: State) -> jax.Array:
        """Number of players actually in this episode (variable-count games)."""
        return jnp.asarray(self.spec.num_players, dtype=jnp.int32)

    # -- reward shaping hook (Liar's Dice / Skull survival bonuses) -----
    def set_reward_shaping(self, coef: float) -> "Environment":
        """Return an env configured with a shaping coefficient; the value is
        fed per-update as a traced scalar via state, so the default is a
        no-op."""
        return self

    # -- human-facing helpers (eval/watch/interactive parity) -----------
    def render(self, state: State) -> Optional[str]:
        return None

    def describe_action(self, action: int) -> str:
        return f"Action {action}"

    def parse_action(self, text: str) -> int:
        return int(text.strip())


class EpisodeLog(struct.PyTreeNode):
    """Per-step episode-completion record emitted by autoreset_step.

    ``completed`` flags rows where an episode finished at this step; the
    other fields are only meaningful there.
    """

    completed: jax.Array  # bool
    total_rewards: jax.Array  # f32[P] summed over the episode
    length: jax.Array  # i32
    outcome: jax.Array  # i32[P] placements (1-indexed)
    active_players: jax.Array  # i32


class EpisodeAccumulator(struct.PyTreeNode):
    """Running per-env episode accumulators carried through the rollout scan."""

    reward_sum: jax.Array  # f32[P]
    length: jax.Array  # i32

    @staticmethod
    def zero(num_players: int) -> "EpisodeAccumulator":
        return EpisodeAccumulator(
            reward_sum=jnp.zeros((num_players,), dtype=jnp.float32),
            length=jnp.zeros((), dtype=jnp.int32),
        )


def tree_select(pred: jax.Array, on_true: State, on_false: State) -> State:
    """Elementwise select between two identically-shaped pytrees."""
    return jax.tree_util.tree_map(
        lambda a, b: jnp.where(
            pred.reshape(pred.shape + (1,) * (a.ndim - pred.ndim)), a, b
        ),
        on_true,
        on_false,
    )


def autoreset_step(
    env: Environment,
    state: State,
    acc: EpisodeAccumulator,
    action: jax.Array,
    reset_key: jax.Array,
) -> Tuple[State, EpisodeAccumulator, State, EpisodeLog]:
    """Step one env with auto-reset.

    Returns (next_state_after_autoreset, next_acc, terminal_state, log).
    ``terminal_state`` is the pre-reset stepped state — rewards/done are
    read from it; on done the outcome is captured from it before the
    reset state replaces it.
    """
    stepped = env.step(state, action)
    done = stepped.done
    rewards = stepped.rewards

    new_sum = acc.reward_sum + rewards
    new_len = acc.length + 1

    log = EpisodeLog(
        completed=done,
        total_rewards=new_sum,
        length=new_len,
        outcome=env.game_outcome(stepped),
        active_players=env.active_player_count(stepped),
    )

    fresh = env.reset(reset_key)
    # Preserve trainer-set context (e.g. shaping coefficient) across resets.
    if env.context_fields:
        fresh = fresh.replace(
            **{f: getattr(stepped, f) for f in env.context_fields}
        )
    next_state = tree_select(done, fresh, stepped)
    next_acc = EpisodeAccumulator(
        reward_sum=jnp.where(done, jnp.zeros_like(new_sum), new_sum),
        length=jnp.where(done, jnp.zeros_like(new_len), new_len),
    )
    return next_state, next_acc, stepped, log
