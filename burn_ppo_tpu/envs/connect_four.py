"""Connect Four: 7x6 two-player zero-sum, pure JAX.

Behavioral parity with the reference (src/envs/connect_four.rs):
86-dim observation = 42-cell board planes per player + 2-dim turn one-hot
(connect_four.rs:186-206); turn-based self-play in a single env; win +1 /
loss -1 / draw 0 (connect_four.rs:249-282); column action mask
(connect_four.rs:289-295); outcome placements [1,2]/[2,1]/[1,1]
(connect_four.rs:301-310); eval temperature 0.4 with (10, 0.0) cutoff
(connect_four.rs:219-221).

Layout deviation (deliberate): the spatial slice of the observation is
stored channels-last [row, col, player] so the CNN's
``reshape(B, 6, 7, 2)`` sees true board geometry. The reference flattens
plane-major and then reshapes channels-last, which scrambles rows across
channels (cnn.rs:234-262 applied to connect_four.rs:186-199); the MLP is
layout-invariant and the CNN only benefits.

Win detection is a branchless whole-board check over all 69 4-in-a-row
windows — a handful of fused VPU ops per step instead of the reference's
per-direction scalar walk, and identical in outcome.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from burn_ppo_tpu import struct

from burn_ppo_tpu.envs import register
from burn_ppo_tpu.envs.base import Environment, EnvSpec

ROWS, COLS, WIN = 6, 7, 4


def _has_win(plane: jax.Array) -> jax.Array:
    """True if any 4-in-a-row in a bool[6,7] piece plane."""
    h = plane[:, 0:4] & plane[:, 1:5] & plane[:, 2:6] & plane[:, 3:7]
    v = plane[0:3, :] & plane[1:4, :] & plane[2:5, :] & plane[3:6, :]
    d1 = plane[0:3, 0:4] & plane[1:4, 1:5] & plane[2:5, 2:6] & plane[3:6, 3:7]
    d2 = plane[0:3, 3:7] & plane[1:4, 2:6] & plane[2:5, 1:5] & plane[3:6, 0:4]
    return jnp.any(h) | jnp.any(v) | jnp.any(d1) | jnp.any(d2)


class ConnectFourState(struct.PyTreeNode):
    board: jax.Array  # i32[6,7]: 0 empty, 1 P0, 2 P1 (row 0 = top)
    current: jax.Array  # i32 current player (0/1)
    winner: jax.Array  # i32: -1 none, 0/1 winner, 2 draw
    rewards: jax.Array  # f32[2]
    done: jax.Array  # bool
    step_idx: jax.Array  # i32
    key: jax.Array


class ConnectFour(Environment):
    spec = EnvSpec(
        name="connect_four",
        obs_dim=ROWS * COLS * 2 + 2,
        num_actions=COLS,
        num_players=2,
        obs_shape=(ROWS, COLS, 2),
        eval_temp=0.4,
        eval_temp_cutoff=(10, 0.0),
    )

    def reset(self, key: jax.Array) -> ConnectFourState:
        return ConnectFourState(
            board=jnp.zeros((ROWS, COLS), jnp.int32),
            current=jnp.zeros((), jnp.int32),
            winner=jnp.full((), -1, jnp.int32),
            rewards=jnp.zeros((2,), jnp.float32),
            done=jnp.zeros((), jnp.bool_),
            step_idx=jnp.zeros((), jnp.int32),
            key=key,
        )

    def step(self, state: ConnectFourState, action: jax.Array) -> ConnectFourState:
        # Column/cell accesses are one-hot contractions, not per-env
        # gathers/scatters (envs/base.py:onehot_eq note).
        # Out-of-range actions end the episode with zero rewards like the
        # reference (connect_four.rs:257: `action >= COLS` joins the
        # invalid-move branch) — NOT clipped into a playable column.
        out_of_range = (action < 0) | (action >= COLS)
        action = jnp.clip(action, 0, COLS - 1)
        col_oh = jnp.arange(COLS) == action
        col = jnp.sum(jnp.where(col_oh[None, :], state.board, 0), axis=1)
        filled = jnp.sum((col != 0).astype(jnp.int32))
        drop_row = ROWS - 1 - filled
        invalid = (filled >= ROWS) | state.done | out_of_range

        piece = state.current + 1
        cell = (jnp.arange(ROWS) == drop_row)[:, None] & col_oh[None, :]
        board = jnp.where(cell & ~invalid, piece, state.board)

        won = _has_win(board == piece) & ~invalid
        full = jnp.all(board[0, :] != 0)
        done = won | full | invalid

        cur, other = state.current, 1 - state.current
        rewards = jnp.where(
            won,
            jnp.where(jnp.arange(2) == cur, 1.0, -1.0),
            0.0,
        ).astype(jnp.float32)
        winner = jnp.where(
            won, cur, jnp.where(full & ~won, 2, jnp.where(invalid, state.winner, -1))
        ).astype(jnp.int32)

        return state.replace(
            board=board,
            current=jnp.where(done, cur, other),
            winner=winner,
            rewards=rewards,
            done=done,
            step_idx=state.step_idx + 1,
        )

    def obs(self, state: ConnectFourState) -> jax.Array:
        planes = jnp.stack(
            [
                (state.board == 1).astype(jnp.float32),
                (state.board == 2).astype(jnp.float32),
            ],
            axis=-1,
        )  # [6, 7, 2] channels-last
        turn = jax.nn.one_hot(state.current, 2, dtype=jnp.float32)
        return jnp.concatenate([planes.reshape(-1), turn])

    def action_mask(self, state: ConnectFourState) -> jax.Array:
        return state.board[0, :] == 0

    def current_player(self, state: ConnectFourState) -> jax.Array:
        return state.current

    def game_outcome(self, state: ConnectFourState) -> jax.Array:
        """[1,2] P0 wins / [2,1] P1 wins / [1,1] draw (connect_four.rs:301).

        A game terminated by an invalid move (done with winner still -1)
        reports the no-outcome sentinel [0,0]: the reference leaves
        game_over false there (connect_four.rs:256-259), so the episode
        is excluded from outcome statistics — it must not be logged as a
        draw. Stats consumers mask zero outcomes (episode_stats.py,
        eval.py)."""
        p0_win = jnp.array([1, 2], jnp.int32)
        p1_win = jnp.array([2, 1], jnp.int32)
        draw = jnp.array([1, 1], jnp.int32)
        none = jnp.array([0, 0], jnp.int32)
        full = jnp.all(state.board[0, :] != 0)
        return jnp.where(
            state.winner == 0,
            p0_win,
            jnp.where(
                state.winner == 1,
                p1_win,
                jnp.where(full, draw, none),
            ),
        )

    def render(self, state) -> str:
        board = jax.device_get(state.board)
        sym = {0: ".", 1: "X", 2: "O"}
        lines = ["  1 2 3 4 5 6 7", " ---------------"]
        for r in range(ROWS):
            lines.append("| " + " ".join(sym[int(c)] for c in board[r]) + " |")
        lines.append(" ---------------")
        if bool(state.done):
            w = int(state.winner)
            msg = {0: "X (Player 0) wins!", 1: "O (Player 1) wins!"}.get(w, "Draw!")
            lines.append(msg)
        else:
            lines.append(
                f"Turn: {'X (Player 0)' if int(state.current) == 0 else 'O (Player 1)'}"
            )
        return "\n".join(lines)

    def describe_action(self, action: int) -> str:
        return f"Column {action + 1}"

    def parse_action(self, text: str) -> int:
        col = int(text.strip())
        if 1 <= col <= 7:
            return col - 1
        raise ValueError("Enter column 1-7")


register("connect_four", ConnectFour)
