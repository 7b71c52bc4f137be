"""Liar's Dice: 4-player bluffing dice game, pure JAX.

Behavioral parity with the reference (src/envs/liars_dice.rs):
  * 270-dim player-relative observation: own dice one-hot (12), dice
    counts (4), alive flags (4), absolute seat one-hot (4), current-bid
    one-hot (48), has-bid (1), bid count /20 (1), last-bidder (4), and a
    16-entry bid-history ring buffer at 12 floats each
    (liars_dice.rs:25-44, 300-380);
  * 49 actions = 48 bids (quantity 1-8 x face 1-6) + call-liar
    (liars_dice.rs:19-21, 76-90);
  * wild 1s: for faces 2-6 ones count as the bid face; bidding 1s counts
    only actual 1s (liars_dice.rs:210-230);
  * call resolution: loser drops a die, elimination order tracked, loser
    (or next alive) opens the next round, all dice reroll
    (liars_dice.rs:266-305);
  * placement rewards [+1.0, +0.33, -0.33, -1.0] assigned to EVERY
    player at game end (liars_dice.rs:536-546), plus a per-round
    survival shaping bonus whose coefficient follows a schedule
    evaluated on the host and threaded in as rollout context
    (liars_dice.rs:529-535; set_step equivalent);
  * CTDE privileged observation: absolute-indexed global state + every
    player's private dice, 110 floats padded to 120
    (liars_dice.rs:52-67, 639-731).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from burn_ppo_tpu import struct

from burn_ppo_tpu.envs import register
from burn_ppo_tpu.envs.base import (
    Environment,
    EnvSpec,
    first_true_clockwise,
    onehot_eq,
    push_ring_row,
    read_at,
    read_row,
)

P = 4  # players
DICE = 2  # dice per player
FACES = 6
MAX_DICE = P * DICE  # 8
A = MAX_DICE * FACES + 1  # 49
CALL = A - 1  # 48
HIST = 16
HIST_ENTRY = P + 1 + FACES + 1  # 12
OBS_DIM = (
    DICE * FACES + P + P + P + MAX_DICE * FACES + 1 + 1 + P + HIST * HIST_ENTRY
)  # 270
PRIV_DIM = 120  # 110 exact, padded (liars_dice.rs:459)
# Plain tuple, NOT a module-level jnp constant: materializing a device
# array at import time would initialize the JAX backend before callers
# can choose the platform (and a supervisor parent would open the card).
PLACEMENT_REWARDS = (1.0, 0.33, -0.33, -1.0)


class LiarsDiceState(struct.PyTreeNode):
    dice: jax.Array  # i32[P, DICE] face values 1-6
    dice_count: jax.Array  # i32[P]
    current: jax.Array  # i32
    bid_qty: jax.Array  # i32 (0 = no bid)
    bid_face: jax.Array  # i32 (0 = no bid)
    last_bidder: jax.Array  # i32 (-1 = none)
    bid_count: jax.Array  # i32
    hist: jax.Array  # i32[HIST, 3] (bidder, qty, face)
    hist_len: jax.Array  # i32
    placements: jax.Array  # i32[P] (0 until assigned)
    num_eliminated: jax.Array  # i32
    game_over: jax.Array  # bool
    rewards: jax.Array  # f32[P]
    done: jax.Array  # bool
    step_idx: jax.Array  # i32
    shaping_coef: jax.Array  # f32, threaded from the host schedule
    key: jax.Array


def _roll_dice(key):
    return jax.random.randint(key, (P, DICE), 1, FACES + 1).astype(jnp.int32)


def _next_alive(dice_count, from_player):
    """First alive player clockwise after ``from_player``
    (base.first_true_clockwise, the shared turn-order primitive)."""
    return first_true_clockwise(dice_count > 0, from_player, P)


def _count_face(dice, dice_count, face):
    """Dice showing ``face`` with wild 1s (liars_dice.rs:210-230)."""
    live = jnp.arange(DICE)[None, :] < dice_count[:, None]  # [P, DICE]
    is_face = dice == face
    is_wild = (dice == 1) & (face != 1)
    return jnp.sum(((is_face | is_wild) & live).astype(jnp.int32))


class LiarsDice(Environment):
    spec = EnvSpec(
        name="liars_dice",
        obs_dim=OBS_DIM,
        num_actions=A,
        num_players=P,
        privileged_obs_dim=PRIV_DIM,
        eval_temp=1.0,  # stochastic play essential for bluffing
    )
    context_fields = ("shaping_coef",)

    def reset(self, key: jax.Array) -> LiarsDiceState:
        key, k_dice = jax.random.split(key)
        return LiarsDiceState(
            dice=_roll_dice(k_dice),
            dice_count=jnp.full((P,), DICE, jnp.int32),
            current=jnp.zeros((), jnp.int32),
            bid_qty=jnp.zeros((), jnp.int32),
            bid_face=jnp.zeros((), jnp.int32),
            last_bidder=jnp.full((), -1, jnp.int32),
            bid_count=jnp.zeros((), jnp.int32),
            hist=jnp.zeros((HIST, 3), jnp.int32),
            hist_len=jnp.zeros((), jnp.int32),
            placements=jnp.zeros((P,), jnp.int32),
            num_eliminated=jnp.zeros((), jnp.int32),
            game_over=jnp.zeros((), jnp.bool_),
            rewards=jnp.zeros((P,), jnp.float32),
            done=jnp.zeros((), jnp.bool_),
            step_idx=jnp.zeros((), jnp.int32),
            shaping_coef=jnp.zeros((), jnp.float32),
            key=key,
        )

    # ------------------------------------------------------------------
    def step(self, state: LiarsDiceState, action: jax.Array) -> LiarsDiceState:
        # Out-of-range actions are INVALID, as in the reference (an
        # out-of-range decode yields an illegal bid, liars_dice.rs:493-498
        # -> game over, zero rewards). Clipping before the validity check
        # would remap e.g. 55 onto CALL (48) and resolve a liar call the
        # caller never chose.
        in_range = (action >= 0) & (action < A)
        action = jnp.clip(action, 0, A - 1)
        cur = state.current
        total = jnp.sum(state.dice_count)

        is_call = action == CALL
        qty = action // FACES + 1
        face = action % FACES + 1

        no_bid = state.bid_qty == 0
        bid_higher = (qty > state.bid_qty) | (
            (qty == state.bid_qty) & (face > state.bid_face)
        )
        bid_valid = (~is_call) & (qty <= total) & (no_bid | bid_higher)
        call_valid = is_call & ~no_bid
        invalid = state.game_over | ~in_range | ~(bid_valid | call_valid)

        # ---- bid branch --------------------------------------------------
        def apply_bid(s: LiarsDiceState) -> LiarsDiceState:
            entry = jnp.stack([cur, qty, face]).astype(jnp.int32)
            hist, hist_len = push_ring_row(s.hist, s.hist_len, entry, HIST)
            return s.replace(
                bid_qty=qty,
                bid_face=face,
                last_bidder=cur,
                bid_count=s.bid_count + 1,
                hist=hist,
                hist_len=hist_len,
                current=_next_alive(s.dice_count, cur),
                rewards=jnp.zeros((P,), jnp.float32),
                done=jnp.zeros((), jnp.bool_),
            )

        # ---- call branch -------------------------------------------------
        def apply_call(s: LiarsDiceState) -> LiarsDiceState:
            actual = _count_face(s.dice, s.dice_count, s.bid_face)
            caller_correct = actual < s.bid_qty
            loser = jnp.where(caller_correct, s.last_bidder, cur).astype(jnp.int32)

            oh_loser = onehot_eq(loser, P)
            dice_count = s.dice_count - oh_loser.astype(jnp.int32)
            eliminated_now = read_at(dice_count, loser, P) == 0
            # placement for a fresh elimination: P - num_eliminated
            placements = jnp.where(
                eliminated_now & oh_loser,
                P - s.num_eliminated,
                s.placements,
            )
            num_elim = s.num_eliminated + eliminated_now.astype(jnp.int32)

            alive = dice_count > 0
            game_over = jnp.sum(alive.astype(jnp.int32)) <= 1
            winner = jnp.argmax(alive).astype(jnp.int32)
            placements = jnp.where(
                game_over & onehot_eq(winner, P), 1, placements
            )

            # Survival shaping for players alive after resolution
            rewards = jnp.where(alive, s.shaping_coef, 0.0).astype(jnp.float32)
            # Final placement rewards REPLACE shaping at game end (=, not +=)
            pl_oh = (
                jnp.clip(placements - 1, 0, P - 1)[:, None]
                == jnp.arange(P)[None, :]
            )
            final = jnp.sum(
                jnp.where(
                    pl_oh,
                    jnp.asarray(PLACEMENT_REWARDS, jnp.float32)[None, :],
                    0.0,
                ),
                axis=1,
            )
            rewards = jnp.where(game_over, final, rewards)

            next_player = jnp.where(
                read_at(dice_count, loser, P) > 0,
                loser,
                _next_alive(dice_count, loser),
            ).astype(jnp.int32)

            key, k_dice = jax.random.split(s.key)
            # Round state resets only when a NEW round starts; the
            # terminal state keeps the decisive bid and history (the
            # reference's start_new_round early-returns when <=1 player
            # is alive, liars_dice.rs:277-289) so render/watch of a
            # finished game shows the final call, not "No bid yet".
            zero = jnp.zeros((), jnp.int32)
            return s.replace(
                dice=jnp.where(game_over, s.dice, _roll_dice(k_dice)),
                dice_count=dice_count,
                current=jnp.where(game_over, cur, next_player),
                bid_qty=jnp.where(game_over, s.bid_qty, zero),
                bid_face=jnp.where(game_over, s.bid_face, zero),
                last_bidder=jnp.where(
                    game_over, s.last_bidder, jnp.full((), -1, jnp.int32)
                ),
                bid_count=jnp.where(game_over, s.bid_count, zero),
                hist=jnp.where(game_over, s.hist, jnp.zeros((HIST, 3), jnp.int32)),
                hist_len=jnp.where(game_over, s.hist_len, zero),
                placements=placements,
                num_eliminated=num_elim,
                game_over=game_over,
                rewards=rewards,
                done=game_over,
                key=key,
            )

        def apply_invalid(s: LiarsDiceState) -> LiarsDiceState:
            return s.replace(
                game_over=jnp.ones((), jnp.bool_),
                rewards=jnp.zeros((P,), jnp.float32),
                done=jnp.ones((), jnp.bool_),
            )

        branch = jnp.where(invalid, 0, jnp.where(is_call, 1, 2))
        new_state = jax.lax.switch(
            branch, [apply_invalid, apply_call, apply_bid], state
        )
        return new_state.replace(step_idx=state.step_idx + 1)

    # ------------------------------------------------------------------
    def obs(self, state: LiarsDiceState) -> jax.Array:
        cur = state.current
        rel = (jnp.arange(P) + cur) % P  # relative -> absolute seat map

        # Own dice one-hot (12): die i valid if i < dice_count[cur]
        own = read_row(state.dice, cur, P)  # [DICE]
        live = jnp.arange(DICE) < read_at(state.dice_count, cur, P)
        own_oh = (
            jax.nn.one_hot(own - 1, FACES) * live[:, None].astype(jnp.float32)
        ).reshape(-1)

        # Player-relative permutation as a one-hot contraction (no gather).
        Mrel = rel[:, None] == jnp.arange(P)[None, :]
        dc_rel = jnp.sum(jnp.where(Mrel, state.dice_count[None, :], 0), axis=1)
        counts = dc_rel.astype(jnp.float32) / DICE  # [4]
        alive = (dc_rel > 0).astype(jnp.float32)  # [4]
        seat = jax.nn.one_hot(cur, P)  # absolute

        has_bid = state.bid_qty > 0
        bid_idx = (state.bid_qty - 1) * FACES + (state.bid_face - 1)
        bid_oh = jnp.where(
            has_bid, jax.nn.one_hot(bid_idx, MAX_DICE * FACES), jnp.zeros(MAX_DICE * FACES)
        )
        bid_flag = has_bid.astype(jnp.float32)[None]
        bid_cnt = jnp.minimum(state.bid_count.astype(jnp.float32) / 20.0, 1.0)[None]

        rel_bidder = (state.last_bidder + P - cur) % P
        last_oh = jnp.where(
            state.last_bidder >= 0, jax.nn.one_hot(rel_bidder, P), jnp.zeros(P)
        )

        # Bid history (16 x 12, relative bidder indices)
        idx = jnp.arange(HIST)
        valid = (idx < state.hist_len)[:, None].astype(jnp.float32)  # [16,1]
        h_bidder = (state.hist[:, 0] + P - cur) % P
        h_qty = state.hist[:, 1].astype(jnp.float32) / MAX_DICE
        h_face = state.hist[:, 2]
        hist_obs = jnp.concatenate(
            [
                jax.nn.one_hot(h_bidder, P) * valid,
                (h_qty * valid[:, 0])[:, None],
                jax.nn.one_hot(h_face - 1, FACES) * valid,
                valid,
            ],
            axis=1,
        ).reshape(-1)

        return jnp.concatenate(
            [own_oh, counts, alive, seat, bid_oh, bid_flag, bid_cnt, last_oh, hist_obs]
        ).astype(jnp.float32)

    # ------------------------------------------------------------------
    def action_mask(self, state: LiarsDiceState) -> jax.Array:
        total = jnp.sum(state.dice_count)
        q = jnp.arange(1, MAX_DICE + 1)[:, None]  # [8,1]
        f = jnp.arange(1, FACES + 1)[None, :]  # [1,6]
        no_bid = state.bid_qty == 0
        higher = (q > state.bid_qty) | ((q == state.bid_qty) & (f > state.bid_face))
        bids = (q <= total) & (no_bid | higher)  # [8,6]
        call = (~no_bid)[None]
        mask = jnp.concatenate([bids.reshape(-1), call])
        playable = (
            read_at(state.dice_count, state.current, P) > 0
        ) & ~state.game_over
        return mask & playable

    def current_player(self, state: LiarsDiceState) -> jax.Array:
        return state.current

    def game_outcome(self, state: LiarsDiceState) -> jax.Array:
        return state.placements

    # ------------------------------------------------------------------
    def privileged_obs(self, state: LiarsDiceState) -> jax.Array:
        parts = [
            (state.current.astype(jnp.float32) / P)[None],
            jnp.where(state.bid_qty > 0, state.bid_qty.astype(jnp.float32) / MAX_DICE, 0.0)[None],
            jnp.where(state.bid_qty > 0, state.bid_face.astype(jnp.float32) / FACES, 0.0)[None],
            jnp.where(
                state.last_bidder >= 0,
                state.last_bidder.astype(jnp.float32) / P,
                -1.0,
            )[None],
            (state.bid_count.astype(jnp.float32) / (P * 3))[None],
        ]
        # Bid history: most recent first (liars_dice.rs .rev().take()).
        idx = jnp.arange(HIST)
        src = state.hist_len - 1 - idx  # recent -> old; negative = invalid
        valid = (src >= 0).astype(jnp.float32)
        src_c = jnp.clip(src, 0, HIST - 1)
        # Row selection as a one-hot contraction (no gather).
        Msrc = src_c[:, None] == jnp.arange(HIST)[None, :]
        entries = jnp.sum(
            jnp.where(Msrc[:, :, None], state.hist[None, :, :], 0), axis=1
        )  # [16, 3]
        hist = jnp.stack(
            [
                entries[:, 0].astype(jnp.float32) / P * valid,
                entries[:, 1].astype(jnp.float32) / MAX_DICE * valid,
                entries[:, 2].astype(jnp.float32) / FACES * valid,
            ],
            axis=1,
        ).reshape(-1)
        parts.append(hist)
        parts.append(state.game_over.astype(jnp.float32)[None])

        live = jnp.arange(DICE)[None, :] < state.dice_count[:, None]  # [P, DICE]
        dice_oh = (
            jax.nn.one_hot(state.dice - 1, FACES)
            * live[:, :, None].astype(jnp.float32)
        ).reshape(P, -1)
        per_player = jnp.concatenate(
            [
                (state.dice_count.astype(jnp.float32) / DICE)[:, None],
                (state.dice_count > 0).astype(jnp.float32)[:, None],
                dice_oh,
            ],
            axis=1,
        ).reshape(-1)
        parts.append(per_player)

        flat = jnp.concatenate(parts)
        return jnp.pad(flat, (0, PRIV_DIM - flat.shape[0]))

    # ------------------------------------------------------------------
    def render(self, state) -> str:
        import numpy as np

        lines = ["=== Liar's Dice ===", ""]
        dc = np.asarray(state.dice_count)
        dice = np.asarray(state.dice)
        cur = int(state.current)
        for p in range(P):
            marker = "->" if p == cur else "  "
            status = "OUT" if dc[p] == 0 else f"{dc[p]} dice"
            if p == cur:
                ds = " ".join(f"[{dice[p, i]}]" for i in range(dc[p]))
            elif dc[p] > 0:
                ds = " ".join("[?]" for _ in range(dc[p]))
            else:
                ds = ""
            lines.append(f"{marker} Player {p}: {status}  {ds}")
        lines.append("")
        if int(state.bid_qty) > 0:
            lines.append(
                f"Current bid: {int(state.bid_qty)} {int(state.bid_face)}s "
                f"(by Player {int(state.last_bidder)})"
            )
        else:
            lines.append("No bid yet - first player to bid")
        if bool(state.game_over):
            winner = int(np.argmax(dc > 0))
            lines.append(f"Game Over: Player {winner} wins!")
        return "\n".join(lines)

    def describe_action(self, action: int) -> str:
        if action == CALL:
            return "Call Liar!"
        return f"Bid: {action // FACES + 1} {action % FACES + 1}s"

    def parse_action(self, text: str) -> int:
        t = text.strip().lower()
        if t in ("call", "liar", "l"):
            return CALL
        parts = t.split()
        if len(parts) >= 2:
            qty = int(parts[0])
            face = int(parts[1].rstrip("s"))
            if 1 <= face <= 6 and 1 <= qty <= 8:
                return (qty - 1) * FACES + (face - 1)
        raise ValueError("Enter 'N Fs' (e.g., '3 4s') or 'call'")


register("liars_dice", LiarsDice)
