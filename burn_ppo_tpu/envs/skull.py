"""Skull (Skull & Roses): 2-6 player bluffing game, pure JAX.

Behavioral parity with the reference (src/envs/skull.rs):
  * 33 actions: place-skull, place-rose, bids 1-24, pass, reveal-P0..P5
    (skull.rs:20-26);
  * 135-dim player-relative observation incl. own hand/stack, per-player
    stats, phase one-hot, bid state, player-count one-hot and an 8-entry
    bid history at 8 floats each (skull.rs:29-64, 534-672);
  * phase machine placing -> bidding -> revealing with bidder's-choice
    reveal, must-reveal-own-first, bid==total shortcut, pass-out ending
    (skull.rs:1103-1252, 673-725);
  * failed challenge: bidder loses a RANDOM coaster, skull owner starts
    the next round if the bidder got eliminated (skull.rs:1190-1225);
  * win = 2 successful challenges or last player alive (skull.rs:1227-1246);
  * final reward 1 - 2(p-1)/(n-1) with tie averaging over placements
    computed by winner > wins > coasters > elimination order
    (skull.rs:406-530);
  * reward shaping: +coef to the bidder on success, -coef/4 on failure
    (skull.rs:446-463);
  * CTDE privileged obs: absolute global state + per-player private
    hands, 103 floats padded to 200 (skull.rs:71-88, 1480-1580).

The runtime `set_num_players` of the reference maps to a *static* player
count per env instance (`with_num_players`), matching how training uses
it (a fixed count per run via player_count.get_fixed_count(),
reference main.rs:1998) while keeping XLA shapes static.
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
    onehot_eq as _oh,
    push_ring_row,
    read_at as _read,
    write_at as _write,
)

MAXP = 6
CARDS = 4  # per player: 3 roses + 1 skull
ROSES = 3
MAX_BID = MAXP * CARDS  # 24
WINS_TO_WIN = 2

PLACE_SKULL = 0
PLACE_ROSE = 1
BID_BASE = 2
PASS = BID_BASE + MAX_BID  # 26
REVEAL_BASE = PASS + 1  # 27
A = REVEAL_BASE + MAXP  # 33

HIST = 8
HIST_ENTRY = MAXP + 2  # 8
OBS_DIM = 4 + 4 + 6 + 6 + 6 + 6 + 6 + 3 + 1 + 6 + 6 + 6 + 6 + 5 + HIST * HIST_ENTRY  # 135
PRIV_DIM = 200  # 103 exact, padded (skull.rs:1059)

# cards in stacks: 0 empty, 1 rose, 2 skull
ROSE_C, SKULL_C = 1, 2


# One-hot read/write primitives (_oh/_read/_write, imported above):
# every seat-indexed access is an elementwise op, never a per-env
# gather/scatter — see the note at envs/base.py:onehot_eq.


class SkullState(struct.PyTreeNode):
    has_trap: jax.Array  # bool[6]
    rose_count: jax.Array  # i32[6]
    wins: jax.Array  # i32[6]
    # Stack contents are FLAT [MAXP*CARDS] (player*CARDS + pos), and the
    # per-player skull/rose counts that mask/obs need every step are
    # maintained
    # INCREMENTALLY (place adds, round reset zeros; reveals don't change
    # contents), so nothing reduces over the contents array anymore.
    stack: jax.Array  # i32[24] flat
    skulls_in: jax.Array  # i32[6] skulls placed this round, per player
    roses_in: jax.Array  # i32[6] roses placed this round, per player
    stack_len: jax.Array  # i32[6]
    passed: jax.Array  # bool[6]
    phase: jax.Array  # i32: 0 placing, 1 bidding, 2 revealing
    current: jax.Array  # i32
    round_starter: jax.Array  # i32
    current_bid: jax.Array  # i32 (0 = none)
    current_bidder: jax.Array  # i32 (-1)
    hist: jax.Array  # i32[8, 2] (player, bid; 0 = pass)
    hist_len: jax.Array  # i32
    revealed: jax.Array  # i32[6]
    roses_found: jax.Array  # i32
    must_reveal_own: jax.Array  # bool
    elim_pos: jax.Array  # i32[6] (-1 = not eliminated)
    num_eliminated: jax.Array  # i32
    game_over: jax.Array  # bool
    winner: jax.Array  # i32 (-1)
    rewards: jax.Array  # f32[n]
    done: jax.Array  # bool
    step_idx: jax.Array  # i32
    shaping_coef: jax.Array  # f32
    # Interactive-mode discard override: -1 random (default), 0 skull,
    # 1 rose — the physical game lets the loser choose which coaster to
    # discard (reference lose_coaster_specified, skull.rs:330-377).
    forced_discard: jax.Array  # i32
    key: jax.Array


class Skull(Environment):
    context_fields = ("shaping_coef",)

    def __init__(self, num_players: int = 4):
        if not 2 <= num_players <= MAXP:
            raise ValueError(f"Skull supports 2-{MAXP} players, got {num_players}")
        self.n = num_players
        self.spec = EnvSpec(
            name="skull",
            obs_dim=OBS_DIM,
            num_actions=A,
            num_players=num_players,
            privileged_obs_dim=PRIV_DIM,
            eval_temp=1.0,
            variable_player_count=True,
        )

    def with_num_players(self, n: int) -> "Skull":
        return Skull(n)

    # -- helpers ---------------------------------------------------------
    def _exists(self):
        return jnp.arange(MAXP) < self.n

    def _alive(self, s: SkullState) -> jax.Array:
        return self._exists() & (s.has_trap | (s.rose_count > 0))

    def _coasters(self, s: SkullState) -> jax.Array:
        return s.has_trap.astype(jnp.int32) + s.rose_count

    def _first_clockwise(self, ok: jax.Array, frm: jax.Array) -> jax.Array:
        """base.first_true_clockwise over the MAXP-padded seat arrays
        (padded seats are never alive, so ok is False there)."""
        return first_true_clockwise(ok, frm, self.n)

    def _next_alive(self, s: SkullState, frm: jax.Array) -> jax.Array:
        return self._first_clockwise(self._alive(s), frm)

    def _next_non_passed(self, s: SkullState, frm: jax.Array):
        """(found: bool, idx) — next alive non-passed player clockwise."""
        ok_all = self._alive(s) & ~s.passed
        return jnp.any(ok_all), self._first_clockwise(ok_all, frm)

    def _skulls_in_stack(self, s: SkullState) -> jax.Array:
        return s.skulls_in  # incrementally maintained (see SkullState)

    def _roses_in_stack(self, s: SkullState) -> jax.Array:
        return s.roses_in

    # -- lifecycle --------------------------------------------------------
    def reset(self, key: jax.Array) -> SkullState:
        exists = self._exists()
        return SkullState(
            has_trap=exists,
            rose_count=jnp.where(exists, ROSES, 0).astype(jnp.int32),
            wins=jnp.zeros((MAXP,), jnp.int32),
            stack=jnp.zeros((MAXP * CARDS,), jnp.int32),
            skulls_in=jnp.zeros((MAXP,), jnp.int32),
            roses_in=jnp.zeros((MAXP,), jnp.int32),
            stack_len=jnp.zeros((MAXP,), jnp.int32),
            passed=jnp.zeros((MAXP,), jnp.bool_),
            phase=jnp.zeros((), jnp.int32),
            current=jnp.zeros((), jnp.int32),
            round_starter=jnp.zeros((), jnp.int32),
            current_bid=jnp.zeros((), jnp.int32),
            current_bidder=jnp.full((), -1, jnp.int32),
            hist=jnp.zeros((HIST, 2), jnp.int32),
            hist_len=jnp.zeros((), jnp.int32),
            revealed=jnp.zeros((MAXP,), jnp.int32),
            roses_found=jnp.zeros((), jnp.int32),
            must_reveal_own=jnp.zeros((), jnp.bool_),
            elim_pos=jnp.full((MAXP,), -1, jnp.int32),
            num_eliminated=jnp.zeros((), jnp.int32),
            game_over=jnp.zeros((), jnp.bool_),
            winner=jnp.full((), -1, jnp.int32),
            rewards=jnp.zeros((self.n,), jnp.float32),
            done=jnp.zeros((), jnp.bool_),
            step_idx=jnp.zeros((), jnp.int32),
            shaping_coef=jnp.zeros((), jnp.float32),
            forced_discard=jnp.full((), -1, jnp.int32),
            key=key,
        )

    # -- placements & rewards (skull.rs:406-530) --------------------------
    def _placements(self, s: SkullState) -> jax.Array:
        """Competition-ranked placements [n]: winner > wins > coasters >
        later elimination."""
        n = self.n
        idx = jnp.arange(n)
        is_winner = (s.winner == idx).astype(jnp.int32)
        wins = s.wins[:n]
        coasters = self._coasters(s)[:n]
        elim_rank = jnp.where(
            s.elim_pos[:n] >= 0, s.elim_pos[:n], s.num_eliminated
        )
        key = (
            is_winner * (1 << 24) + wins * (1 << 16) + coasters * (1 << 8) + elim_rank
        )
        better = jnp.sum((key[None, :] > key[:, None]).astype(jnp.int32), axis=1)
        return better + 1

    def _final_rewards(self, s: SkullState) -> jax.Array:
        n = self.n
        placements = self._placements(s)
        ties = jnp.sum(
            (placements[None, :] == placements[:, None]).astype(jnp.float32), axis=1
        )
        if n > 1:
            eff = (placements.astype(jnp.float32) - 1.0) + (ties - 1.0) / 2.0
            return 1.0 - 2.0 * eff / (n - 1)
        return jnp.zeros((1,), jnp.float32)

    def _start_new_round(self, s: SkullState, starter: jax.Array) -> SkullState:
        alive = self._alive(s)
        cur = jnp.where(
            _read(alive, starter, MAXP), starter, self._next_alive(s, starter)
        ).astype(jnp.int32)
        return s.replace(
            stack=jnp.zeros((MAXP * CARDS,), jnp.int32),
            skulls_in=jnp.zeros((MAXP,), jnp.int32),
            roses_in=jnp.zeros((MAXP,), jnp.int32),
            stack_len=jnp.zeros((MAXP,), jnp.int32),
            passed=jnp.zeros((MAXP,), jnp.bool_),
            revealed=jnp.zeros((MAXP,), jnp.int32),
            phase=jnp.zeros((), jnp.int32),
            current_bid=jnp.zeros((), jnp.int32),
            current_bidder=jnp.full((), -1, jnp.int32),
            hist=jnp.zeros((HIST, 2), jnp.int32),
            hist_len=jnp.zeros((), jnp.int32),
            roses_found=jnp.zeros((), jnp.int32),
            must_reveal_own=jnp.zeros((), jnp.bool_),
            current=cur,
            round_starter=cur,
        )

    def _push_hist(self, s: SkullState, player, bid) -> SkullState:
        entry = jnp.stack([player, bid]).astype(jnp.int32)
        hist, hist_len = push_ring_row(s.hist, s.hist_len, entry, HIST)
        return s.replace(hist=hist, hist_len=hist_len)

    def _to_revealing(self, s: SkullState) -> SkullState:
        return s.replace(
            phase=jnp.full((), 2, jnp.int32),
            current=s.current_bidder,
            must_reveal_own=jnp.ones((), jnp.bool_),
            roses_found=jnp.zeros((), jnp.int32),
            revealed=jnp.zeros((MAXP,), jnp.int32),
        )

    def _check_bidding_end(self, s: SkullState) -> SkullState:
        alive_np = self._alive(s) & ~s.passed
        non_passed = jnp.sum(alive_np.astype(jnp.int32))
        last_idx = jnp.argmax(alive_np).astype(jnp.int32)  # lowest-seat find
        found, nxt = self._next_non_passed(s, s.current)

        def to_reveal(s):
            return self._to_revealing(s.replace(current_bidder=last_idx))

        def advance(s):
            return s.replace(current=jnp.where(found, nxt, s.current))

        return jax.lax.cond(non_passed == 1, to_reveal, advance, s)

    # -- step --------------------------------------------------------------
    def step(self, state: SkullState, action: jax.Array) -> SkullState:
        # Invalid-action contract (same as liars_dice.apply_invalid): an
        # unmasked action terminates the episode with zero rewards. The
        # reference panics here (skull.rs step asserts legality); inside
        # jit the phase arithmetic below would otherwise silently remap
        # e.g. PASS-in-placing to a bid of 24 and diverge the game state
        # with no signal. Masked sampling never produces one, so this is
        # purely a guard for external callers. Validity comes from the
        # RAW action (one_hot of an out-of-range index is all-zero, so
        # anything outside [0, A) is invalid); clipping first would remap
        # garbage onto a different — possibly legal — action.
        action_valid = jnp.sum(
            self.action_mask(state).astype(jnp.float32)
            * jax.nn.one_hot(action, A, dtype=jnp.float32)
        ) > 0
        action = jnp.clip(action, 0, A - 1)
        n = self.n
        s = state.replace(
            rewards=jnp.zeros((n,), jnp.float32), done=jnp.zeros((), jnp.bool_)
        )
        cur = s.current
        total_cards = jnp.sum(s.stack_len)
        bid_value = jnp.clip(action - BID_BASE + 1, 1, MAX_BID)

        # ---------------- placing -----------------------------------------
        def do_placing(s: SkullState) -> SkullState:
            is_place = action < BID_BASE
            card = jnp.where(action == PLACE_SKULL, SKULL_C, ROSE_C)

            def place(s):
                oh_cur = _oh(cur, MAXP)
                len_cur = _read(s.stack_len, cur, MAXP)
                cell = jnp.arange(MAXP * CARDS) == cur * CARDS + len_cur
                is_skull_card = card == SKULL_C
                s = s.replace(
                    stack=jnp.where(cell, card, s.stack),
                    stack_len=s.stack_len + oh_cur.astype(jnp.int32),
                    skulls_in=s.skulls_in
                    + (oh_cur & is_skull_card).astype(jnp.int32),
                    roses_in=s.roses_in
                    + (oh_cur & ~is_skull_card).astype(jnp.int32),
                )
                return s.replace(current=self._next_alive(s, cur))

            def start_bidding(s):
                s = s.replace(
                    phase=jnp.ones((), jnp.int32),
                    current_bid=bid_value,
                    current_bidder=cur,
                )
                s = self._push_hist(s, cur, bid_value)
                found, nxt = self._next_non_passed(s, cur)

                def shortcut(s):
                    return self._to_revealing(s)

                def next_or_end(s):
                    return jax.lax.cond(
                        found,
                        lambda s: s.replace(current=nxt),
                        self._check_bidding_end,
                        s,
                    )

                return jax.lax.cond(
                    bid_value == total_cards, shortcut, next_or_end, s
                )

            return jax.lax.cond(is_place, place, start_bidding, s)

        # ---------------- bidding -----------------------------------------
        def do_bidding(s: SkullState) -> SkullState:
            def raise_bid(s):
                s = s.replace(current_bid=bid_value, current_bidder=cur)
                s = self._push_hist(s, cur, bid_value)
                found, nxt = self._next_non_passed(s, cur)
                return jax.lax.cond(
                    bid_value == total_cards,
                    self._to_revealing,
                    lambda s: jax.lax.cond(
                        found,
                        lambda s: s.replace(current=nxt),
                        self._check_bidding_end,
                        s,
                    ),
                    s,
                )

            def do_pass(s):
                s = s.replace(passed=s.passed | _oh(cur, MAXP))
                s = self._push_hist(s, cur, jnp.zeros((), jnp.int32))
                return self._check_bidding_end(s)

            return jax.lax.cond(action == PASS, do_pass, raise_bid, s)

        # ---------------- revealing ----------------------------------------
        def do_revealing(s: SkullState) -> SkullState:
            bidder = s.current_bidder
            target = jnp.clip(action - REVEAL_BASE, 0, MAXP - 1)

            oh_t = _oh(target, MAXP)
            oh_b = _oh(bidder, MAXP)
            card_idx = _read(s.stack_len, target, MAXP) - 1 - _read(
                s.revealed, target, MAXP
            )
            flat_idx = target * CARDS + jnp.clip(card_idx, 0, CARDS - 1)
            card = jnp.sum(
                jnp.where(jnp.arange(MAXP * CARDS) == flat_idx, s.stack, 0)
            )
            is_skull = card == SKULL_C
            s = s.replace(
                revealed=s.revealed + oh_t.astype(jnp.int32),
                roses_found=s.roses_found + (~is_skull).astype(jnp.int32),
            )
            own_done = (target == bidder) & (
                _read(s.stack_len, bidder, MAXP)
                - _read(s.revealed, bidder, MAXP)
                <= 0
            )
            s = s.replace(must_reveal_own=s.must_reveal_own & ~own_done)
            rsc = s.shaping_coef

            def on_skull(s: SkullState) -> SkullState:
                # Bidder loses a random coaster (skull.rs:290-307).
                key, k_choice = jax.random.split(s.key)
                coasters = _read(self._coasters(s), bidder, MAXP)
                trap_b = _read(s.has_trap, bidder, MAXP)
                roses_b = _read(s.rose_count, bidder, MAXP)
                choice = jax.random.randint(
                    k_choice, (), 0, jnp.maximum(coasters, 1)
                )
                lose_skull = trap_b & (choice == 0)
                # Interactive override: forced skull/rose discard if legal.
                lose_skull = jnp.where(
                    s.forced_discard == 0,
                    trap_b,
                    jnp.where(
                        s.forced_discard == 1,
                        trap_b & (roses_b == 0),
                        lose_skull,
                    ),
                )
                has_trap = _write(
                    s.has_trap, bidder, s.has_trap & ~lose_skull, MAXP
                )
                rose_count = s.rose_count + jnp.where(
                    _oh(bidder, MAXP),
                    jnp.where(lose_skull | (coasters == 0), 0, -1),
                    0,
                )
                s = s.replace(has_trap=has_trap, rose_count=rose_count, key=key)
                newly_elim = (
                    _read(self._coasters(s), bidder, MAXP) == 0
                ) & (_read(s.elim_pos, bidder, MAXP) < 0)
                s = s.replace(
                    elim_pos=jnp.where(
                        newly_elim & _oh(bidder, MAXP),
                        s.num_eliminated,
                        s.elim_pos,
                    ),
                    num_eliminated=s.num_eliminated + newly_elim.astype(jnp.int32),
                )

                alive = self._alive(s)
                alive_cnt = jnp.sum(alive.astype(jnp.int32))

                def end_game(s):
                    winner = jnp.argmax(alive).astype(jnp.int32)
                    s = s.replace(
                        game_over=jnp.ones((), jnp.bool_),
                        winner=jnp.where(alive_cnt >= 1, winner, -1),
                        done=jnp.ones((), jnp.bool_),
                    )
                    return s.replace(rewards=self._final_rewards(s))

                def next_round(s):
                    shaped = jnp.where(
                        jnp.arange(n) == bidder,
                        jnp.where(rsc > 0, -rsc / CARDS, 0.0),
                        0.0,
                    )
                    starter = jnp.where(
                        _read(alive, bidder, MAXP),
                        bidder,
                        jnp.where(
                            _read(alive, target, MAXP),
                            target,
                            self._next_alive(s, target),
                        ),
                    ).astype(jnp.int32)
                    return self._start_new_round(
                        s.replace(rewards=shaped), starter
                    )

                return jax.lax.cond(alive_cnt <= 1, end_game, next_round, s)

            def on_rose(s: SkullState) -> SkullState:
                success = s.roses_found >= s.current_bid

                def on_success(s):
                    s = s.replace(
                        wins=s.wins + _oh(bidder, MAXP).astype(jnp.int32)
                    )
                    alive_cnt = jnp.sum(self._alive(s).astype(jnp.int32))
                    game_won = (
                        _read(s.wins, bidder, MAXP) >= WINS_TO_WIN
                    ) | (alive_cnt == 1)

                    def end_game(s):
                        s = s.replace(
                            game_over=jnp.ones((), jnp.bool_),
                            winner=bidder,
                            done=jnp.ones((), jnp.bool_),
                        )
                        return s.replace(rewards=self._final_rewards(s))

                    def next_round(s):
                        shaped = jnp.where(
                            jnp.arange(n) == bidder,
                            jnp.where(rsc > 0, rsc, 0.0),
                            0.0,
                        )
                        return self._start_new_round(
                            s.replace(rewards=shaped), bidder
                        )

                    return jax.lax.cond(game_won, end_game, next_round, s)

                return jax.lax.cond(success, on_success, lambda s: s, s)

            return jax.lax.cond(is_skull, on_skull, on_rose, s)

        new_s = jax.lax.switch(s.phase, [do_placing, do_bidding, do_revealing], s)
        # Game already over (no-op terminal; autoreset owns the restart)
        # or unmasked action (terminate with zero rewards, as in
        # liars_dice): discard the phase computation above.
        new_s = jax.lax.cond(
            state.game_over | ~action_valid,
            lambda _: state.replace(
                rewards=jnp.zeros((n,), jnp.float32),
                done=jnp.ones((), jnp.bool_),
                game_over=jnp.ones((), jnp.bool_),
            ),
            lambda x: x,
            new_s,
        )
        return new_s.replace(step_idx=state.step_idx + 1)

    # -- observation (skull.rs:534-672) -----------------------------------
    def obs(self, state: SkullState) -> jax.Array:
        n = self.n
        s = state
        cur = s.current
        rel = jnp.arange(MAXP)
        absmap = (rel + cur) % n
        valid_rel = (rel < n).astype(jnp.float32)

        skulls_in = self._skulls_in_stack(s)
        roses_in = self._roses_in_stack(s)
        has_trap_hand = _read(s.has_trap, cur, MAXP) & (
            _read(skulls_in, cur, MAXP) == 0
        )
        roses_hand = jnp.clip(
            _read(s.rose_count, cur, MAXP) - _read(roses_in, cur, MAXP),
            0,
            ROSES,
        )

        own_hand = jnp.concatenate(
            [
                has_trap_hand.astype(jnp.float32)[None],
                (jnp.arange(ROSES) < roses_hand).astype(jnp.float32),
            ]
        )
        # Own stack from the flat [24] layout: mask to the current
        # player's 4 slots, fold onto positions with a constant [24, 4]
        # position-selector contraction (no (6,4)-shaped intermediate).
        mine = jnp.arange(MAXP * CARDS) // CARDS == cur
        masked = jnp.where(mine, s.stack, 0).astype(jnp.float32)  # [24]
        pos_sel = (
            jnp.arange(MAXP * CARDS)[:, None] % CARDS
            == jnp.arange(CARDS)[None, :]
        ).astype(jnp.float32)  # [24, 4] constant
        stack_cur = masked @ pos_sel  # [CARDS]
        own_stack = (
            (stack_cur == float(SKULL_C))
            & (jnp.arange(CARDS) < _read(s.stack_len, cur, MAXP))
        ).astype(jnp.float32)

        # Player-relative permutation as a one-hot matrix contraction
        # (a 6x6 elementwise op per array instead of a 6-index gather).
        M = absmap[:, None] == jnp.arange(MAXP)[None, :]

        def rel_gather(arr_f32):
            return (
                jnp.sum(jnp.where(M, arr_f32[None, :], 0.0), axis=1)
                * valid_rel
            )

        coasters = self._coasters(s).astype(jnp.float32)
        alive = self._alive(s).astype(jnp.float32)
        stack_sizes = rel_gather(s.stack_len.astype(jnp.float32) / CARDS)
        coasters_r = rel_gather(coasters / CARDS)
        alive_r = rel_gather(alive)
        exists_r = valid_rel
        seat = jax.nn.one_hot(cur, MAXP)
        phase = jax.nn.one_hot(s.phase, 3)
        bid = (s.current_bid.astype(jnp.float32) / MAX_BID)[None]
        rel_bidder = (s.current_bidder + n - cur) % n
        bidder_oh = jnp.where(
            s.current_bidder >= 0, jax.nn.one_hot(rel_bidder, MAXP), jnp.zeros(MAXP)
        )
        passed_r = rel_gather(s.passed.astype(jnp.float32))
        wins_r = rel_gather(s.wins.astype(jnp.float32) / WINS_TO_WIN)
        revealed_r = rel_gather(s.revealed.astype(jnp.float32) / CARDS)
        nplayers = jax.nn.one_hot(n - 2, MAXP - 1)

        idx = jnp.arange(HIST)
        hvalid = (idx < s.hist_len).astype(jnp.float32)[:, None]
        h_rel = (s.hist[:, 0] + n - cur) % n
        h_bid = s.hist[:, 1]
        hist_obs = jnp.concatenate(
            [
                jax.nn.one_hot(h_rel, MAXP) * hvalid,
                (h_bid.astype(jnp.float32) / MAX_BID * hvalid[:, 0])[:, None],
                ((h_bid == 0).astype(jnp.float32) * hvalid[:, 0])[:, None],
            ],
            axis=1,
        ).reshape(-1)

        return jnp.concatenate(
            [
                own_hand, own_stack, stack_sizes, coasters_r, alive_r, exists_r,
                seat, phase, bid, bidder_oh, passed_r, wins_r, revealed_r,
                nplayers, hist_obs,
            ]
        ).astype(jnp.float32)

    # -- mask (skull.rs:1256-1336) ------------------------------------------
    def action_mask(self, state: SkullState) -> jax.Array:
        n = self.n
        s = state
        cur = s.current
        skulls_in = self._skulls_in_stack(s)
        roses_in = self._roses_in_stack(s)
        total_cards = jnp.sum(s.stack_len)
        bids = jnp.arange(1, MAX_BID + 1)

        placing = s.phase == 0
        bidding = s.phase == 1
        revealing = s.phase == 2

        has_trap_hand = _read(s.has_trap, cur, MAXP) & (
            _read(skulls_in, cur, MAXP) == 0
        )
        roses_hand = _read(s.rose_count, cur, MAXP) - _read(roses_in, cur, MAXP)
        m_skull = placing & has_trap_hand
        m_rose = placing & (roses_hand > 0)

        can_open_bid = placing & (_read(s.stack_len, cur, MAXP) > 0)
        min_bid = jnp.maximum(s.current_bid + 1, 1)
        m_bids = (
            (can_open_bid | bidding) & (bids >= min_bid) & (bids <= total_cards)
        )

        alive_np = self._alive(s) & ~s.passed
        m_pass = (
            bidding
            & ~_read(s.passed, cur, MAXP)
            & (jnp.sum(alive_np.astype(jnp.int32)) > 1)
        )

        unrevealed = s.stack_len - s.revealed
        bidder = s.current_bidder
        is_bidder = revealing & (cur == bidder)
        own_unrevealed = jnp.where(
            bidder >= 0, _read(unrevealed, bidder, MAXP), 0
        )
        must_own = s.must_reveal_own & (own_unrevealed > 0)
        seat_idx = jnp.arange(MAXP)
        m_reveal = is_bidder & (
            jnp.where(
                must_own,
                seat_idx == bidder,
                (unrevealed > 0) & (seat_idx < n),
            )
        )
        m_reveal = m_reveal & (unrevealed > 0)  # seat_idx == arange: no gather

        mask = jnp.concatenate(
            [
                m_skull[None],
                m_rose[None],
                m_bids,
                m_pass[None],
                m_reveal,
            ]
        )
        return mask & ~s.game_over

    def current_player(self, state: SkullState) -> jax.Array:
        return state.current

    def game_outcome(self, state: SkullState) -> jax.Array:
        return self._placements(state)

    def active_player_count(self, state: SkullState) -> jax.Array:
        return jnp.asarray(self.n, jnp.int32)

    # -- privileged obs (skull.rs:1480-1580) ---------------------------------
    def privileged_obs(self, state: SkullState) -> jax.Array:
        s = state
        n = self.n
        parts = [
            jax.nn.one_hot(s.phase, 3),
            (s.current.astype(jnp.float32) / MAXP)[None],
            (s.round_starter.astype(jnp.float32) / MAXP)[None],
            jnp.where(s.current_bid > 0, s.current_bid.astype(jnp.float32) / MAX_BID, 0.0)[None],
            jnp.where(
                (s.current_bid > 0) & (s.current_bidder >= 0),
                s.current_bidder.astype(jnp.float32) / MAXP,
                -1.0,
            )[None],
        ]
        # Bid history: most recent first, 10 entries x 3.
        H = 10
        idx = jnp.arange(H)
        src = s.hist_len - 1 - idx
        hvalid = (src >= 0).astype(jnp.float32)
        # Row selection as a [H, HIST] one-hot contraction (no gather).
        Msrc = jnp.clip(src, 0, HIST - 1)[:, None] == jnp.arange(HIST)[None, :]
        entries = jnp.sum(
            jnp.where(Msrc[:, :, None], s.hist[None, :, :], 0), axis=1
        )  # [H, 2]
        parts.append(
            jnp.stack(
                [
                    entries[:, 0].astype(jnp.float32) / MAXP * hvalid,
                    entries[:, 1].astype(jnp.float32) / MAX_BID * hvalid,
                    (entries[:, 1] == 0).astype(jnp.float32) * hvalid,
                ],
                axis=1,
            ).reshape(-1)
        )
        parts.append(s.game_over.astype(jnp.float32)[None])
        parts.append(jax.nn.one_hot(n - 2, MAXP - 1))

        exists = self._exists().astype(jnp.float32)
        alive = self._alive(s).astype(jnp.float32)
        per_player = jnp.stack(
            [
                exists,
                s.wins.astype(jnp.float32) / WINS_TO_WIN,
                alive,
                s.has_trap.astype(jnp.float32),
                s.rose_count.astype(jnp.float32) / ROSES,
                s.stack_len.astype(jnp.float32) / CARDS,
                self._skulls_in_stack(s).astype(jnp.float32) / CARDS,
                self._roses_in_stack(s).astype(jnp.float32) / CARDS,
                s.passed.astype(jnp.float32),
                s.revealed.astype(jnp.float32) / CARDS,
            ],
            axis=1,
        ).reshape(-1)
        parts.append(per_player)
        flat = jnp.concatenate(parts)
        return jnp.pad(flat, (0, PRIV_DIM - flat.shape[0]))

    # -- human-facing -----------------------------------------------------
    def render(self, state) -> str:
        import numpy as np

        s = state
        phase = ["Placing", "Bidding", "Revealing"][int(s.phase)]
        lines = [f"=== Skull ({self.n} players) ===",
                 f"Phase: {phase} | Current Player: P{int(s.current)}"]
        if int(s.current_bidder) >= 0:
            lines.append(f"Current Bid: {int(s.current_bid)} by P{int(s.current_bidder)}")
        lines.append("")
        coasters = np.asarray(self._coasters(s))
        alive = np.asarray(self._alive(s))
        for p in range(self.n):
            curm = ">" if p == int(s.current) else " "
            am = " " if alive[p] else "X"
            passed = " (passed)" if bool(s.passed[p]) else ""
            lines.append(
                f"{curm}{am} P{p}: {int(s.wins[p])}W {coasters[p]}C | "
                f"Stack: {int(s.revealed[p])}/{int(s.stack_len[p])} revealed{passed}"
            )
            if p == int(s.current) and int(s.stack_len[p]) > 0:
                grid = np.asarray(s.stack).reshape(MAXP, CARDS)
                cards = "".join(
                    "S" if int(c) == SKULL_C else "R"
                    for c in grid[p][: int(s.stack_len[p])]
                )
                lines.append(f"   Stack contents: [{cards}]")
        if bool(s.game_over) and int(s.winner) >= 0:
            lines.append(f"\nGame Over! Winner: P{int(s.winner)}")
        return "\n".join(lines)

    def describe_action(self, action: int) -> str:
        if action == PLACE_SKULL:
            return "Place Skull"
        if action == PLACE_ROSE:
            return "Place Rose"
        if BID_BASE <= action < PASS:
            return f"Bid {action - BID_BASE + 1}"
        if action == PASS:
            return "Pass"
        if REVEAL_BASE <= action < A:
            return f"Reveal P{action - REVEAL_BASE}"
        return f"Unknown action {action}"

    def parse_action(self, text: str) -> int:
        t = text.strip().lower()
        if t in ("skull", "s", "place skull"):
            return PLACE_SKULL
        if t in ("rose", "r", "place rose"):
            return PLACE_ROSE
        if t in ("pass", "p"):
            return PASS
        if t.startswith("bid "):
            t = t[4:].strip()
        if t.isdigit() and 1 <= int(t) <= MAX_BID:
            return BID_BASE + int(t) - 1
        if t.startswith("reveal "):
            rest = t[7:].strip()
            if rest.startswith("p") and rest[1:].isdigit():
                p = int(rest[1:])
                if p < MAXP:
                    return REVEAL_BASE + p
        raise ValueError(f"Unknown action: {text}")


register("skull", Skull)
