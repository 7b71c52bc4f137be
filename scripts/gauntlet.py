"""Frozen cross-round strength gauge.

During-training Elo anchors at each run's own first checkpoint, so it
cannot compare ROUNDS: a faster framework compresses its own score.
This registry fixes that with an absolute gauge: after each round's
fixed-budget protocol run (scripts/elo_protocol.py), its final
checkpoint is copied into `gauntlet/<env>/<tag>/` (a plain checkpoint
dir, committed to git), and `rate` runs the repo's own Swiss tournament
over ALL registered rounds plus the Random baseline, Plackett-Luce
rated with Random anchored at 1000 — the during-training-vs-tournament
rating split of the reference (rating_history.rs vs tournament.rs:1035).

Usage:
    python scripts/gauntlet.py register runs/skull_hw_r4 --tag r4
    python scripts/gauntlet.py rate skull --players 4 --games 48
    python scripts/gauntlet.py rate --all --games 48   # every env

Entries are eval-only: model.npz + metadata.json + aux normalizers
(optimizer state is dropped — ~3 MB per entry stays committable).
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
GAUNTLET = REPO / "gauntlet"
sys.path.insert(0, str(REPO))


def register(run_dir: Path, tag: str, which: str = "latest") -> Path:
    from burn_ppo_tpu.checkpoint import CheckpointManager

    mgr = CheckpointManager(run_dir)
    if which == "mid":
        # Mid-run snapshot: a 4-player gauntlet pod needs >= 4
        # contestants, so each round registers final/best/mid.
        steps = mgr.list_steps()
        assert steps, f"no checkpoints under {run_dir}"
        src = mgr.step_dir(steps[len(steps) // 2])
    elif which.startswith("step_"):
        src = Path(run_dir) / "checkpoints" / which
    else:
        src = mgr.resolve(which)
    assert src is not None and Path(src).exists(), (
        f"no '{which}' checkpoint under {run_dir}"
    )
    meta = CheckpointManager.load_metadata(src)
    env = meta["env_name"]
    dst = GAUNTLET / env / tag
    if dst.exists():
        shutil.rmtree(dst)
    dst.mkdir(parents=True)
    for f in Path(src).iterdir():
        if f.name == "optimizer.npz" or not f.is_file():
            continue
        shutil.copy2(f, dst / f.name)
    info = {
        "source_run": str(run_dir),
        "checkpoint": Path(src).name,
        "which": which,
        "step": meta.get("step"),
        "env": env,
    }
    (dst / "gauntlet_entry.json").write_text(json.dumps(info, indent=2))
    print(f"registered {env}/{tag}: {src} (step {meta.get('step'):,})")
    return dst


def rate(env: str, players: int | None, games: int, num_envs: int,
         seed: int, tag: str | None) -> dict:
    from burn_ppo_tpu.tournament import run_tournament

    env_dir = GAUNTLET / env
    entries = sorted(
        p for p in env_dir.iterdir()
        if p.is_dir() and (p / "model.npz").exists()
    )
    assert entries, f"no gauntlet entries under {env_dir}"
    print(f"== gauntlet {env}: {[e.name for e in entries]} + Random")
    result = run_tournament(
        entries,
        num_games=games,
        num_envs=num_envs,
        include_random=True,  # Random is the 1000-Elo anchor
        players=players,
        seed=seed,
        quiet=False,
    )
    out_name = f"ratings_{tag}.json" if tag else "ratings.json"
    (env_dir / out_name).write_text(json.dumps(result, indent=2))
    print(f"-> gauntlet/{env}/{out_name}")
    return result


def _markdown(env: str, result: dict) -> None:
    print(f"\n| {env} entry | Elo (Random=1000) | ± | games |")
    print("|---|---|---|---|")
    rows = sorted(
        result["standings"], key=lambda r: r["rating"], reverse=True
    )
    for r in rows:
        print(
            f"| {r['name']} | {r['rating']:.0f} | {r.get('uncertainty', 0):.0f} "
            f"| {r.get('games_played', 0)} |"
        )


def main() -> int:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("register")
    p.add_argument("run_dir", type=Path)
    p.add_argument("--tag", required=True)
    p.add_argument("--which", default="latest",
                   help="latest | best | mid | step_<N>")
    p = sub.add_parser("rate")
    p.add_argument("env", nargs="?")
    p.add_argument("--all", action="store_true")
    p.add_argument("--players", type=int, default=None)
    p.add_argument("--games", type=int, default=48)
    p.add_argument("--num-envs", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tag", default=None)
    args = ap.parse_args()

    if args.cmd == "register":
        register(args.run_dir, args.tag, args.which)
        return 0

    envs = (
        sorted(d.name for d in GAUNTLET.iterdir() if d.is_dir())
        if args.all
        else [args.env]
    )
    default_players = {"skull": 4, "liars_dice": 4, "connect_four": 2}
    for env in envs:
        players = args.players or default_players.get(env)
        result = rate(env, players, args.games, args.num_envs, args.seed,
                      args.tag)
        _markdown(env, result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
