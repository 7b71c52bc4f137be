"""Command-line interface: train / eval / tournament / interactive.

Parity with the reference CLI (src/config.rs:43-634): the same
subcommands, override flags (schedules in ``v@step,v@30M`` form,
``--x/--no-x`` boolean pairs via argparse's BooleanOptionalAction), and
the Fresh / Resume / Fork mode triangle (main.rs:151-161):

  * fresh:   --config path.toml [overrides]       -> new run dir
  * resume:  --resume runs/name                   -> same run, config
             locked except total_steps / max_training_time
  * fork:    --fork runs/name/checkpoints/step_X  -> NEW run, any
             overrides, lineage recorded in forked_from

The reference's ``--backend`` flag picks a Burn backend
(src/backend.rs:84-125); here the analog is ``--platform`` (gpu/cpu) and
``--mesh-data`` (data-parallel axis size) since the compute stack is
always XLA.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Any, Dict, Optional

from burn_ppo_tpu.config import Config, PlayerCountMode, generate_run_name
from burn_ppo_tpu.schedule import Schedule


def _add_train_parser(sub):
    p = sub.add_parser("train", help="Train a model (default subcommand)")
    p.add_argument("-c", "--config", default="configs/cartpole.toml",
                   help="Path to TOML config file")
    p.add_argument("--resume", metavar="RUN_DIR",
                   help="Resume an existing run (same config)")
    p.add_argument("--fork", metavar="CHECKPOINT",
                   help="Fork from a checkpoint (new run, config changes allowed)")
    p.add_argument("--run-name", help="Run name (under the runs base dir)")
    p.add_argument("--run-dir", help="Explicit run directory")
    p.add_argument("--runs-base", default="runs", help="Base directory for runs")
    p.add_argument("--quiet", action="store_true", help="Suppress progress output")
    p.add_argument("--platform", choices=["gpu", "cpu"], default=None,
                   help="Force a JAX platform; 'gpu' fails when no GPU is "
                        "present (default: JAX's own choice)")
    p.add_argument("--reload-every-n-checkpoints", type=int, default=0,
                   help="Supervisor mode: respawn training as a subprocess "
                        "every N checkpoints (0 = off; reference default 10)")
    p.add_argument("--max-checkpoints-this-run", type=int, default=0,
                   help=argparse.SUPPRESS)  # internal (supervisor child)
    p.add_argument("--multihost", action="store_true",
                   help="Initialize jax.distributed from the "
                        "BURN_PPO_COORDINATOR/NUM_PROCESSES/PROCESS_ID env "
                        "vars, else JAX's SLURM / Open MPI auto-detection")
    p.add_argument("--profile-dir", default=None,
                   help="Capture a jax.profiler trace into this directory")
    p.add_argument("--profile-start", type=int, default=1,
                   help="Update index at which the trace starts")
    p.add_argument("--profile-updates", type=int, default=2,
                   help="Number of updates to trace")
    p.add_argument("--checkify", action="store_true",
                   help="Debug mode: functionalized NaN/div checks through "
                        "the train step (reference runtime asserts, "
                        "ppo.rs:363-366); ~2x slower")
    p.add_argument("--profile-phases", action="store_true",
                   help="Unfused diagnostic mode: time rollout/GAE/update "
                        "separately (logs perf/rollout_time etc.)")
    p.add_argument("--compilation-cache", default="auto", metavar="DIR|auto|off",
                   help="Persistent XLA compilation cache directory "
                        "('auto' = <checkout>/.cache/xla on GPU, off on "
                        "CPU; 'off' disables). $JAX_COMPILATION_CACHE_DIR, "
                        "when set, takes precedence. Supervisor children "
                        "and resumed runs hit the cache instead of "
                        "recompiling")
    p.add_argument("--elapsed-time-offset-ms", type=int, default=0,
                   help=argparse.SUPPRESS)  # internal (supervisor child)

    # --- config overrides (names match TOML keys) ---
    p.add_argument("--env")
    p.add_argument("--num-envs")
    p.add_argument("--num-steps", type=int)
    p.add_argument("--learning-rate", help="e.g. '0.0003' or '0.001@0,0.0001@30M'")
    p.add_argument("--entropy-coef")
    p.add_argument("--adaptive-entropy")
    p.add_argument("--reward-shaping-coef")
    p.add_argument("--gamma", type=float)
    p.add_argument("--gae-lambda", type=float)
    p.add_argument("--clip-epsilon", type=float)
    p.add_argument("--value-coef", type=float)
    p.add_argument("--max-grad-norm", type=float)
    p.add_argument("--target-kl", type=float)
    p.add_argument("--total-steps", type=int)
    p.add_argument("--max-training-time")
    p.add_argument("--num-epochs", type=int)
    p.add_argument("--num-minibatches", type=int)
    p.add_argument("--adam-epsilon", type=float)
    p.add_argument("--seed", type=int)
    p.add_argument("--hidden-size", type=int)
    p.add_argument("--num-hidden", type=int)
    p.add_argument("--activation", choices=["relu", "tanh"])
    p.add_argument("--network-type", choices=["mlp", "cnn", "ctde"])
    p.add_argument("--critic-hidden-size", type=int)
    p.add_argument("--critic-num-hidden", type=int)
    p.add_argument("--num-conv-layers", type=int)
    p.add_argument("--kernel-size", type=int)
    p.add_argument("--cnn-fc-hidden-size", type=int)
    p.add_argument("--cnn-num-fc-layers", type=int)
    p.add_argument("--adaptive-entropy-min-coef", type=float)
    p.add_argument("--adaptive-entropy-max-coef", type=float)
    p.add_argument("--adaptive-entropy-delta", type=float)
    p.add_argument("--checkpoint-freq", type=int)
    p.add_argument("--log-freq", type=int)
    p.add_argument("--opponent-pool-fraction", type=float)
    p.add_argument("--opponent-select-alpha", type=float)
    p.add_argument("--opponent-select-exponent", type=float)
    p.add_argument("--pool-rotation-interval", type=int,
                   help="PPO updates per opponent rotation (1 = reference "
                        "per-update cadence; >1 fuses that many vs-pool "
                        "updates into one device window)")
    p.add_argument("--max-active-opponents", type=int)
    p.add_argument("--players", type=int, help="Fixed player count (variable-count games)")
    p.add_argument("--compute-dtype", choices=["bfloat16"])
    p.add_argument("--mesh-data", type=int, help="Data-parallel mesh size (0 = all devices)")
    p.add_argument("--shuffle-block-rows", type=int,
                   help="Epoch-shuffle tile size (0 or 1 = exact "
                        "per-sample shuffle, >1 = tiles of that many rows)")
    # --x / --no-x tri-state booleans (config.rs:142-257)
    for flag in ("normalize-obs", "normalize-returns", "normalize-values",
                 "clip-value", "split-networks", "debug-opponents"):
        p.add_argument(f"--{flag}", action=argparse.BooleanOptionalAction, default=None)
    return p


def _add_eval_parser(sub):
    p = sub.add_parser("eval", help="Evaluate trained models")
    p.add_argument("-c", "--checkpoint", action="append", default=[],
                   dest="checkpoints", help="Checkpoint path (repeatable, one per player)")
    p.add_argument("--human", action="append", default=[], dest="humans",
                   help="Human player name (repeatable)")
    p.add_argument("--random", action="store_true", help="Add a random baseline player")
    p.add_argument("-e", "--env", dest="env_name", help="Environment (if no checkpoint)")
    p.add_argument("-n", "--num-games", type=int, default=100)
    p.add_argument("--num-envs", type=int, default=64)
    p.add_argument("--watch", action="store_true", help="Render games step by step")
    p.add_argument("--step", action="store_true", help="Press Enter to advance")
    p.add_argument("--animate", action="store_true")
    p.add_argument("--fps", type=int, default=10)
    p.add_argument("--seed", type=int)
    p.add_argument("--temp", type=float, help="Initial softmax temperature")
    p.add_argument("--temp-final", type=float)
    p.add_argument("--temp-cutoff", type=int)
    p.add_argument("--no-temp-cutoff", action="store_true")
    p.add_argument("--temp-decay", action="store_true")
    p.add_argument("--players", type=int)
    p.add_argument("--parity-ratings", action="store_true",
                   help="Print the reference's exact stats-mode rating "
                        "table (per seat-slot over all games, anchor "
                        "slot 0, +/- 1 sigma; eval.rs:591-644) instead "
                        "of the merged-by-source table")
    return p


def _add_tournament_parser(sub):
    p = sub.add_parser("tournament", help="Swiss/round-robin tournament with ratings")
    p.add_argument("sources", nargs="+", help="Checkpoint paths or run directories")
    p.add_argument("-n", "--num-games", type=int, default=100,
                   help="Games per matchup")
    p.add_argument("--num-envs", type=int, default=64)
    p.add_argument("--rounds", type=int, help="Swiss rounds (default auto)")
    p.add_argument("--limit-per-run", type=int)
    p.add_argument("--random", action="store_true")
    p.add_argument("--temp", type=float)
    p.add_argument("--temp-final", type=float)
    p.add_argument("--temp-cutoff", type=int)
    p.add_argument("--no-temp-cutoff", action="store_true")
    p.add_argument("--seed", type=int)
    p.add_argument("-o", "--output", help="Save results JSON")
    p.add_argument("--graph", action="store_true", help="Rating-over-steps graph")
    p.add_argument("--round-robin", action="store_true")
    p.add_argument("--players", type=int)
    return p


def _add_interactive_parser(sub):
    p = sub.add_parser("interactive", help="Web UI game assistant")
    p.add_argument("sources", nargs="+", help="Checkpoint paths or run directories")
    p.add_argument("--limit-per-run", type=int, default=1)
    p.add_argument("-p", "--port", type=int, default=3000)
    p.add_argument("--host", default="127.0.0.1",
                   help="Bind address (loopback by default; the API has "
                        "no auth, so widen deliberately)")
    return p


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="burn-ppo-tpu",
        description="PPO self-play framework on JAX",
    )
    parser.add_argument("--version", action="version", version="burn-ppo-tpu 0.1.0")
    sub = parser.add_subparsers(dest="command")
    _add_train_parser(sub)
    _add_eval_parser(sub)
    _add_tournament_parser(sub)
    _add_interactive_parser(sub)
    return parser


TRAIN_OVERRIDE_KEYS = [
    "env", "num_envs", "num_steps", "learning_rate", "entropy_coef",
    "adaptive_entropy", "reward_shaping_coef", "gamma", "gae_lambda",
    "clip_epsilon", "value_coef", "max_grad_norm", "target_kl",
    "total_steps", "max_training_time", "num_epochs", "num_minibatches",
    "adam_epsilon", "seed", "hidden_size", "num_hidden", "activation",
    "network_type", "critic_hidden_size", "critic_num_hidden",
    "num_conv_layers", "kernel_size", "cnn_fc_hidden_size",
    "cnn_num_fc_layers", "adaptive_entropy_min_coef",
    "adaptive_entropy_max_coef", "adaptive_entropy_delta",
    "checkpoint_freq", "log_freq", "opponent_pool_fraction",
    "opponent_select_alpha", "opponent_select_exponent",
    "pool_rotation_interval", "max_active_opponents", "compute_dtype",
    "mesh_data", "shuffle_block_rows", "normalize_obs", "normalize_returns",
    "normalize_values", "clip_value", "split_networks", "debug_opponents",
]


def collect_overrides(args) -> Dict[str, Any]:
    overrides: Dict[str, Any] = {}
    for key in TRAIN_OVERRIDE_KEYS:
        v = getattr(args, key, None)
        if v is not None:
            overrides[key] = v
    if getattr(args, "players", None) is not None:
        overrides["player_count"] = args.players
    return overrides


def run_train(args, argv=None) -> int:
    # Supervisor mode (reference main.rs:1700-1784): parent respawns the
    # training subprocess every N checkpoints; children are marked by
    # --max-checkpoints-this-run.
    if (
        args.reload_every_n_checkpoints > 0
        and args.max_checkpoints_this_run == 0
        and not args.fork
    ):
        from burn_ppo_tpu.config import Config as _Cfg
        from burn_ppo_tpu.supervisor import TrainingSupervisor

        runs_base = Path(args.runs_base)
        if args.resume:
            run_dir = Path(args.resume)
            cfg = _Cfg.load(run_dir / "config.toml")
        else:
            cfg = _Cfg.load(args.config).apply_overrides(collect_overrides(args))
            run_name = args.run_name or cfg.run_name or generate_run_name(
                runs_base, cfg.env
            )
            run_dir = Path(args.run_dir) if args.run_dir else runs_base / run_name
        # Strip the supervisor flag (both `--flag value` and `--flag=value`).
        cleaned = []
        skip = False
        for a in argv or []:
            if skip:
                skip = False
                continue
            if a == "--reload-every-n-checkpoints":
                skip = True
                continue
            if a.startswith("--reload-every-n-checkpoints="):
                continue
            cleaned.append(a)
        if "--run-dir" not in cleaned and not args.resume:
            cleaned += ["--run-dir", str(run_dir)]
        total = args.total_steps or cfg.total_steps
        return TrainingSupervisor(
            run_dir,
            cleaned,
            reload_every_n_checkpoints=args.reload_every_n_checkpoints,
            total_steps=total,
            quiet=args.quiet,
        ).run()

    if args.platform:
        import jax

        jax.config.update(
            "jax_platforms", "cuda" if args.platform == "gpu" else "cpu"
        )
    if args.multihost:
        # Must precede anything that initializes the XLA backend —
        # including the compilation-cache "auto" gate's backend probe.
        from burn_ppo_tpu.parallel.distributed import maybe_initialize

        maybe_initialize(force=True)
    if args.platform == "gpu":
        try:
            jax.devices()
        # RuntimeError: the CUDA plugin found no usable card; an
        # AssertionError comes from jax_platforms naming a platform that
        # has no plugin installed at all.
        except (RuntimeError, AssertionError) as e:
            print(f"error: --platform gpu, but JAX found no GPU ({e!r})",
                  file=sys.stderr)
            return 2
    from burn_ppo_tpu.utils import enable_compilation_cache

    enable_compilation_cache(args.compilation_cache)
    from burn_ppo_tpu.train import Trainer

    overrides = collect_overrides(args)
    runs_base = Path(args.runs_base)

    if args.resume:
        run_dir = Path(args.resume)
        cfg_path = run_dir / "config.toml"
        if not cfg_path.exists():
            print(f"error: no config.toml in {run_dir}", file=sys.stderr)
            return 1
        cfg = Config.load(cfg_path).apply_overrides(overrides, resume=True)
        latest = run_dir / "checkpoints" / "latest"
        if not latest.exists():
            print(f"error: no checkpoints/latest in {run_dir}", file=sys.stderr)
            return 1
        trainer = Trainer(
            cfg, run_dir, resume_from=latest.resolve(), quiet=args.quiet,
            max_checkpoints_this_run=args.max_checkpoints_this_run,
            elapsed_time_offset=args.elapsed_time_offset_ms / 1000.0,
            profile_dir=args.profile_dir, profile_start=args.profile_start,
            profile_updates=args.profile_updates, profile_phases=args.profile_phases,
            debug_checkify=args.checkify,
        )
    elif args.fork:
        ckpt = Path(args.fork)
        if not (ckpt / "metadata.json").exists():
            print(f"error: {ckpt} is not a checkpoint directory", file=sys.stderr)
            return 1
        parent_run = ckpt.parent.parent  # runs/<name>/checkpoints/step_X
        parent_cfg = parent_run / "config.toml"
        cfg = Config.load(parent_cfg) if parent_cfg.exists() else Config.load(args.config)
        cfg = cfg.apply_overrides(overrides)
        parent_name = parent_run.name
        run_name = args.run_name or generate_run_name(
            runs_base, cfg.env, parent=parent_name
        )
        cfg.forked_from = parent_name
        cfg.run_name = run_name
        run_dir = Path(args.run_dir) if args.run_dir else runs_base / run_name
        trainer = Trainer(
            cfg, run_dir, resume_from=ckpt.resolve(),
            forked_from_run=parent_name, quiet=args.quiet,
            profile_dir=args.profile_dir, profile_start=args.profile_start,
            profile_updates=args.profile_updates, profile_phases=args.profile_phases,
            debug_checkify=args.checkify,
        )
    else:
        cfg = Config.load(args.config).apply_overrides(overrides)
        run_name = args.run_name or cfg.run_name or generate_run_name(
            runs_base, cfg.env
        )
        cfg.run_name = run_name
        run_dir = Path(args.run_dir) if args.run_dir else runs_base / run_name
        if (run_dir / "checkpoints" / "latest").exists():
            print(
                f"error: run dir {run_dir} already has checkpoints; use --resume or "
                "--fork",
                file=sys.stderr,
            )
            return 1
        trainer = Trainer(
            cfg, run_dir, quiet=args.quiet,
            max_checkpoints_this_run=args.max_checkpoints_this_run,
            elapsed_time_offset=args.elapsed_time_offset_ms / 1000.0,
            profile_dir=args.profile_dir, profile_start=args.profile_start,
            profile_updates=args.profile_updates, profile_phases=args.profile_phases,
            debug_checkify=args.checkify,
        )

    summary = trainer.train()
    if not args.quiet:
        print(
            f"Training complete: step={summary['final_step']:,} "
            f"avg_return={summary['avg_return']:.2f} sps={summary['sps']:,.0f}"
        )
    return 0


def run_eval(args) -> int:
    from burn_ppo_tpu.eval import run_evaluation_cli

    return run_evaluation_cli(args)


def run_tournament(args) -> int:
    from burn_ppo_tpu.tournament import run_tournament_cli

    return run_tournament_cli(args)


def run_interactive(args) -> int:
    from burn_ppo_tpu.interactive import run_interactive_cli

    return run_interactive_cli(args)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = build_parser()
    # Default subcommand = train (reference Cli: Option<Command>)
    known = {"train", "eval", "tournament", "interactive", "-h", "--help", "--version"}
    if not argv or argv[0] not in known:
        argv = ["train"] + argv
    args = parser.parse_args(argv)
    if args.command == "train":
        # Strip ONLY the subcommand token (argv[0] after the default-
        # subcommand insert above) — an option VALUE that happens to be
        # the string "train" (e.g. --run-name train) must survive into
        # the supervisor's child respawn argv.
        return run_train(args, argv=argv[1:])
    if args.command == "eval":
        return run_eval(args)
    if args.command == "tournament":
        return run_tournament(args)
    if args.command == "interactive":
        return run_interactive(args)
    parser.print_help()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
