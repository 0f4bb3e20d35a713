"""Training CLI (port of hulc_tpu/training/train.py; reference: python
hulc/training.py ...).

Examples, on the card (``--device cpu`` runs the same on the CPU)::

  python -m hulc_tpu_torch.training.train --config hulc_debug --fixture --steps 5
  python -m hulc_tpu_torch.training.train --config hulc --data-dir /data/task_D_D \\
      --run-dir runs/hulc_d --epochs 30

On N cards, one process per card::

  torchrun --standalone --nproc-per-node N -m hulc_tpu_torch.training.train --config hulc [--fsdp] ...

Every flag of the JAX CLI, with its default and meaning, and ``--device``
(``cuda`` by default). Under ``torchrun`` every rank joins the process group
(NCCL; gloo with ``--device cpu``) and trains data-parallel on its rows of
each ``--batch-size`` batch (the global per-modality batch), or ZeRO-3
sharded with ``--fsdp``. The departures: ``--tp`` > 1 and ``--sp`` > 1 are
the next slice of ROADMAP A.4 and are refused rather than ignored; a world
size that does not divide ``--batch-size`` is refused where the JAX CLI
clamps its mesh to a divisor (``resolve_mesh_devices``), since torchrun
has started every rank already; ``--fsdp`` without torchrun shards over a
group of one process; torchrun's rendezvous does the work of the JAX CLI's
multi-host coordinator (``HULC_TPU_COORDINATOR``), and its TPU-tunnel
journal compaction has no counterpart. A relaunch of the same command resumes from the run dir's
latest checkpoint, on any number of cards; ``--steps-total`` caps the run's
step count, so a relaunch trains only the remainder.
"""

from __future__ import annotations

import argparse
import pathlib
import tempfile
from typing import NamedTuple, Optional

MULTI_DEVICE_REFUSAL = ("{flag}: tensor and sequence parallelism are not ported to hulc_tpu_torch yet: they are the "
                        "next slice of ROADMAP A.4 (data parallelism and --fsdp are ported)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="hulc_tpu_torch trainer")
    p.add_argument("--config", default="hulc", help="model preset (hulc|mcil|hulc_depth|*_debug)")
    p.add_argument(
        "--set", action="append", default=[], metavar="KEY=VALUE", dest="overrides",
        help="dotted config override (repeatable), e.g. "
        "--set action_decoder.hidden_size=4096 --set loss.kl_beta=0.1 "
        "(reference: hydra CLI overrides)",
    )
    p.add_argument("--data-dir", default=None, help="CALVIN dataset root (training/ + validation/)")
    p.add_argument("--fixture", action="store_true", help="train on a synthetic fixture dataset")
    p.add_argument("--run-dir", default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--steps", type=int, default=None, help="hard cap on optimizer steps")
    p.add_argument("--batch-size", type=int, default=32, help="per-modality batch size")
    p.add_argument("--min-window", type=int, default=None)
    p.add_argument("--max-window", type=int, default=None)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--lr-schedule", default="constant")
    p.add_argument("--kl-schedule", default="constant", choices=["constant", "linear", "sigmoid"])
    p.add_argument("--cache", default="ram", choices=["ram", "none", "shm"])
    p.add_argument("--loader-workers", type=int, default=1,
                   help="parallel batch-assembly threads (reference num_workers)")
    p.add_argument("--gather-threads", type=int, default=1, help="C++ threads per shm window gather (multi-core hosts)")
    p.add_argument(
        "--fuse", action=argparse.BooleanOptionalAction, default=True,
        help="loader-side modality fusion: one [vis; lang] 2B train batch "
        "through one fused pass (--no-fuse keeps two per-modality passes)",
    )
    p.add_argument(
        "--checkpoint-policy", default="all",
        help="checkpoint retention preset (all|val_action|lh_sr|task_sr|kl|"
        "clip_loss|state_recon — reference conf/callbacks/checkpoint/*.yaml)",
    )
    p.add_argument(
        "--echo-factor", type=int, default=1,
        help="optimizer steps per transferred host batch (data echoing; >1 "
        "when the input pipeline can't keep the device fed)",
    )
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute dtype")
    p.add_argument(
        "--optimizer", default="adam", choices=["adam", "adamw", "sgd"],
        help="reference conf/model/optimizer/*.yaml (adamw: wd 1e-6; sgd: momentum 0.9)",
    )
    p.add_argument(
        "--adam-mv-dtype", default="bfloat16", choices=["float32", "bfloat16"],
        help="storage dtype for adam moments (computed fp32 either way; "
        "float32 gives the reference adam's moment storage)",
    )
    p.add_argument("--fsdp", action="store_true",
                   help="ZeRO-3 param+optimizer sharding over the data axis (every torchrun rank, or one process)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor parallelism: not ported (the next slice of ROADMAP A.4); > 1 is refused")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence parallelism: not ported (the next slice of ROADMAP A.4); > 1 is refused")
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--log-every", type=int, default=50, help="log every N loader batches")
    p.add_argument(
        "--val-every-epochs", type=int, default=1,
        help="run validation + per-epoch diagnostic callbacks every N epochs "
        "(the final/step-capped epoch always evaluates)",
    )
    p.add_argument("--checkpoint-every", type=int, default=1,
                   help="checkpoint every N epochs (a --steps-capped run always saves at the end)")
    p.add_argument("--checkpoint-every-steps", type=int, default=None,
                   help="additionally checkpoint every N optimizer steps")
    p.add_argument(
        "--steps-total", type=int, default=None,
        help="cap the CUMULATIVE step counter instead of per-invocation "
        "steps: an elastic retry loop can relaunch the same command and "
        "train only the remainder (supersedes --steps when set)",
    )
    p.add_argument(
        "--rollout", action="store_true",
        help="run the long-horizon rollout callback each val epoch (fake env "
        "unless --env-factory module:function is given)",
    )
    p.add_argument("--env-factory", default=None)
    p.add_argument("--rollout-sequences", type=int, default=128)
    p.add_argument("--rollout-ep-len", type=int, default=360)
    p.add_argument(
        "--rollout-mode", default="batched", choices=["batched", "sequential"],
        help="batched = lockstep E-env policy step (the policy is built once and "
        "reused across epochs); sequential = one env at a time",
    )
    p.add_argument("--rollout-num-envs", type=int, default=32)
    p.add_argument("--rollout-videos", type=int, default=0,
                   help="capture the first N chains as videos per rollout epoch (reference rollout_lh num_videos)")
    p.add_argument("--val-max-batches", type=int, default=None,
                   help="cap validation batches per epoch (default: full val set)")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p


class Run(NamedTuple):
    """What ``main`` trains: the trainer, its loaders, and ``fit``'s keyword
    arguments (the callbacks among them)."""

    trainer: object
    train_loader: object
    val_loader: Optional[object]
    fit_kwargs: dict


def build_run(args: argparse.Namespace) -> Run:
    """The config, data, trainer and callbacks of a parsed command line."""
    from hulc_tpu_torch.config import TACTILE_REFUSAL, apply_overrides, get_config
    from hulc_tpu_torch.data.fixtures import make_fixture_dataset
    from hulc_tpu_torch.data.loader import make_loaders
    from hulc_tpu_torch.parallel import mesh
    from hulc_tpu_torch.training.schedules import KLSchedule
    from hulc_tpu_torch.training.trainer import Trainer, TrainerConfig

    for flag, refused in ((f"--tp {args.tp}", args.tp > 1), (f"--sp {args.sp}", args.sp > 1)):
        if refused:
            raise SystemExit(MULTI_DEVICE_REFUSAL.format(flag=flag))
    device = mesh.initialize_distributed(args.device)  # torchrun's group, or none
    if args.fsdp and not mesh.active():  # one process without torchrun: a group of one
        device = mesh.initialize_single(args.device)
    rank, world = mesh.rank(), mesh.world()
    if args.batch_size % world:
        raise SystemExit(f"--batch-size {args.batch_size} does not split over {world} ranks: the per-modality "
                         f"batch is sharded over every rank (the JAX CLI clamps its mesh to a divisor instead)")

    cfg = get_config(args.config, **({"compute_dtype": "bfloat16"} if args.bf16 else {}))
    if args.overrides:
        cfg = apply_overrides(cfg, args.overrides)
    if cfg.perceptual_encoder.tactile is not None:
        raise SystemExit(f"--config {args.config}: the train CLI refuses a config with a tactile tower: "
                         f"{TACTILE_REFUSAL}")

    debug = args.config.endswith("_debug")
    min_w = args.min_window or (8 if debug else 20)
    max_w = args.max_window or (8 if debug else 32)
    if args.fixture or args.data_dir is None:
        root = None
        if rank == 0:  # one dataset for every rank
            root = pathlib.Path(tempfile.mkdtemp(prefix="hulc_fixture_"))
            make_fixture_dataset(root, num_episodes=2, episode_len=48, small=debug, lang_dim=cfg.lang_dim)
            print(f"[train] using synthetic fixture dataset at {root}")
        root = mesh.broadcast_object(root)
    else:
        root = pathlib.Path(args.data_dir)

    run_dir = args.run_dir or f"runs/{args.config}"
    tcfg = TrainerConfig(
        run_dir=run_dir,
        max_epochs=args.epochs or (10**9 if args.steps else 100),  # --steps caps, not epochs
        lr=args.lr,
        lr_schedule=args.lr_schedule,
        kl_schedule=KLSchedule(kind=args.kl_schedule),
        seed=args.seed,
        val_max_batches=args.val_max_batches,
        val_every_epochs=args.val_every_epochs,
        checkpoint_policy=args.checkpoint_policy,
        echo_factor=args.echo_factor,
        log_every=args.log_every,
        checkpoint_every_epochs=args.checkpoint_every,
        checkpoint_every_steps=args.checkpoint_every_steps,
        optimizer=args.optimizer,
        adam_mv_dtype=args.adam_mv_dtype,
        fsdp=args.fsdp,
    )
    trainer = Trainer(cfg, tcfg, device=device)
    train_loader = make_loaders(
        cfg, root, "training", args.batch_size, min_w, max_w, cache=args.cache,
        seed=args.seed, num_workers=args.loader_workers, gather_threads=args.gather_threads,
        fuse=args.fuse, rank=rank, world=world,
    )
    try:
        val_loader = make_loaders(
            cfg, root, "validation", args.batch_size, min_w, max_w,
            cache=args.cache, seed=args.seed + 100, deterministic=True, rank=rank, world=world,
        )
    except FileNotFoundError:
        val_loader = None

    callbacks = []
    if cfg.use_clip_auxiliary_loss and val_loader is not None:
        from hulc_tpu_torch.evaluation.metrics import ClipGroundtruthCallback

        callbacks.append(ClipGroundtruthCallback(val_loader))
    if args.rollout:
        callbacks.append(_rollout_callback(args, cfg, root))

    fit_kwargs = dict(
        max_epochs=tcfg.max_epochs,
        max_steps=None if args.steps_total is not None else args.steps,
        resume=not args.no_resume,
        callbacks=callbacks,
        max_total_steps=args.steps_total,
    )
    return Run(trainer, train_loader, val_loader, fit_kwargs)


def _rollout_callback(args, cfg, root):
    from hulc_tpu_torch.data.language import load_task_embeddings
    from hulc_tpu_torch.data.statistics import DatasetStatistics
    from hulc_tpu_torch.evaluation.rollout_callback import RolloutLongHorizonCallback

    if args.env_factory:
        from hulc_tpu_torch.evaluation.evaluate import _load_env_factory

        raw_factory = _load_env_factory(args.env_factory)
        env, oracle = raw_factory()

        def env_factory():
            return raw_factory()[0]
    else:
        from hulc_tpu_torch.evaluation.fake_env import fake_env_for
        from hulc_tpu_torch.evaluation.tasks import SceneObsTasks

        env, oracle = fake_env_for(cfg), SceneObsTasks()

        def env_factory():
            return fake_env_for(cfg)
    emb_path = root / "validation" / "lang_paraphrase-MiniLM-L3-v2" / "embeddings.npy"
    return RolloutLongHorizonCallback(
        env, oracle,
        num_sequences=args.rollout_sequences,
        ep_len=args.rollout_ep_len,
        skip_epochs=0,
        lang_embeddings=load_task_embeddings(emb_path) if emb_path.exists() else None,
        statistics=DatasetStatistics.load(root / "validation"),
        mode=args.rollout_mode,
        env_factory=env_factory,
        num_envs=args.rollout_num_envs,
        num_videos=args.rollout_videos,
    )


def main(argv=None):
    """Parse, build and train; returns the trainer (its ``step`` is the
    run's step count)."""
    from hulc_tpu_torch.parallel import mesh

    started = mesh.active()
    try:
        run = build_run(build_parser().parse_args(argv))
        run.trainer.fit(run.train_loader, run.val_loader, **run.fit_kwargs)
        if mesh.rank() == 0:
            print(f"[train] done at step {run.trainer.step}; checkpoints in {run.trainer.tcfg.run_dir}/saved_models")
    finally:
        if not started:  # the group this call started
            mesh.destroy()
    return run.trainer


if __name__ == "__main__":
    main()
