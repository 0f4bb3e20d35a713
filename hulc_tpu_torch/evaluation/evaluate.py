"""Evaluation CLI (port of hulc_tpu/evaluation/evaluate.py; reference:
hulc/evaluation/evaluate_policy.py).

Checkpoint selection over a training run dir (last / best / all / specific
epochs), the LH-MTLC protocol with the port's policy, ``results.json`` in
the JAX CLI's schema. Run on the card::

    python -m hulc_tpu_torch.evaluation.evaluate --run-dir runs/hulc --batched --num-envs 64

and on the CPU with ``--device cpu`` (the one flag JAX's CLI lacks).

By default it drives the in-process FakeCalvinEnv INTERACTIVE playtable
(the kinematic scene where success is achievable: a zero score means the
policy failed, not that the env was inert; ``--inert-env`` takes the
scripted-scene plumbing variant). For another simulator pass
``--env-factory module:function`` returning (env, oracle) with the env
contract of ``evaluation.fake_env`` and a calvin_env-compatible Tasks
oracle. One model and one policy serve every selected checkpoint: only the
weights change between them.
"""

from __future__ import annotations

import argparse
import importlib
import json
import pathlib

import numpy as np


def _load_env_factory(spec):
    mod_name, fn_name = spec.split(":")
    return getattr(importlib.import_module(mod_name), fn_name)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="hulc_tpu_torch LH-MTLC evaluation")
    p.add_argument("--run-dir", required=True, help="training run dir with saved_models/")
    p.add_argument("--config", default="hulc")
    p.add_argument(
        "--set", action="append", default=[], metavar="KEY=VALUE", dest="overrides",
        help="dotted config override (repeatable); must match the trained "
        "checkpoint's architecture, e.g. --set action_decoder.hidden_size=4096",
    )
    p.add_argument(
        "--checkpoint", default="last",
        help="last | best | all | comma-separated epochs ('best' uses the "
        "monitored-checkpoint journal written by the trainer)",
    )
    p.add_argument("--monitor-preset", default=None, help="checkpoint preset for --checkpoint best (default: lh_sr)")
    p.add_argument("--num-sequences", type=int, default=1000)
    p.add_argument("--ep-len", type=int, default=360)
    p.add_argument("--dataset-dir", default=None, help="for statistics + lang embeddings")
    p.add_argument("--lang-folder", default="lang_paraphrase-MiniLM-L3-v2")
    p.add_argument("--env-factory", default=None, help="module:function -> (env, oracle)")
    p.add_argument(
        "--inert-env", action="store_true",
        help="use the non-interactive FakeCalvinEnv (scripted-scene plumbing "
        "tests only: its scene never moves, so NO policy can score on it). "
        "The default is the interactive kinematic playtable, where the "
        "evaluator discriminates a working policy from a broken one",
    )
    p.add_argument(
        "--oracle-calibration", default=None,
        help="oracle_regions.json from calibrate_oracle (data-derived containment boxes)",
    )
    p.add_argument(
        "--tsne-dump", action="store_true",
        help="write evaluation/tsne_data_<epoch>.npz (ids/labels/latent_goals/plans)",
    )
    p.add_argument("--num-videos", type=int, default=0, help="record the first N chains")
    p.add_argument("--video-dir", default=None, help="video output dir (default <run>/evaluation/videos)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--batched", action="store_true",
        help="lockstep-batched evaluation: N env lanes through one batched "
        "policy step (requires an env factory that can create independent instances)",
    )
    p.add_argument("--num-envs", type=int, default=64)
    p.add_argument("--results-name", default="results.json", help="results filename (one per parallel worker)")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p


def select_checkpoints(run_dir, which: str, monitor_preset=None):
    """The checkpoint directories ``--checkpoint which`` names, in epoch
    order: ``last``, ``best`` (by ``monitor_preset``, default lh_sr; with a
    warning and the latest checkpoint when the monitor was never recorded),
    ``all``, or comma-separated epochs."""
    from hulc_tpu_torch.training import checkpoint as ckpt

    run_dir = pathlib.Path(run_dir)
    if which == "last":
        paths = [ckpt.latest_checkpoint(run_dir)]
    elif which == "best":
        policy_name = monitor_preset or "lh_sr"
        best = ckpt.best_checkpoint(run_dir, policy_name)
        pol = ckpt.resolve_checkpoint_policy(policy_name)
        journal_path = run_dir / "saved_models" / "monitor.json"
        scored = False
        if pol.monitor and journal_path.exists():
            journal = json.loads(journal_path.read_text())
            scored = any(pol.monitor in v for v in journal.values())
        if not scored:
            print(
                f"[eval] WARNING: monitor '{pol.monitor}' was never recorded "
                f"(train with the matching callback, e.g. --rollout for lh_sr); "
                f"falling back to the LATEST checkpoint {best}"
            )
        paths = [best]
    elif which == "all":
        paths = ckpt.all_checkpoints(run_dir)
    else:
        wanted = {int(e) for e in which.split(",")}
        paths = [p_ for p_ in ckpt.all_checkpoints(run_dir) if ckpt.checkpoint_epoch(p_) in wanted]
    return [p_ for p_ in paths if p_ is not None]


def protocol_chains(num_sequences: int, seed: int, lang_embeddings, env):
    """(task pool, sequences, initial states): with embeddings for every
    task (or none), the official protocol's feasibility-filtered chains and
    matched scene resets (calvin_agent.evaluation.multistep_sequences);
    with an embedding-restricted pool, uniformly sampled chains and no
    resets (not the official protocol: not comparable to published
    numbers)."""
    from hulc_tpu_torch.data.language import restrict_task_pool
    from hulc_tpu_torch.evaluation import chain_sampler
    from hulc_tpu_torch.evaluation.lh_eval import get_sequences
    from hulc_tpu_torch.evaluation.tasks import ALL_TASKS

    task_pool = restrict_task_pool(lang_embeddings, ALL_TASKS)
    if set(task_pool) == set(ALL_TASKS):
        pairs = chain_sampler.get_sequences(num_sequences, seed=seed)
        return task_pool, [chain for _, chain in pairs], chain_sampler.resets_for_env(pairs, env)
    return task_pool, get_sequences(num_sequences, tasks=task_pool, seed=seed), None


def main(argv=None):
    args = build_parser().parse_args(argv)

    from hulc_tpu_torch.config import apply_overrides, get_config
    from hulc_tpu_torch.data.language import load_task_embeddings
    from hulc_tpu_torch.data.statistics import DatasetStatistics
    from hulc_tpu_torch.evaluation.batched_eval import evaluate_policy_batched
    from hulc_tpu_torch.evaluation.fake_env import fake_env_for
    from hulc_tpu_torch.evaluation.lh_eval import evaluate_policy
    from hulc_tpu_torch.evaluation.policy import HulcPolicy
    from hulc_tpu_torch.evaluation.tasks import SceneObsTasks
    from hulc_tpu_torch.models.hulc import make_model
    from hulc_tpu_torch.training import checkpoint as ckpt

    cfg = apply_overrides(get_config(args.config), args.overrides) if args.overrides else get_config(args.config)
    run_dir = pathlib.Path(args.run_dir)
    paths = select_checkpoints(run_dir, args.checkpoint, args.monitor_preset)
    if not paths:
        raise SystemExit(f"no checkpoints found in {run_dir}/saved_models")

    # one model for every checkpoint: its state_dict is the template the weights are matched to
    model = make_model(cfg, args.device, seed=0).eval()
    template = model.state_dict()

    stats = None
    lang_embeddings = None
    if args.dataset_dir:
        val_dir = pathlib.Path(args.dataset_dir) / "validation"
        stats = DatasetStatistics.load(val_dir)
        emb_path = val_dir / args.lang_folder / "embeddings.npy"
        if emb_path.exists():
            lang_embeddings = load_task_embeddings(emb_path)

    if args.env_factory:
        env, oracle = _load_env_factory(args.env_factory)()
    else:
        env = fake_env_for(cfg, interactive=not args.inert_env)
        calibration = args.oracle_calibration
        if calibration is None:
            # calibration by default: oracle_regions.json next to the run or the dataset
            candidates = [run_dir / "oracle_regions.json"]
            if args.dataset_dir:
                candidates += [
                    pathlib.Path(args.dataset_dir) / "validation" / "oracle_regions.json",
                    pathlib.Path(args.dataset_dir) / "oracle_regions.json",
                ]
            calibration = next((c for c in candidates if c.exists()), None)
            if calibration is not None:
                print(f"[eval] using oracle calibration {calibration}")
        oracle = SceneObsTasks.from_calibration(calibration) if calibration else SceneObsTasks()

    task_pool, sequences, initial_states = protocol_chains(args.num_sequences, args.seed, lang_embeddings, env)
    embeddings = lang_embeddings or {t: np.zeros(cfg.lang_dim, np.float32) for t in task_pool}

    out_dir = run_dir / "evaluation"
    video_dir = pathlib.Path(args.video_dir) if args.video_dir else out_dir / "videos"
    batched_envs = None  # made once, reused across checkpoints
    batched_policy = None  # built once over `model`; each checkpoint swaps the weights
    policy = None
    for path in paths:
        epoch = ckpt.checkpoint_epoch(path)
        model.load_state_dict(ckpt.restore_params(path, template))
        tsne_path = (out_dir / f"tsne_data_{epoch}.npz") if args.tsne_dump else None
        if args.batched:
            if batched_envs is None:
                if args.env_factory:
                    factory_fn = _load_env_factory(args.env_factory)
                    # the oracle's env is the first lane
                    batched_envs = [env] + [factory_fn()[0] for _ in range(args.num_envs - 1)]
                else:
                    batched_envs = [env] + [
                        fake_env_for(cfg, interactive=not args.inert_env) for _ in range(args.num_envs - 1)
                    ]
            results = evaluate_policy_batched(
                cfg, model,
                num_sequences=args.num_sequences,
                num_envs=args.num_envs,
                ep_len=args.ep_len,
                oracle=oracle,
                sequences=sequences,
                lang_embeddings=embeddings,
                statistics=stats,
                epoch=epoch,
                output_dir=out_dir,
                seed=args.seed,
                envs=batched_envs,
                policy=batched_policy,
                results_name=args.results_name,
                initial_states=initial_states,
                num_videos=args.num_videos,
                video_dir=video_dir,
                tsne_path=tsne_path,
            )
            batched_policy = results.pop("_policy", batched_policy)
            r = results[str(epoch)]
            print(f"[eval] epoch {epoch} (batched x{args.num_envs}): avg_seq_len={r['avg_seq_len']:.3f}")
            continue
        if policy is None:
            policy = HulcPolicy(cfg, model, statistics=stats, seed=args.seed)
        policy.lang_embeddings = embeddings
        results = evaluate_policy(
            policy,
            env,
            epoch=epoch,
            num_sequences=args.num_sequences,
            ep_len=args.ep_len,
            oracle=oracle,
            sequences=sequences,
            initial_states=initial_states,
            output_dir=out_dir,
            seed=args.seed,
            results_name=args.results_name,
            num_videos=args.num_videos,
            video_dir=video_dir,
            tsne_path=tsne_path,
        )
        r = results[str(epoch)]
        print(
            f"[eval] epoch {epoch}: avg_seq_len={r['avg_seq_len']:.3f} "
            f"chain_sr={[round(v, 3) for v in r['chain_sr'].values()]}"
        )
    print(f"[eval] results written to {out_dir}/{args.results_name}")


if __name__ == "__main__":
    main()
