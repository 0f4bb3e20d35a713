"""Policy export: serving artifacts of ``torch.export`` programs (port of
hulc_tpu/serving/export.py).

The closed-loop policy's device functions (``evaluation.policy.build_policy_fns``
and the lockstep ``evaluation.batched_eval.build_batched_step``) are
exported once as ``torch.export`` programs, which the runtime
(``serving.runtime``) loads with torch, numpy and the port's kernel ops
alone: no model code, no config. Each program takes the weights as its
first input, a dict in the state_dict's order, so they are stored once,
beside the programs, as ``params.npz``; observation normalization, the
replan cadence, the carry and the noise are described in ``meta.json``.

Artifact layout (one directory):

    meta.json            format version, shapes, normalizer, carry and noise spec
                         (and a bf16 model's compute_dtype)
    params.npz           the state_dict, fp32 (a bf16 model's too)
    replan_lang.pt2      (params, rgb_static, rgb_gripper, rob_norm, lang_emb,
                          plan noise) -> (plan, latent_goal)
    replan_vision.pt2    (params, 2-frame stacks, plan noise) -> (plan, latent_goal)
    act.pt2              (params, plan, goal, frames, rob_norm, rob_raw, carry,
                          u_mix, u_inv) -> (action, carry); the carry a
                          tensor, lstm's pair (h, c), or the mlp cell's
                          empty (0,) tensor
    step_batched.pt2     optional E-lane lockstep step (``lanes=E``)
    lang_embeddings.npy  optional instruction -> embedding table

The noise crosses the boundary as inputs, as JAX passes ``key_data``: the
plan's noise (a discrete plan's Gumbel noise, ``gumbel``; a continuous
plan's standard-normal draw, ``normal``) and the mixture sampler's
uniforms, already mapped into (U_MIN, U_MAX). The runtime draws them from its own generator in the
live policy's order and shapes (``meta.json``'s ``noise``), so a served
step gives the live step's action; no program holds a random node. A
program takes only the draws its model makes: GCBC's replans take no plan
noise (its plan is empty, (B, 0)), and the deterministic decoder's act
takes no uniforms. Frames cross raw uint8: the preprocess is inside the
programs; a config without cameras takes the proprio alone.

The four serving kernels are the ``hulc::`` ops of ``ops.library``; each
program must hold them as nodes (``expected_op_counts``), so loaded on the
card it launches the kernels. A model built with ``use_kernels=False``
would export their plain versions: it is refused, and so is any program
that lacks its ops. A program exported on one device is moved to another
by the runtime (``torch.export.passes.move_to_device_pass``), so one
artifact serves the CPU tests and the card. AOTInductor is not used: its
C++ runtime cannot call the ops' Python implementations, and it would
recompile the eager operations around the kernels, so served actions
would no longer equal live ones.

A bf16 model (``compute_dtype="bfloat16"``) exports the same way: its casts
to bf16 are nodes of the programs, its parameters stay fp32 in
``params.npz``, and the runtime's contract does not change. ``meta.json``
then records ``compute_dtype`` for the reader; an fp32 artifact keeps the
JAX package's keys, with no such entry.
"""

from __future__ import annotations

import collections
import json
import pathlib
from typing import Callable, Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn

from hulc_tpu_torch.config import HulcConfig
from hulc_tpu_torch.data.statistics import DatasetStatistics
from hulc_tpu_torch.evaluation.batched_eval import build_batched_step
from hulc_tpu_torch.evaluation.policy import StateObsNormalizer, build_policy_fns, refuse_unserved
from hulc_tpu_torch.models.hulc import HulcModel, make_model
from hulc_tpu_torch.ops.logistic_mixture import U_MIN, U_SPAN
from hulc_tpu_torch.serving.params_io import flatten_params

__all__ = ["export_policy", "expected_op_counts", "op_counts", "random_nodes", "main"]

FORMAT_VERSION = 1
# the decoder cell's recurrence op, one node a layer in a program that acts
RECURRENCE_OPS = {"rnn": "rnn_relu_fwd", "gru": "rnn_gru_fwd", "lstm": "rnn_lstm_fwd"}
# graph nodes that would draw noise inside a program
_RANDOM_OPS = ("rand", "uniform", "normal", "bernoulli", "multinomial", "exponential", "geometric", "poisson")


class _Bound(nn.Module):
    """``fn``, a function of the model's submodules, as a module whose one
    child is the model, so ``functional_call`` can swap its weights."""

    def __init__(self, model: HulcModel, fn: Callable):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, *args, **kwargs):
        return self.fn(*args, **kwargs)


class _Program(nn.Module):
    """The module ``torch.export`` traces: ``(params, *inputs, *noise)``. The
    bound function is kept out of the registered children, so no weight is
    lifted into the program: they are its first input."""

    def __init__(self, bound: _Bound, noise: Sequence[str]):
        super().__init__()
        self.__dict__["bound"] = bound
        self.noise = tuple(noise)

    def forward(self, params: Dict[str, torch.Tensor], *args):
        n = len(args) - len(self.noise)
        named = {f"model.{k}": v for k, v in params.items()}
        return torch.func.functional_call(self.bound, named, args[:n], dict(zip(self.noise, args[n:])), strict=True)


def op_counts(program: torch.export.ExportedProgram) -> Dict[str, int]:
    """{``hulc::`` op name: nodes} over the program's graphs."""
    counts = collections.Counter()
    for gm in program.graph_module.modules():
        if isinstance(gm, torch.fx.GraphModule):
            for node in gm.graph.nodes:
                name = str(node.target)
                if node.op == "call_function" and name.startswith("hulc."):
                    counts[name.split(".")[1]] += 1
    return dict(counts)


def random_nodes(program: torch.export.ExportedProgram) -> list:
    """The program's nodes that draw random numbers (there must be none)."""
    out = []
    for gm in program.graph_module.modules():
        if isinstance(gm, torch.fx.GraphModule):
            for node in gm.graph.nodes:
                if node.op == "call_function" and any(r in str(node.target) for r in _RANDOM_OPS):
                    out.append(str(node.target))
    return out


def expected_op_counts(cfg: HulcConfig, name: str) -> Dict[str, int]:
    """The ``hulc::`` nodes program ``name`` must hold: one preprocess per
    camera (each camera's frame stack in one call), one SpatialSoftmax per
    SpatialSoftmax encoder, and in a program that acts, one sample (the
    logistic decoder's; the deterministic one samples nothing) and one
    recurrence a decoder layer (the mlp cell has none)."""
    pe, ad = cfg.perceptual_encoder, cfg.action_decoder
    cams = [c for c in (pe.rgb_static, pe.rgb_gripper) if c is not None]
    out = {"preprocess_rgb": len(cams), "spatial_softmax": sum(c.kind == "spatial_softmax" for c in cams)}
    if name in ("act", "step_batched"):
        out["sample_action"] = int(ad.kind == "logistic")
        if ad.rnn_cell != "mlp":
            out[RECURRENCE_OPS[ad.rnn_cell]] = ad.num_layers
    return {k: v for k, v in out.items() if v}


def _export_one(model, fn, params, args, noise, name, cfg) -> torch.export.ExportedProgram:
    with torch.no_grad():
        program = torch.export.export(_Program(_Bound(model, fn), noise), (params, *args), strict=False)
    found, want = op_counts(program), expected_op_counts(cfg, name)
    if found != want:
        raise RuntimeError(f"exported {name} holds the hulc ops {found}, expected {want}: a program without its "
                           f"kernels would run their plain versions")
    rand = random_nodes(program)
    if rand:
        raise RuntimeError(f"exported {name} draws noise inside the program ({rand}); noise must be an input")
    return program


def _carry_spec(cfg: HulcConfig) -> Dict:
    d = cfg.action_decoder
    return {"rnn_cell": d.rnn_cell, "num_layers": d.num_layers, "hidden_size": d.hidden_size}


def _noise_spec(cfg: HulcConfig) -> Dict:
    """Per lane, the shape of each draw the model makes, in the order the
    live policy draws: the plan's noise (on a replan step, every step in
    the lockstep step; GCBC draws none): ``gumbel``, one ``torch.rand``
    through ``gumbel_of_uniform``, or ``normal``, one ``torch.randn``; then
    the logistic decoder's two ``torch.rand`` draws, mapped as ``lo + span
    * u`` (the deterministic decoder draws none)."""
    d, ad = cfg.distribution, cfg.action_decoder
    plan = {}
    if cfg.model_kind != "gcbc":
        plan = {"gumbel": [d.category_size, d.class_size]} if d.kind == "discrete" else {"normal": [d.plan_features]}
    spec = {"order": list(plan), **plan}
    if ad.kind == "logistic":
        a = ad.out_features - 1 if ad.discrete_gripper else ad.out_features
        spec.update(order=[*plan, "u_mix", "u_inv"], u_mix=[1, a, ad.n_mixtures], u_inv=[1, a],
                    uniform_map=[U_MIN, U_SPAN])
    return spec


def export_policy(
    cfg: HulcConfig,
    params: Union[HulcModel, Mapping[str, torch.Tensor]],
    out_dir,
    statistics: Optional[DatasetStatistics] = None,
    lang_embeddings: Optional[Dict[str, np.ndarray]] = None,
    lanes: int = 0,
    device="cuda",
) -> pathlib.Path:
    """Write a self-contained serving artifact directory. ``params`` is the
    port's state_dict, loaded into a model built on ``device`` (CUDA unless
    the caller asks for another), or a model, exported as it is (a model
    built with ``use_kernels=False`` is refused). ``lanes > 0`` also
    exports the E-lane lockstep step. A config with a depth or CLIP camera
    or a tactile tower is refused (``evaluation.policy.refuse_unserved``)."""
    refuse_unserved(cfg, "export_policy")
    if isinstance(params, HulcModel):
        model = params.eval()
        if not model.use_kernels:
            raise ValueError("export_policy refuses a use_kernels=False model: its programs would hold the "
                             "plain versions of the kernels")
    else:
        model = make_model(cfg, device)
        model.load_state_dict(params)
    dev = model.device
    state = dict(model.state_dict())
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    norm = StateObsNormalizer(cfg, statistics)
    pe = cfg.perceptual_encoder
    prop_dim = int(sum(b - a for a, b in norm.keep))
    noise = _noise_spec(cfg)

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def frames(cam, e, s):
        return None if cam is None else zeros(e, s, cam.input_size, cam.input_size, 3, dtype=torch.uint8)

    def draws(e):
        return [zeros(e, *noise[k]) for k in noise["order"]]

    def lane_args(e, s=1):
        return frames(pe.rgb_static, e, s), frames(pe.rgb_gripper, e, s), zeros(e, s, prop_dim)

    replan_lang, replan_vision, act = build_policy_fns(model, cfg)
    one = dict(zip(noise["order"], draws(1)))
    plan_names = tuple(k for k in noise["order"] if k in ("gumbel", "normal"))
    act_names = tuple(k for k in noise["order"] if k in ("u_mix", "u_inv"))
    plan_noise = tuple(one[k] for k in plan_names)
    with torch.no_grad():
        plan, goal = replan_lang(*lane_args(1), zeros(1, cfg.lang_dim), **{k: one[k] for k in plan_names})
    carry = model.init_decoder_carry(1)
    specs = {
        "replan_lang": (replan_lang, (*lane_args(1), zeros(1, cfg.lang_dim), *plan_noise), plan_names),
        "replan_vision": (replan_vision, (*lane_args(1, 2), *plan_noise), plan_names),
        "act": (act, (plan, goal, *lane_args(1), zeros(1, 1, 15), carry, *(one[k] for k in act_names)), act_names),
    }
    if lanes > 0:
        e = lanes
        specs["step_batched"] = (build_batched_step(model, cfg), (
            *lane_args(e), zeros(e, 1, 15), zeros(e, cfg.lang_dim), zeros(e, plan.shape[-1]),
            zeros(e, cfg.visual_goal.latent_goal_features), model.init_decoder_carry(e),
            zeros(e, dtype=torch.bool), *draws(e),
        ), tuple(noise["order"]))
    for name, (fn, args, noise_names) in specs.items():
        program = _export_one(model, fn, state, args, noise_names, name, cfg)
        program.example_inputs = None  # saved with it otherwise: a copy of the weights in every program
        torch.export.save(program, out / f"{name}.pt2")
    np.savez(out / "params.npz", **flatten_params(state))
    if lang_embeddings:
        np.save(
            out / "lang_embeddings.npy",
            {k: np.asarray(v, np.float32) for k, v in lang_embeddings.items()},
            allow_pickle=True,
        )

    meta = {
        "format_version": FORMAT_VERSION,
        "torch_version": torch.__version__,
        "device": str(dev),
        "model_kind": cfg.model_kind,
        "replan_freq": cfg.replan_freq,
        "lang_dim": cfg.lang_dim,
        "prop_dim": prop_dim,
        "plan_dim": int(plan.shape[-1]),
        "latent_goal_features": int(goal.shape[-1]),
        "lanes": lanes,
        "cameras": {
            "rgb_static": pe.rgb_static.input_size if pe.rgb_static else None,
            "rgb_gripper": pe.rgb_gripper.input_size if pe.rgb_gripper else None,
        },
        "proprio": {
            "keep": [list(k) for k in norm.keep],
            "normalize": bool(norm.normalize),
            "include_scene": bool(norm.include_scene),
            "robot_obs_mean": np.asarray(norm.rob_mean).tolist(),
            "robot_obs_std": np.asarray(norm.rob_std).tolist(),
            "scene_obs_mean": np.asarray(norm.scene_mean).tolist(),
            "scene_obs_std": np.asarray(norm.scene_std).tolist(),
        },
        "carry": _carry_spec(cfg),
        "noise": noise,
    }
    if cfg.compute_dtype != "float32":
        meta["compute_dtype"] = cfg.compute_dtype
    (out / "meta.json").write_text(json.dumps(meta, indent=1))
    print(f"[export] wrote {sorted(p.name for p in out.iterdir())} -> {out}")
    return out


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Export a trained policy as a serving artifact")
    p.add_argument("--run-dir", required=True)
    p.add_argument("--config", required=True, help="config preset name")
    p.add_argument("--out", required=True, help="artifact output directory")
    p.add_argument("--checkpoint", default="last", help="last | best | <epoch>")
    p.add_argument("--dataset-dir", default=None, help="for statistics + lang embeddings")
    p.add_argument("--lang-folder", default="lang_annotations")
    p.add_argument("--lanes", type=int, default=0, help="also export an E-lane batched step")
    p.add_argument("--device", default="cuda", help="the device the programs are exported on")
    p.add_argument("--set", dest="overrides", action="append", default=[], metavar="KEY=VALUE",
                   help="a dotted-path config override, e.g. action_decoder.rnn_cell=lstm (repeatable)")
    args = p.parse_args(argv)

    from hulc_tpu_torch.config import apply_overrides, get_config
    from hulc_tpu_torch.training import checkpoint as ckpt

    cfg = apply_overrides(get_config(args.config), args.overrides)
    model = make_model(cfg, args.device)
    run_dir = pathlib.Path(args.run_dir)
    if args.checkpoint == "last":
        path = ckpt.latest_checkpoint(run_dir)
    elif args.checkpoint == "best":
        path = ckpt.best_checkpoint(run_dir, "lh_sr")
    else:
        wanted = int(args.checkpoint)
        path = next((c for c in ckpt.all_checkpoints(run_dir) if ckpt.checkpoint_epoch(c) == wanted), None)
    if path is None:
        raise SystemExit(f"no checkpoint found in {run_dir}/saved_models")
    model.load_state_dict(ckpt.restore_params(path, model.state_dict()))

    stats, lang_embeddings = None, None
    if args.dataset_dir:
        from hulc_tpu_torch.data.language import load_task_embeddings

        val_dir = pathlib.Path(args.dataset_dir) / "validation"
        stats = DatasetStatistics.load(val_dir)
        emb_path = val_dir / args.lang_folder / "embeddings.npy"
        if emb_path.exists():
            lang_embeddings = load_task_embeddings(emb_path)

    export_policy(cfg, model, args.out, statistics=stats, lang_embeddings=lang_embeddings, lanes=args.lanes)


if __name__ == "__main__":
    main()
