"""JAX parameter tree (as numpy arrays) -> the port's state_dict.

The inverse of the layout changes in hulc_tpu/training/torch_convert.py:

* Dense kernels (in, out) transpose to Linear weights (out, in);
* conv kernels go from HWIO to OIHW;
* ``ScanRNN``'s ``ih_k`` / ``hh_k`` / ``bhh_k`` become ``weight_ih_lk`` /
  ``bias_ih_lk`` / ``weight_hh_lk`` / ``bias_hh_lk``; ``ScanBiRNN``'s
  ``fwd_k`` / ``bwd_k`` (each a one-layer ScanRNN) become layer k's
  parameters, the reverse chain's with the ``_reverse`` suffix; the gru
  and lstm cells' gate-wide ones (3H, 4H), the decoder's and the BiRNN's,
  keep JAX's gate order, which is torch's;
* the nature-CNN's first dense kernel is re-permuted from the NHWC flatten
  (y, x, c) to the NCHW flatten (c, y, x);
* LayerNorm ``scale`` becomes ``weight`` (the recognition transformer's
  optional ``positional_norm`` and ``encoder/final_norm`` too, which the
  JAX package's own ``torch_convert.convert_state_dict`` does not map);
* flax attention's per-head ``query`` / ``key`` / ``value`` kernels
  (d, heads, d / heads) and ``out`` kernel (heads, d / heads, d) become
  torch's ``in_proj_weight`` (3d, d), ``in_proj_bias`` and ``out_proj``.

Each camera tower the config names (RGB and depth, static and gripper,
tactile) is carried by its encoder's kind; params without one of them are
refused. The frozen towers: ``VisionClip``'s RN50 or ViT under OpenAI
CLIP's ``visual.*`` names (flax's ``FrozenBatchNorm`` ``scale`` / ``bias``
/ ``mean`` / ``var`` become ``weight`` / ``bias`` / ``running_mean`` /
``running_var``; the ViT attention's per-head ``DenseGeneral`` kernels the
``in_proj_weight`` rows), ``TactileEncoder``'s ResNet18 under
torchvision's, each with as many blocks as JAX's tree holds.
A GCBC model has no plan proposal; the ``mlp`` decoder cell's layers are
``rnn/dense_{i}``, the deterministic decoder's head ``action_fc``; the
auxiliary heads (``proj_vis_lang`` with CLIP or MIA, ``logit_scale`` with
CLIP, ``bc_z_lang_decoder``, ``mia_lang_discriminator``,
``perceptual_encoder/state_decoder``) are carried where the config turns
their loss on. Subtrees the port has no module for are returned as a list
of unused '/'-joined paths, never dropped silently; for every preset the
port builds the list is empty.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from hulc_tpu_torch.config import HulcConfig
from hulc_tpu_torch.models.layers import GATE_MULTIPLE


class _Reader:
    """Reads leaves from the nested JAX tree and records which were used."""

    def __init__(self, params: Mapping[str, Any]):
        self.params = params
        self.used = set()

    def get(self, path: str) -> np.ndarray:
        node = self.params
        for key in path.split("/"):
            node = node[key]
        self.used.add(path)
        return np.asarray(node, np.float32)

    def has(self, path: str) -> bool:
        node = self.params
        for key in path.split("/"):
            if not isinstance(node, Mapping) or key not in node:
                return False
            node = node[key]
        return True


def _leaf_paths(tree: Mapping[str, Any], prefix: str = "") -> List[str]:
    out = []
    for key, node in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        out.extend(_leaf_paths(node, path) if isinstance(node, Mapping) else [path])
    return out


def _linear(r: _Reader, sd: Dict[str, np.ndarray], src: str, dst: str) -> None:
    sd[f"{dst}.weight"] = r.get(f"{src}/kernel").T
    sd[f"{dst}.bias"] = r.get(f"{src}/bias")


def _layernorm(r: _Reader, sd: Dict[str, np.ndarray], src: str, dst: str) -> None:
    sd[f"{dst}.weight"] = r.get(f"{src}/scale")
    sd[f"{dst}.bias"] = r.get(f"{src}/bias")


def _conv_nobias(r: _Reader, sd: Dict[str, np.ndarray], src: str, dst: str) -> None:
    sd[f"{dst}.weight"] = r.get(f"{src}/kernel").transpose(3, 2, 0, 1)


def _frozen_bn(r: _Reader, sd: Dict[str, np.ndarray], src: str, dst: str) -> None:
    for jax_name, name in (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"), ("var", "running_var")):
        sd[f"{dst}.{name}"] = r.get(f"{src}/{jax_name}")


def _res_blocks(r: _Reader, sd: Dict[str, np.ndarray], src: str, dst: str, convs: int) -> None:
    """The four stages of a ResNet, as many blocks each as JAX's tree holds
    (``layer{s}_{b}`` -> ``layer{s}.{b}``), ``convs`` convolutions a block."""
    for stage in (1, 2, 3, 4):
        bi = 0
        while r.has(f"{src}/layer{stage}_{bi}"):
            b, d = f"{src}/layer{stage}_{bi}", f"{dst}.layer{stage}.{bi}"
            for i in range(1, convs + 1):
                _conv_nobias(r, sd, f"{b}/conv{i}", f"{d}.conv{i}")
                _frozen_bn(r, sd, f"{b}/bn{i}", f"{d}.bn{i}")
            if r.has(f"{b}/downsample_conv"):
                _conv_nobias(r, sd, f"{b}/downsample_conv", f"{d}.downsample.0")
                _frozen_bn(r, sd, f"{b}/downsample_bn", f"{d}.downsample.1")
            bi += 1


def _clip_tower(r: _Reader, sd: Dict[str, np.ndarray], src: str, dst: str) -> None:
    """``VisionClip``: the RN50 or ViT tower (flax's auto-named
    ``ModifiedResNet_0`` / ``CLIPVisionTransformer_0``) under OpenAI's
    ``visual.*`` names, then the head."""
    v = f"{dst}.visual" if dst else "visual"
    if r.has(f"{src}/ModifiedResNet_0"):
        t = f"{src}/ModifiedResNet_0"
        for i in (1, 2, 3):
            _conv_nobias(r, sd, f"{t}/conv{i}", f"{v}.conv{i}")
            _frozen_bn(r, sd, f"{t}/bn{i}", f"{v}.bn{i}")
        _res_blocks(r, sd, t, v, 3)
        sd[f"{v}.attnpool.positional_embedding"] = r.get(f"{t}/attnpool/positional_embedding")
        for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
            _linear(r, sd, f"{t}/attnpool/{name}", f"{v}.attnpool.{name}")
    else:
        t = f"{src}/CLIPVisionTransformer_0"
        _conv_nobias(r, sd, f"{t}/conv1", f"{v}.conv1")
        for name in ("class_embedding", "positional_embedding", "proj"):
            sd[f"{v}.{name}"] = r.get(f"{t}/{name}")
        _layernorm(r, sd, f"{t}/ln_pre", f"{v}.ln_pre")
        _layernorm(r, sd, f"{t}/ln_post", f"{v}.ln_post")
        i = 0
        while r.has(f"{t}/transformer/resblock_{i}"):
            b, d = f"{t}/transformer/resblock_{i}", f"{v}.transformer.resblocks.{i}"
            _layernorm(r, sd, f"{b}/ln_1", f"{d}.ln_1")
            _layernorm(r, sd, f"{b}/ln_2", f"{d}.ln_2")
            attn = f"{b}/attn"
            d_model = r.get(f"{attn}/query/kernel").shape[0]
            sd[f"{d}.attn.in_proj_weight"] = np.concatenate(
                [r.get(f"{attn}/{n}/kernel").reshape(d_model, d_model).T for n in ("query", "key", "value")])
            sd[f"{d}.attn.in_proj_bias"] = np.concatenate(
                [r.get(f"{attn}/{n}/bias").reshape(d_model) for n in ("query", "key", "value")])
            sd[f"{d}.attn.out_proj.weight"] = r.get(f"{attn}/out/kernel").reshape(d_model, d_model).T
            sd[f"{d}.attn.out_proj.bias"] = r.get(f"{attn}/out/bias")
            _linear(r, sd, f"{b}/c_fc", f"{d}.mlp.c_fc")
            _linear(r, sd, f"{b}/c_proj", f"{d}.mlp.c_proj")
            i += 1
    _linear(r, sd, f"{src}/fc1", f"{dst}.fc1.0" if dst else "fc1.0")
    _linear(r, sd, f"{src}/fc2", f"{dst}.fc2" if dst else "fc2")


def _tactile_tower(r: _Reader, sd: Dict[str, np.ndarray], src: str, dst: str) -> None:
    """``TactileEncoder``: the ResNet18 under torchvision's names, then the head."""
    t, b = f"{src}/backbone", f"{dst}.backbone" if dst else "backbone"
    _conv_nobias(r, sd, f"{t}/conv1", f"{b}.conv1")
    _frozen_bn(r, sd, f"{t}/bn1", f"{b}.bn1")
    _res_blocks(r, sd, t, b, 2)
    _linear(r, sd, f"{src}/fc1", f"{dst}.fc1.0" if dst else "fc1.0")
    _linear(r, sd, f"{src}/fc2", f"{dst}.fc2" if dst else "fc2")


# the frozen towers by encoder kind
FROZEN_TOWERS = {"clip": _clip_tower, "tactile": _tactile_tower}


def frozen_tower_from_jax(params_np: Mapping[str, Any], kind: str) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """A JAX ``VisionClip`` (``kind="clip"``) or ``TactileEncoder``
    (``"tactile"``) param tree -> (state_dict of the port's module, unused
    JAX leaf paths)."""
    r = _Reader({"tower": params_np})
    sd: Dict[str, np.ndarray] = {}
    FROZEN_TOWERS[kind](r, sd, "tower", "")
    unused = sorted(set(_leaf_paths({"tower": params_np})) - r.used)
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}, unused


def params_from_jax(
    params_np: Mapping[str, Any], cfg: HulcConfig
) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """Return (state_dict for ``HulcModel(cfg)``, unused JAX leaf paths)."""
    r = _Reader(params_np)
    sd: Dict[str, np.ndarray] = {}

    def conv(src: str, dst: str):
        _conv_nobias(r, sd, src, dst)
        sd[f"{dst}.bias"] = r.get(f"{src}/bias")

    def conv_tower(src: str, dst: str):
        for i, name in enumerate(("conv0", "conv1", "conv2")):
            conv(f"{src}/{name}", f"{dst}.conv_model.{2 * i}")

    def static_tower(src: str, dst: str, enc):
        conv_tower(src, dst)
        if enc.spatial_softmax_temp is None:
            sd[f"{dst}.spatial_softmax.temperature"] = r.get(f"{src}/spatial_softmax/temperature").reshape(1)
        _linear(r, sd, f"{src}/fc1", f"{dst}.fc1.0")
        _linear(r, sd, f"{src}/fc2", f"{dst}.fc2")
        _layernorm(r, sd, f"{src}/ln", f"{dst}.ln")

    def nature_cnn(src: str, dst: str, enc):
        conv_tower(src, dst)
        k = r.get(f"{src}/fc0/kernel")  # (side * side * c, out), NHWC flatten
        c = sd[f"{dst}.conv_model.4.weight"].shape[0]
        side = int(round((k.shape[0] // c) ** 0.5))
        sd[f"{dst}.conv_model.7.weight"] = (
            k.reshape(side, side, c, -1).transpose(3, 2, 0, 1).reshape(k.shape[1], -1)
        )
        sd[f"{dst}.conv_model.7.bias"] = r.get(f"{src}/fc0/bias")
        _linear(r, sd, f"{src}/fc1", f"{dst}.fc1.0")
        _linear(r, sd, f"{src}/fc2", f"{dst}.fc2")
        _layernorm(r, sd, f"{src}/ln", f"{dst}.ln")

    pe = cfg.perceptual_encoder
    for cam in ("rgb_static", "rgb_gripper", "depth_static", "depth_gripper", "tactile"):
        enc = getattr(pe, cam)
        if enc is None:
            continue
        src = f"perceptual_encoder/{cam}"
        if not r.has(src):
            raise ValueError(
                f"the JAX params have no {src} tower, which the config names (a JAX model initialized "
                f"on a batch without {cam} frames builds none)"
            )
        if enc.kind in FROZEN_TOWERS:
            FROZEN_TOWERS[enc.kind](r, sd, src, f"perceptual_encoder.{cam}_encoder")
            continue
        tower = {"spatial_softmax": static_tower, "nature_cnn": nature_cnn}[enc.kind]
        tower(src, f"perceptual_encoder.{cam}_encoder", enc)

    if pe.proprio is not None and pe.use_state_decoder and cfg.state_recons:
        for i in range(3):
            _linear(r, sd, f"perceptual_encoder/state_decoder/mlp/dense_{i}",
                    f"perceptual_encoder.state_decoder.mlp.{2 * i}")

    if cfg.model_kind != "gcbc":
        for i in range(cfg.plan_proposal.num_layers):
            _linear(r, sd, f"plan_proposal/fc_{i}", f"plan_proposal.fc_model.{2 * i}")
        _linear(r, sd, "plan_proposal/fc_state", "plan_proposal.fc_state.0")

    for name, offset in (("visual_goal", 0), ("language_goal", 1)):
        if name == "language_goal" and cfg.language_goal is None:
            continue
        for i in range(3):
            _linear(r, sd, f"{name}/fc{i}", f"{name}.mlp.{offset + 2 * i}")
        if r.has(f"{name}/ln"):
            _layernorm(r, sd, f"{name}/ln", f"{name}.ln")

    def rnn_layer(src: str, dst: str, k: int, suffix: str = "", src_k: int | None = None, gates: int = 1):
        """ScanRNN layer ``src_k`` (default k) of ``src`` as torch nn.RNN's
        (nn.GRU's, nn.LSTM's) layer k of ``dst``, its names ending in
        ``suffix``: JAX's (in, G H) kernels transposed, the gates in JAX's
        order, which is torch's (r z n; i f g o)."""
        src_k = k if src_k is None else src_k
        hh = r.get(f"{src}/hh_{src_k}")
        if hh.ndim != 2 or hh.shape[1] != gates * hh.shape[0]:
            raise ValueError(f"{src}/hh_{src_k} has shape {hh.shape}, not (H, {gates} H) of a {gates}-gate cell")
        sd[f"{dst}.weight_ih_l{k}{suffix}"] = r.get(f"{src}/ih_{src_k}/kernel").T
        sd[f"{dst}.bias_ih_l{k}{suffix}"] = r.get(f"{src}/ih_{src_k}/bias")
        sd[f"{dst}.weight_hh_l{k}{suffix}"] = hh.T
        sd[f"{dst}.bias_hh_l{k}{suffix}"] = r.get(f"{src}/bhh_{src_k}")

    ad = cfg.action_decoder
    if ad.rnn_cell == "mlp":
        for i in range(3):
            _linear(r, sd, f"action_decoder/rnn/dense_{i}", f"action_decoder.rnn.{2 * i}")
    else:
        for k in range(ad.num_layers):
            rnn_layer("action_decoder/rnn", "action_decoder.rnn", k, gates=GATE_MULTIPLE[ad.rnn_cell])
    if ad.kind == "deterministic":
        heads = ("action_fc",)
    else:
        heads = ("mean_fc", "log_scale_fc", "prob_fc") + (("gripper_fc",) if ad.discrete_gripper else ())
    for head in heads:
        _linear(r, sd, f"action_decoder/{head}", f"action_decoder.{head}")

    pr = cfg.plan_recognition
    if pr.kind == "birnn":
        # each direction of layer k is a one-layer ScanRNN, fwd_k / bwd_k
        for k in range(pr.birnn_num_layers):
            for name, suffix in (("fwd", ""), ("bwd", "_reverse")):
                rnn_layer(f"plan_recognition/birnn/{name}_{k}", "plan_recognition.birnn_model", k, suffix, src_k=0,
                          gates=GATE_MULTIPLE[pr.birnn_cell])
    else:
        if pr.position_embedding:
            sd["plan_recognition.position_embeddings.weight"] = r.get("plan_recognition/position_embeddings")
        if pr.positional_normalize:
            _layernorm(r, sd, "plan_recognition/positional_norm", "plan_recognition.positional_norm")
        for i in range(pr.num_layers):
            src, dst = f"plan_recognition/encoder/layer_{i}", f"plan_recognition.transformer_encoder.layers.{i}"
            attn = f"{src}/self_attn"
            d_model = r.get(f"{attn}/query/kernel").shape[0]
            sd[f"{dst}.self_attn.in_proj_weight"] = np.concatenate(
                [r.get(f"{attn}/{n}/kernel").reshape(d_model, d_model).T for n in ("query", "key", "value")]
            )
            sd[f"{dst}.self_attn.in_proj_bias"] = np.concatenate(
                [r.get(f"{attn}/{n}/bias").reshape(d_model) for n in ("query", "key", "value")]
            )
            sd[f"{dst}.self_attn.out_proj.weight"] = r.get(f"{attn}/out/kernel").reshape(d_model, d_model).T
            sd[f"{dst}.self_attn.out_proj.bias"] = r.get(f"{attn}/out/bias")
            _linear(r, sd, f"{src}/linear1", f"{dst}.linear1")
            _linear(r, sd, f"{src}/linear2", f"{dst}.linear2")
            _layernorm(r, sd, f"{src}/norm1", f"{dst}.norm1")
            _layernorm(r, sd, f"{src}/norm2", f"{dst}.norm2")
        if pr.encoder_normalize:
            _layernorm(r, sd, "plan_recognition/encoder/final_norm", "plan_recognition.transformer_encoder.final_norm")
        _linear(r, sd, "plan_recognition/fc", "plan_recognition.fc")
    _linear(r, sd, "plan_recognition/fc_state", "plan_recognition.fc_state.0")

    if cfg.use_clip_auxiliary_loss or cfg.use_mia_auxiliary_loss:
        for src, dst in (("im_fc0", "mlp_im.0"), ("im_fc1", "mlp_im.2"),
                         ("lang_fc0", "mlp_lang.0"), ("lang_fc1", "mlp_lang.2")):
            _linear(r, sd, f"proj_vis_lang/{src}", f"proj_vis_lang.{dst}")
    if cfg.use_clip_auxiliary_loss:
        sd["logit_scale"] = r.get("logit_scale").reshape(())
    for on, name in ((cfg.use_bc_z_auxiliary_loss, "bc_z_lang_decoder"),
                     (cfg.use_mia_auxiliary_loss, "mia_lang_discriminator")):
        if on:
            for fc in ("fc0", "fc1"):
                _linear(r, sd, f"{name}/{fc}", f"{name}.{fc}")

    unused = sorted(set(_leaf_paths(params_np)) - r.used)
    state_dict = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}
    return state_dict, unused
