"""Config dataclasses and the presets the port builds: every preset of the
JAX package's registry (``hulc``, ``mcil``, ``gcbc``, ``hulc_clip_vision``,
``hulc_clip_lang``, ``hulc_depth``, ``hulc_tactile``, ``hulc_deterministic``,
``hulc_state_only``, ``fetch_state``, ``fetch_vision`` and the ``*_debug``
ones).

A copy of the JAX package's config (hulc_tpu/config.py) for the port: the
same frozen dataclasses, field names and defaults, the same ``resolve()``
size inference, so a preset means the same model in both packages. Only
``HulcConfig.dtype`` differs: it maps ``compute_dtype`` to a torch dtype.

``apply_overrides`` is the JAX package's dotted-path overrides (the
reference's Hydra overrides, ``--set`` on the CLIs), copied: the same
parsing, coercion and errors, then ``resolve()``; it is how a config
reaches the decoder's gru and lstm cells
(``action_decoder.rnn_cell=gru``). A field the JAX config has and this one
lacks is refused as an unknown field, by name. ``hulc_clip_vision`` puts
a frozen CLIP image tower (RN50, or ViT-B/32 through
``perceptual_encoder.rgb_static.clip_model``) on the static camera,
``hulc_tactile`` a frozen ResNet18 tactile tower beside a static camera
alone, and ``hulc_clip_lang`` reads 1024-d language features; ``resolve()``
counts the tactile tower's features in the latent. ``hulc_depth``,
``hulc_deterministic``, ``fetch_vision`` and the CLIP and tactile presets
have no debug preset, as in the JAX package: ``_debug`` swaps in two RGB cameras for every camera-based
config (a camera-less one keeps its encoder).
"""

from __future__ import annotations

import ast
import dataclasses
import typing
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class VisionEncoderConfig:
    """Per-camera encoder: "spatial_softmax" (static cam), "nature_cnn"
    (gripper cam), "clip" (a frozen CLIP image tower, ``clip_model``) or
    "tactile" (a frozen ResNet18 on 6-channel tactile frames)."""

    kind: str = "spatial_softmax"  # | "nature_cnn" | "clip" | "tactile"
    input_size: int = 200
    num_channels: int = 3
    visual_features: int = 64
    dropout: float = 0.0
    l2_normalize_output: bool = False
    use_sinusoid: bool = False
    spatial_softmax_temp: Optional[float] = 1.0  # None -> learnable
    activation: str = "relu"
    shift_pad: int = 10  # random-shift augmentation padding (train only)
    clip_model: str = "RN50"  # kind == "clip": "RN50" | "ViT-B/32" | "ViT-B/16"


@dataclasses.dataclass(frozen=True)
class ProprioConfig:
    """Proprioception passthrough; ``keep_indices`` slice the state vector."""

    n_state_obs: int = 8
    keep_indices: Tuple[Tuple[int, int], ...] = ((0, 7), (14, 15))
    normalize: bool = True
    include_scene: bool = False


@dataclasses.dataclass(frozen=True)
class PerceptualEncoderConfig:
    rgb_static: Optional[VisionEncoderConfig] = VisionEncoderConfig()
    rgb_gripper: Optional[VisionEncoderConfig] = VisionEncoderConfig(
        kind="nature_cnn", input_size=84, shift_pad=4
    )
    depth_static: Optional[VisionEncoderConfig] = None
    depth_gripper: Optional[VisionEncoderConfig] = None
    tactile: Optional[VisionEncoderConfig] = None
    proprio: Optional[ProprioConfig] = None  # HULC default: no proprio
    use_state_decoder: bool = False
    remat: bool = False

    @property
    def cameras(self) -> Tuple[Optional[VisionEncoderConfig], ...]:
        return (self.rgb_static, self.rgb_gripper, self.depth_static,
                self.depth_gripper, self.tactile)

    @property
    def latent_size(self) -> int:
        size = sum(enc.visual_features for enc in self.cameras if enc is not None)
        if self.proprio is not None:
            size += self.proprio.n_state_obs
        if size == 0:
            raise ValueError("perceptual encoder needs at least one camera or proprio")
        return size


@dataclasses.dataclass(frozen=True)
class DistributionConfig:
    kind: str = "discrete"  # "discrete" | "continuous"
    category_size: int = 32
    class_size: int = 32
    plan_features: int = 256  # continuous only

    @property
    def plan_dim(self) -> int:
        return (
            self.category_size * self.class_size if self.kind == "discrete" else self.plan_features
        )


@dataclasses.dataclass(frozen=True)
class PlanProposalConfig:
    hidden_size: int = 2048
    num_layers: int = 4
    activation: str = "relu"
    perceptual_features: int = -1  # resolved
    latent_goal_features: int = 32


@dataclasses.dataclass(frozen=True)
class PlanRecognitionConfig:
    """Posterior net (training only; kept so presets compare field by field)."""

    kind: str = "transformer"  # "transformer" | "birnn"
    num_heads: int = 8
    num_layers: int = 2
    encoder_hidden_size: int = 2048
    fc_hidden_size: int = 4096
    dropout: float = 0.1
    encoder_normalize: bool = False
    positional_normalize: bool = False
    position_embedding: bool = True
    max_position_embeddings: int = 32
    birnn_hidden_size: int = 2048
    birnn_num_layers: int = 2
    birnn_dropout: float = 0.0
    birnn_cell: str = "rnn_tanh"
    in_features: int = -1  # resolved


@dataclasses.dataclass(frozen=True)
class GoalEncoderConfig:
    """``kind="goal"``: MLP capped by LayerNorm; ``kind="mlp"``: the plain
    three-Linear language head without LayerNorm."""

    kind: str = "goal"  # "goal" | "mlp"
    in_features: int = 384
    hidden_size: int = 2048
    latent_goal_features: int = 32
    l2_normalize: bool = False
    word_dropout: float = 0.0  # language only
    activation: str = "relu"


@dataclasses.dataclass(frozen=True)
class ActionDecoderConfig:
    kind: str = "logistic"  # "logistic" | "deterministic"
    n_mixtures: int = 10
    hidden_size: int = 2048
    out_features: int = 7
    log_scale_min: float = -7.0
    act_max_bound: Tuple[float, ...] = (1.0,) * 7
    act_min_bound: Tuple[float, ...] = (-1.0,) * 7
    num_classes: int = 10
    gripper_alpha: float = 1.0
    num_layers: int = 2
    rnn_cell: str = "rnn"  # "rnn" | "gru" | "lstm" | "mlp"
    rnn_dropout: float = 0.0
    gripper_control: bool = True  # TCP-frame actions
    discrete_gripper: bool = True
    perceptual_emb_slice: Optional[Tuple[int, int]] = (64, 128)
    plan_features: int = -1  # resolved
    perceptual_features: int = -1  # resolved
    latent_goal_features: int = 32
    criterion: str = "huber"


@dataclasses.dataclass(frozen=True)
class LossConfig:
    kl_beta: float = 0.01
    kl_balancing_mix: float = 0.8
    state_recon_beta: float = 0.5
    bc_z_auxiliary_loss_beta: float = 1.0
    mia_auxiliary_loss_beta: float = 1.0
    clip_auxiliary_loss_beta: float = 3.0


@dataclasses.dataclass(frozen=True)
class HulcConfig:
    model_kind: str = "hulc"  # "hulc" | "gcbc"
    perceptual_encoder: PerceptualEncoderConfig = PerceptualEncoderConfig()
    plan_proposal: PlanProposalConfig = PlanProposalConfig()
    plan_recognition: PlanRecognitionConfig = PlanRecognitionConfig()
    distribution: DistributionConfig = DistributionConfig()
    visual_goal: GoalEncoderConfig = GoalEncoderConfig()
    language_goal: Optional[GoalEncoderConfig] = GoalEncoderConfig()
    action_decoder: ActionDecoderConfig = ActionDecoderConfig()
    loss: LossConfig = LossConfig()
    use_clip_auxiliary_loss: bool = True
    use_bc_z_auxiliary_loss: bool = False
    use_mia_auxiliary_loss: bool = False
    state_recons: bool = False
    replan_freq: int = 30
    lang_dim: int = 384
    proj_vis_lang_dim: int = 32
    compute_dtype: str = "float32"  # "float32" | "bfloat16" for conv/matmul
    fuse_modalities: bool = False

    def resolve(self) -> "HulcConfig":
        """Propagate inferred feature sizes (reference setup_input_sizes)."""
        latent = self.perceptual_encoder.latent_size
        plan_dim = self.distribution.plan_dim
        decoder_plan = 0 if self.model_kind == "gcbc" else plan_dim
        return dataclasses.replace(
            self,
            plan_proposal=dataclasses.replace(self.plan_proposal, perceptual_features=latent),
            plan_recognition=dataclasses.replace(self.plan_recognition, in_features=latent),
            visual_goal=dataclasses.replace(self.visual_goal, in_features=latent),
            action_decoder=dataclasses.replace(
                self.action_decoder,
                perceptual_features=latent,
                plan_features=decoder_plan,
            ),
        )

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32


def hulc_config(**overrides) -> HulcConfig:
    return dataclasses.replace(HulcConfig(), **overrides).resolve()


def mcil_config(**overrides) -> HulcConfig:
    """MCIL (Lynch & Sermanet, RSS 2021): the BiRNN plan recognition, a
    continuous 256-d plan, world-frame actions, no gripper head, no CLIP loss."""
    base = HulcConfig(
        model_kind="hulc",
        plan_recognition=PlanRecognitionConfig(kind="birnn"),
        distribution=DistributionConfig(kind="continuous", plan_features=256),
        action_decoder=ActionDecoderConfig(
            num_classes=256,
            gripper_control=False,
            discrete_gripper=False,
            perceptual_emb_slice=None,
        ),
        use_clip_auxiliary_loss=False,
    )
    return dataclasses.replace(base, **overrides).resolve()


def hulc_depth_config(**overrides) -> HulcConfig:
    """RGB-D variant (conf/datamodule/observation_space/lang_rgbd_*): a
    depth tower beside each RGB camera, unshifted; the decoder reads the RGB
    gripper camera's slice of the 256-d latent."""
    base = HulcConfig(
        perceptual_encoder=PerceptualEncoderConfig(
            rgb_static=VisionEncoderConfig(),
            rgb_gripper=VisionEncoderConfig(kind="nature_cnn", input_size=84, shift_pad=4),
            depth_static=VisionEncoderConfig(num_channels=1, shift_pad=0),
            depth_gripper=VisionEncoderConfig(kind="nature_cnn", input_size=84, num_channels=1, shift_pad=0),
        ),
        action_decoder=ActionDecoderConfig(perceptual_emb_slice=(128, 192)),
    )
    return dataclasses.replace(base, **overrides).resolve()


def hulc_clip_vision_config(**overrides) -> HulcConfig:
    """Frozen-CLIP static camera (conf/model/perceptual_encoder/rgb_static/clip.yaml):
    224 px frames (the dataset's 200 px resized on the device) into a
    frozen RN50 and a trainable two-layer head; the 84 px gripper camera."""
    base = HulcConfig(
        perceptual_encoder=PerceptualEncoderConfig(
            rgb_static=VisionEncoderConfig(kind="clip", input_size=224, clip_model="RN50"),
            rgb_gripper=VisionEncoderConfig(kind="nature_cnn", input_size=84, shift_pad=4),
        ),
    )
    return dataclasses.replace(base, **overrides).resolve()


def hulc_clip_lang_config(**overrides) -> HulcConfig:
    """CLIP text-encoder language path (conf/model/sbert/clip_lang.yaml):
    ``hulc`` reading 1024-d CLIP RN50 language features."""
    base = HulcConfig(
        language_goal=GoalEncoderConfig(in_features=1024),
        lang_dim=1024,
    )
    return dataclasses.replace(base, **overrides).resolve()


def hulc_tactile_config(**overrides) -> HulcConfig:
    """Tactile variant (conf/.../lang_rgb_static_tactile_abs_act.yaml): the
    static camera and a frozen ResNet18 on the 6-channel tactile frames (64
    px, randomly cropped from 70), no gripper camera, world-frame actions."""
    base = HulcConfig(
        perceptual_encoder=PerceptualEncoderConfig(
            rgb_static=VisionEncoderConfig(),
            rgb_gripper=None,
            tactile=VisionEncoderConfig(kind="tactile", input_size=64, num_channels=6),
        ),
        action_decoder=ActionDecoderConfig(perceptual_emb_slice=None, gripper_control=False),
    )
    return dataclasses.replace(base, **overrides).resolve()


def gcbc_config(**overrides) -> HulcConfig:
    """GCBC (conf/model/gcbc.yaml): ``hulc``'s cameras and decoder with an
    empty plan; no plan proposal, no KL."""
    return dataclasses.replace(HulcConfig(model_kind="gcbc"), **overrides).resolve()


def hulc_state_only_config(**overrides) -> HulcConfig:
    """Proprio-only ablation (conf/datamodule/observation_space/state_only.yaml):
    no cameras, perceptual_emb the normalized 8-d proprio passthrough,
    world-frame actions, no gripper-camera slice, no CLIP loss."""
    base = HulcConfig(
        perceptual_encoder=PerceptualEncoderConfig(rgb_static=None, rgb_gripper=None, proprio=ProprioConfig()),
        action_decoder=ActionDecoderConfig(perceptual_emb_slice=None, gripper_control=False),
        use_clip_auxiliary_loss=False,
    )
    return dataclasses.replace(base, **overrides).resolve()


def fetch_state_config(**overrides) -> HulcConfig:
    """State-based GCBC on the Fetch demo's state: robot_scene proprio
    ([robot(15); scene(24)] sliced to grip xyz, width, last grip command,
    object xyz, goal xyz), no cameras, no CLIP loss."""
    base = HulcConfig(
        model_kind="gcbc",
        perceptual_encoder=PerceptualEncoderConfig(
            rgb_static=None,
            rgb_gripper=None,
            proprio=ProprioConfig(
                n_state_obs=11,
                keep_indices=((0, 3), (6, 7), (14, 18), (21, 24)),
                include_scene=True,
            ),
        ),
        action_decoder=ActionDecoderConfig(perceptual_emb_slice=None, gripper_control=False),
        use_clip_auxiliary_loss=False,
    )
    return dataclasses.replace(base, **overrides).resolve()


def fetch_vision_config(**overrides) -> HulcConfig:
    """GCBC from an 84 px static camera alone plus robot-only proprio (grip
    xyz, width, last grip command); no gripper camera, no CLIP loss."""
    base = HulcConfig(
        model_kind="gcbc",
        perceptual_encoder=PerceptualEncoderConfig(
            rgb_static=VisionEncoderConfig(input_size=84, shift_pad=4),
            rgb_gripper=None,
            proprio=ProprioConfig(n_state_obs=5, keep_indices=((0, 3), (6, 7), (14, 15))),
        ),
        action_decoder=ActionDecoderConfig(perceptual_emb_slice=None, gripper_control=False),
        use_clip_auxiliary_loss=False,
    )
    return dataclasses.replace(base, **overrides).resolve()


def hulc_deterministic_config(**overrides) -> HulcConfig:
    """Deterministic-decoder ablation (conf/model/action_decoder/deterministic.yaml):
    a tanh head on the RNN, the Huber loss."""
    base = HulcConfig(action_decoder=ActionDecoderConfig(kind="deterministic"))
    return dataclasses.replace(base, **overrides).resolve()


def _debug(cfg: HulcConfig) -> HulcConfig:
    """Tiny sizes for fast tests: small cams, small hidden dims (the JAX
    package's ``_debug``)."""
    cfg = dataclasses.replace(
        cfg,
        perceptual_encoder=PerceptualEncoderConfig(
            rgb_static=VisionEncoderConfig(input_size=64, visual_features=16, shift_pad=3),
            rgb_gripper=VisionEncoderConfig(
                kind="nature_cnn", input_size=48, visual_features=16, shift_pad=2
            ),
        )
        # camera-less (state_only) configs keep their perceptual encoder
        if cfg.perceptual_encoder.rgb_static is not None
        else cfg.perceptual_encoder,
        plan_proposal=PlanProposalConfig(hidden_size=64, latent_goal_features=8),
        plan_recognition=dataclasses.replace(
            cfg.plan_recognition,
            num_heads=4,
            encoder_hidden_size=64,
            fc_hidden_size=64,
            birnn_hidden_size=32,
            max_position_embeddings=8,
        ),
        distribution=(
            DistributionConfig(kind="discrete", category_size=4, class_size=4)
            if cfg.distribution.kind == "discrete"
            else DistributionConfig(kind="continuous", plan_features=8)
        ),
        visual_goal=GoalEncoderConfig(hidden_size=32, latent_goal_features=8),
        language_goal=dataclasses.replace(cfg.language_goal, hidden_size=32, latent_goal_features=8)
        if cfg.language_goal
        else None,
        action_decoder=dataclasses.replace(
            cfg.action_decoder,
            hidden_size=64,
            latent_goal_features=8,
            perceptual_emb_slice=(16, 32) if cfg.action_decoder.perceptual_emb_slice else None,
        ),
        proj_vis_lang_dim=8,
    )
    return cfg.resolve()


# why the loader, fit, the train CLI and the policies refuse a tactile tower
TACTILE_REFUSAL = (
    "the JAX package never loads a tactile frame: its dataset's OBS_KEYS and its loader's keys have no "
    "rgb_tactile (hulc_tpu/data/dataset.py:30, data/loader.py:311-314), example_batch makes none and its "
    "policy feeds none, so a hulc_tactile model trains and validates only on batches that carry rgb_tactile, "
    "as the JAX package's tests build them"
)


CONFIGS: Dict[str, Callable[[], HulcConfig]] = {
    "hulc": hulc_config,
    "mcil": mcil_config,
    "gcbc": gcbc_config,
    "hulc_clip_vision": hulc_clip_vision_config,
    "hulc_clip_lang": hulc_clip_lang_config,
    "hulc_depth": hulc_depth_config,
    "hulc_tactile": hulc_tactile_config,
    "hulc_deterministic": hulc_deterministic_config,
    "hulc_state_only": hulc_state_only_config,
    "fetch_state": fetch_state_config,
    "fetch_state_debug": lambda: _debug(fetch_state_config()),
    "fetch_vision": fetch_vision_config,
    "hulc_debug": lambda: _debug(hulc_config()),
    "state_only_debug": lambda: _debug(hulc_state_only_config()),
    "mcil_debug": lambda: _debug(mcil_config()),
    "gcbc_debug": lambda: _debug(gcbc_config()),
}


def get_config(name: str, **overrides) -> HulcConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown config {name!r}; have {sorted(CONFIGS)}")
    cfg = CONFIGS[name]()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides).resolve()
    return cfg


# --------------------------------------------------------------------------
# Dotted-path overrides (the reference's Hydra CLI affordance:
# `python hulc/training.py model.action_decoder.hidden_size=4096` — here
# `--set action_decoder.hidden_size=4096` on the CLIs, or apply_overrides()
# from library code)
# --------------------------------------------------------------------------


def _parse_literal(text: str):
    """CLI string -> Python value: none/true/false keywords, then
    ast.literal_eval for numbers/tuples/lists, else the raw string."""
    t = text.strip()
    low = t.lower()
    if low in ("none", "null"):
        return None
    if low == "true":
        return True
    if low == "false":
        return False
    try:
        return ast.literal_eval(t)
    except (ValueError, SyntaxError):
        return t


def _optional_inner(ftype):
    """Optional[X] -> X (when the union is exactly X | None), else None."""
    if typing.get_origin(ftype) is typing.Union:
        non_none = [a for a in typing.get_args(ftype) if a is not type(None)]
        if len(non_none) == 1:
            return non_none[0]
    return None


def _coerce(value, ftype, key: str):
    """Coerce a parsed literal to the declared field type. Ints widen to
    float; tuple fields accept lists and coerce elementwise; Optional unwraps."""
    inner = _optional_inner(ftype)
    if inner is not None:
        if value is None:
            return None
        return _coerce(value, inner, key)
    if value is None:
        raise TypeError(f"{key!r}: field of type {ftype} is not Optional; got none")
    if ftype is float:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise TypeError(f"{key!r}: expected a float, got {value!r}")
        return float(value)
    if ftype is int:
        if isinstance(value, bool) or not isinstance(value, int):
            raise TypeError(f"{key!r}: expected an int, got {value!r}")
        return value
    if ftype is bool:
        if not isinstance(value, bool):
            raise TypeError(f"{key!r}: expected true/false, got {value!r}")
        return value
    if ftype is str:
        if not isinstance(value, str):
            raise TypeError(f"{key!r}: expected a string, got {value!r}")
        return value
    if typing.get_origin(ftype) is tuple:
        if not isinstance(value, (tuple, list)):
            raise TypeError(f"{key!r}: expected a tuple like (a, b), got {value!r}")
        args = typing.get_args(ftype)
        if len(args) == 2 and args[1] is Ellipsis:  # Tuple[X, ...]
            return tuple(_coerce(v, args[0], key) for v in value)
        if args and len(args) == len(value):  # fixed-arity Tuple[A, B]
            return tuple(_coerce(v, a, key) for v, a in zip(value, args))
        return tuple(value)
    if dataclasses.is_dataclass(ftype):
        raise TypeError(
            f"{key!r} is a config node ({ftype.__name__}); set one of its fields "
            f"({key}.<field>=...), or assign 'none'/'default' if it is Optional"
        )
    return value


def _set_path(node, parts: Sequence[str], raw: str, key: str):
    hints = typing.get_type_hints(type(node))
    name = parts[0]
    field_names = [f.name for f in dataclasses.fields(node)]
    if name not in field_names:
        raise KeyError(
            f"{key!r}: {type(node).__name__} has no field {name!r}; "
            f"have {sorted(field_names)}"
        )
    ftype = hints[name]
    node_type = _optional_inner(ftype) or ftype
    if len(parts) > 1:
        child = getattr(node, name)
        if child is None:
            # descending into an off-by-default Optional node instantiates
            # its defaults (e.g. --set perceptual_encoder.proprio.n_state_obs=8
            # on a config without proprio)
            if not dataclasses.is_dataclass(node_type):
                raise TypeError(f"{key!r}: {name} is None and not a config node")
            child = node_type()
        if not dataclasses.is_dataclass(child):
            raise TypeError(f"{key!r}: {name} is a leaf field, not a config node")
        return dataclasses.replace(node, **{name: _set_path(child, parts[1:], raw, key)})
    if dataclasses.is_dataclass(node_type) and raw.strip().lower() == "default":
        return dataclasses.replace(node, **{name: node_type()})
    value = _coerce(_parse_literal(raw), ftype, key)
    return dataclasses.replace(node, **{name: value})


def apply_overrides(cfg: HulcConfig, assignments: Sequence[str]) -> HulcConfig:
    """Apply Hydra-style dotted-path overrides and re-resolve.

    Each assignment is ``path.to.field=value`` relative to the HulcConfig
    root, e.g. ``action_decoder.hidden_size=4096``,
    ``perceptual_encoder.rgb_static.input_size=112``, ``loss.kl_beta=0.1``,
    ``language_goal=none``, ``perceptual_encoder.proprio=default``,
    ``action_decoder.perceptual_emb_slice=(0,32)``. Values parse as Python
    literals (none/true/false keywords; bare words stay strings) and are
    type-checked against the declared dataclass field type.

    Like the reference's setup_input_sizes (hulc.py:155-187), resolve() runs
    AFTER all assignments, so inferred fields (``in_features``,
    ``perceptual_features``, ``plan_features``) are recomputed and cannot be
    pinned manually.
    """
    for assignment in assignments:
        key, sep, raw = assignment.partition("=")
        key = key.strip()
        if not sep or not key:
            raise ValueError(f"override {assignment!r} must look like path.to.field=value")
        cfg = _set_path(cfg, key.split("."), raw, key)
    return cfg.resolve()
