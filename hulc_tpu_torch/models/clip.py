"""CLIP's image towers, frozen (port of hulc_tpu/models/clip.py:29-296, the
image side), NCHW.

* ``ModifiedResNet`` (RN50): a three-convolution stem and an average pool,
  bottlenecks that downsample by average pooling, and ``AttentionPool2d``
  (one query, the mean of the map, over the 7 x 7 + 1 positions; the mean
  in fp32, the products in the compute dtype, the softmax in fp32).
* ``CLIPVisionTransformer`` (ViT-B/32, ViT-B/16): a patch convolution, the
  class token, pre-LN ``ResidualAttentionBlock``s (flax's
  ``MultiHeadDotProductAttention`` with ``force_fp32_for_softmax``, its
  LayerNorms in fp32, QuickGELU), the class token's LayerNorm and the
  projection, in fp32.
* ``FrozenBatchNorm``: JAX's formula, ``inv = rsqrt(var + 1e-5) * scale``,
  then ``x * inv + (bias - mean * inv)`` with both coefficients made in
  fp32 and cast to the compute dtype; not ``F.batch_norm``, which rounds
  otherwise. Its four tensors are parameters, as they are in JAX (the
  optimizer sees them: AdamW decays them).
* ``VisionClip``: the frozen tower and a trainable two-layer head (512
  hidden for RN50, 256 for a ViT), as the reference's ``vision_clip.py``.

The towers hold OpenAI CLIP's ``visual.*`` state_dict names (``VisionClip``
keeps its tower under ``visual``), so a checkpoint's visual tensors load
with ``load_state_dict`` (less BatchNorm's ``num_batches_tracked``
counters, which no formula reads), and ``hulc_tpu.models.clip.
convert_openai_clip`` reads the port's tensors. Convolutions are flax's:
symmetric padding 1 for the 3 x 3 ones, ``VALID`` patches; the 2 x 2
average pools with stride 2 are flax's ``nn.avg_pool`` (``avg_pool``). In bf16 (``dtype``) every convolution and dense layer
computes as its flax counterpart with ``dtype=bfloat16`` (``models.layers``).
The tower is frozen as JAX freezes it (``stop_gradient``): it runs under
``torch.no_grad`` and its parameters do not require gradients, so nothing
of it is saved for the backward; the trainer gives them zero gradients,
which is what JAX's optimizer steps (``frozen_parameters``). The text tower
waits for ROADMAP A.6, with the tokenizer it needs.
"""

from __future__ import annotations

import collections
import math
from typing import Any, Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from hulc_tpu_torch.models.layers import Linear, cast, lowp_product
from hulc_tpu_torch.ops.image_ops import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD  # noqa: F401 (CLIP's normalize, re-exported)

CLIP_CONFIGS: Dict[str, Dict[str, Any]] = {
    "RN50": dict(image="resnet", embed_dim=1024),
    "ViT-B/32": dict(image="vit", embed_dim=512, patch_size=32),
    "ViT-B/16": dict(image="vit", embed_dim=512, patch_size=16),
}


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(1.702 x)`` as XLA computes JAX's: the constant in x's
    dtype (1.703125 in bf16, a weakly typed scalar) and the sigmoid as
    ``1 / (1 + exp(-z))``, each step rounded to x's dtype (``torch.sigmoid``
    rounds once, which put a quarter of a bf16 layer's outputs a step off)."""
    z = float(torch.tensor(1.702, dtype=x.dtype)) * x
    return x * torch.reciprocal(1 + torch.exp(-z))


class QuickGELU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return quick_gelu(x)


class Conv(nn.Conv2d):
    """flax's ``nn.Conv(use_bias=False, dtype=)``: symmetric ``padding``,
    computed in ``dtype`` (``models.layers.lowp_product``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1, padding: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, padding=padding, bias=False)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, weight = cast(self.compute_dtype, x, self.weight)
        if self.compute_dtype == torch.float32:
            return F.conv2d(x, weight, None, self.stride, self.padding)
        return lowp_product(F.conv2d, x, weight, stride=self.stride, padding=self.padding)


class FrozenBatchNorm(nn.Module):
    """BatchNorm with stored statistics (JAX's ``FrozenBatchNorm``), over
    the channel axis of an NCHW map, in the map's dtype."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.running_mean = nn.Parameter(torch.zeros(features))
        self.running_var = nn.Parameter(torch.ones(features))

    def init_params_(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.fill_(0.0)
        self.running_mean.fill_(0.0)
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + 1e-5) * self.weight
        shift = self.bias - self.running_mean * inv
        return x * inv.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


def avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """flax's ``nn.avg_pool(x, (k, k), (k, k))`` of an NCHW map: each
    window's taps added one at a time in row-major order in the map's
    dtype, then divided by k * k. A bf16 map rounds each partial sum to
    bf16, as XLA's ``reduce_window`` does; ``F.avg_pool2d`` sums in fp32
    and rounds once, which put a third of a bf16 pool's outputs one step
    off JAX's."""
    n, c, h, w = x.shape
    taps = x[:, :, :h - h % k, :w - w % k].reshape(n, c, h // k, k, w // k, k)
    out = taps[:, :, :, 0, :, 0]
    for i in range(k):
        for j in range(k):
            if i or j:
                out = out + taps[:, :, :, i, :, j]
    return out / (k * k)


def _einsum(equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` of two operands of one dtype; a bf16 product
    accumulated in fp32 and rounded once (``models.layers.lowp_product``)."""
    if a.dtype == torch.float32 or a.device.type != "cpu":
        return torch.einsum(equation, a, b)
    return torch.einsum(equation, a.float(), b.float()).to(a.dtype)


def _layer_norm_fp32(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax's ``LayerNorm(dtype=float32)``: statistics and output in fp32."""
    return ln(x.float())


class CLIPAttention(nn.Module):
    """flax's ``MultiHeadDotProductAttention(dtype=, force_fp32_for_softmax=
    True)`` over one sequence, under ``nn.MultiheadAttention``'s names
    (``in_proj_weight`` (3d, d) holding q, k, v; ``out_proj``). The
    projections and the scores are in the compute dtype; in bf16 the
    softmax and the weighted sum of the values are fp32, which the output
    projection rounds to bf16."""

    def __init__(self, d_model: int, n_head: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_head, self.dtype = n_head, dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d_model))
        self.out_proj = Linear(d_model, d_model, dtype)

    def init_params_(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.in_proj_weight.shape[1])
        self.in_proj_weight.uniform_(-bound, bound, generator=generator)
        self.in_proj_bias.fill_(0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        hd = d // self.n_head
        dt = self.dtype
        w, bias = cast(dt, self.in_proj_weight, self.in_proj_bias)
        x = cast(dt, x)[0]

        def proj(i):
            y = F.linear(x, w[i * d:(i + 1) * d]) if dt == torch.float32 else lowp_product(
                F.linear, x, w[i * d:(i + 1) * d])
            return (y + bias[i * d:(i + 1) * d]).reshape(b, n, self.n_head, hd)

        q, k, v = proj(0), proj(1), proj(2)
        q = q / torch.tensor(math.sqrt(hd), dtype=dt)
        scores = _einsum("bqhd,bkhd->bhqk", q, k)
        if dt == torch.float32:
            out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)
        else:
            out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores.float(), dim=-1), v.float())
        return self.out_proj(out.reshape(b, n, d))


class ResidualAttentionBlock(nn.Module):
    """Pre-LN CLIP transformer block with QuickGELU, non-causal."""

    def __init__(self, d_model: int, n_head: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.ln_1 = nn.LayerNorm(d_model, eps=1e-5)
        self.attn = CLIPAttention(d_model, n_head, dtype)
        self.ln_2 = nn.LayerNorm(d_model, eps=1e-5)
        self.mlp = nn.Sequential(collections.OrderedDict(
            c_fc=Linear(d_model, 4 * d_model, dtype), gelu=QuickGELU(), c_proj=Linear(4 * d_model, d_model, dtype)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        x = x + self.attn(_layer_norm_fp32(self.ln_1, x)).to(self.dtype)
        return x + self.mlp(_layer_norm_fp32(self.ln_2, x))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.resblocks = nn.Sequential(*(ResidualAttentionBlock(width, heads, dtype) for _ in range(layers)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resblocks(x)


class CLIPVisionTransformer(nn.Module):
    """ViT image tower: (N, 3, R, R) normalized frames -> (N, output_dim) fp32."""

    def __init__(self, input_resolution: int = 224, patch_size: int = 32, width: int = 768, layers: int = 12,
                 heads: int = 12, output_dim: int = 512, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.width, self.dtype, self.output_dim = width, dtype, output_dim
        self.conv1 = Conv(3, width, patch_size, stride=patch_size, dtype=dtype)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(torch.empty((input_resolution // patch_size) ** 2 + 1, width))
        self.ln_pre = nn.LayerNorm(width, eps=1e-5)
        self.transformer = Transformer(width, layers, heads, dtype)
        self.ln_post = nn.LayerNorm(width, eps=1e-5)
        self.proj = nn.Parameter(torch.empty(width, output_dim))

    def init_params_(self, generator: torch.Generator) -> None:
        self.class_embedding.normal_(0.0, 0.02, generator=generator)
        self.positional_embedding.normal_(0.0, 0.01, generator=generator)
        self.proj.normal_(0.0, 0.02, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x.to(self.dtype))
        b = x.shape[0]
        x = x.flatten(2).transpose(1, 2)  # (N, grid ** 2, width), row-major as JAX's NHWC reshape
        cls = self.class_embedding.to(x.dtype).expand(b, 1, self.width)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(x.dtype)
        x = self.transformer(_layer_norm_fp32(self.ln_pre, x))
        x = _layer_norm_fp32(self.ln_post, x[:, 0])
        return x.float() @ self.proj


class Bottleneck(nn.Module):
    """CLIP's modified-ResNet bottleneck: an average pool where torchvision's
    strides; the shortcut pooled, then a 1 x 1 convolution, where the shape
    changes (``downsample``: "-1" the pool, "0" the conv, "1" the norm, as
    OpenAI's checkpoint names them)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride = stride
        self.conv1 = Conv(inplanes, planes, 1, dtype=dtype)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = Conv(planes, planes, 3, padding=1, dtype=dtype)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = Conv(planes, planes * 4, 1, dtype=dtype)
        self.bn3 = FrozenBatchNorm(planes * 4)
        self.downsample = None
        if stride > 1 or inplanes != planes * 4:
            self.downsample = nn.Sequential(collections.OrderedDict([
                ("0", Conv(inplanes, planes * 4, 1, dtype=dtype)), ("1", FrozenBatchNorm(planes * 4))]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        if self.stride > 1:
            out = avg_pool(out, self.stride)
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(avg_pool(x, self.stride) if self.stride > 1 else x)
        else:
            identity = x
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """One query (the map's fp32 mean) over the map's positions and itself,
    ``num_heads`` heads; the products in the compute dtype, the softmax and
    ``c_proj`` in fp32."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int, output_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.positional_embedding = nn.Parameter(torch.empty(spacial_dim ** 2 + 1, embed_dim))
        self.k_proj = Linear(embed_dim, embed_dim, dtype)
        self.q_proj = Linear(embed_dim, embed_dim, dtype)
        self.v_proj = Linear(embed_dim, embed_dim, dtype)
        self.c_proj = Linear(embed_dim, output_dim, torch.float32)

    def init_params_(self, generator: torch.Generator) -> None:
        self.positional_embedding.normal_(0.0, 0.01, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        x = x.flatten(2).transpose(1, 2)  # (N, HW, C)
        mean = x.float().mean(dim=1, keepdim=True)
        x = torch.cat([mean.to(x.dtype), x], dim=1) + self.positional_embedding.to(x.dtype)
        hd = self.k_proj.out_features // self.num_heads

        def split(t):
            return t.reshape(t.shape[0], t.shape[1], self.num_heads, hd)

        q, k, v = split(self.q_proj(x[:, :1])), split(self.k_proj(x)), split(self.v_proj(x))
        attn = torch.softmax(_einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(hd), dim=-1).to(v.dtype)
        out = _einsum("bhqk,bkhd->bqhd", attn, v)
        return self.c_proj(out.reshape(b, 1, -1))[:, 0]


class ModifiedResNet(nn.Module):
    """CLIP's RN50 image tower: (N, 3, R, R) normalized frames -> (N, output_dim) fp32."""

    def __init__(self, layers: Tuple[int, ...] = (3, 4, 6, 3), width: int = 64, output_dim: int = 1024,
                 heads: int = 32, input_resolution: int = 224, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.output_dim = dtype, output_dim
        self.conv1 = Conv(3, width // 2, 3, stride=2, padding=1, dtype=dtype)
        self.bn1 = FrozenBatchNorm(width // 2)
        self.conv2 = Conv(width // 2, width // 2, 3, padding=1, dtype=dtype)
        self.bn2 = FrozenBatchNorm(width // 2)
        self.conv3 = Conv(width // 2, width, 3, padding=1, dtype=dtype)
        self.bn3 = FrozenBatchNorm(width)
        inplanes = width
        for li, blocks in enumerate(layers):
            planes = width * 2 ** li
            stage = []
            for bi in range(blocks):
                stage.append(Bottleneck(inplanes, planes, (1 if li == 0 else 2) if bi == 0 else 1, dtype))
                inplanes = planes * 4
            setattr(self, f"layer{li + 1}", nn.Sequential(*stage))
        self.num_layers = len(layers)
        self.attnpool = AttentionPool2d(input_resolution // 32, width * 32, heads, output_dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = avg_pool(x, 2)
        for li in range(self.num_layers):
            x = getattr(self, f"layer{li + 1}")(x)
        return self.attnpool(x)


def make_image_encoder(model_name: str = "RN50", dtype: torch.dtype = torch.float32) -> nn.Module:
    cfg = CLIP_CONFIGS[model_name]
    if cfg["image"] == "resnet":
        return ModifiedResNet(output_dim=cfg["embed_dim"], dtype=dtype)
    return CLIPVisionTransformer(patch_size=cfg["patch_size"], output_dim=cfg["embed_dim"], dtype=dtype)


class VisionClip(nn.Module):
    """Frozen CLIP image features and two trainable dense layers
    (``vision_clip.py``): (N, 3, 224, 224) CLIP-normalized frames ->
    (N, visual_features) in the compute dtype."""

    def __init__(self, visual_features: int = 64, model_name: str = "RN50", dtype: torch.dtype = torch.float32):
        super().__init__()
        if model_name not in CLIP_CONFIGS:
            raise KeyError(f"unknown CLIP model {model_name!r}; have {sorted(CLIP_CONFIGS)}")
        self.visual = make_image_encoder(model_name, dtype)
        self.visual.requires_grad_(False)
        hidden = 512 if "RN50" in model_name else 256
        self.fc1 = nn.Sequential(Linear(self.visual.output_dim, hidden, dtype), nn.ReLU())
        self.fc2 = Linear(hidden, visual_features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            feats = self.visual(x)
        return self.fc2(self.fc1(feats))

    def frozen_parameters(self):
        return self.visual.parameters()
