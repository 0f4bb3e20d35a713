"""The tactile encoder (port of hulc_tpu/models/tactile.py:21-128), NCHW.

A frozen ResNet18 up to its global average pool (``ResNet18Features``: a
7 x 7 stride-2 convolution, ``FrozenBatchNorm``, a 3 x 3 stride-2 max pool
padded with -inf as flax pads it, four stages of two ``BasicBlock``s, the
mean over the map in fp32) runs on the left (channels 0:3) and the right
(3:6) tactile frame with shared weights; the two 512-d features are
concatenated before the trainable ``fc1`` (512, relu) and ``fc2``. The
backbone holds torchvision's ``resnet18`` state_dict names
(``layer2.0.downsample.0`` the 1 x 1 convolution, ``.1`` its norm), so
``hulc_tpu.models.tactile.convert_torchvision_resnet18`` reads the port's
tensors and a torchvision checkpoint loads less its ``fc`` and its
``num_batches_tracked`` counters. As in ``models.clip``, the frozen
backbone runs under ``torch.no_grad`` with parameters that do not require
gradients, and the trainer gives them zero gradients.
"""

from __future__ import annotations

import collections

import torch
import torch.nn as nn
import torch.nn.functional as F

from hulc_tpu_torch.models.clip import Conv, FrozenBatchNorm
from hulc_tpu_torch.models.layers import Linear


class BasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv(inplanes, planes, 3, stride=stride, padding=1, dtype=dtype)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = Conv(planes, planes, 3, padding=1, dtype=dtype)
        self.bn2 = FrozenBatchNorm(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(collections.OrderedDict([
                ("0", Conv(inplanes, planes, 1, stride=stride, dtype=dtype)), ("1", FrozenBatchNorm(planes))]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet18Features(nn.Module):
    """ResNet18 up to the global average pool: (N, 3, H, W) -> (N, 512) fp32."""

    def __init__(self, in_conv_features: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv(3, in_conv_features, 7, stride=2, padding=3, dtype=dtype)
        self.bn1 = FrozenBatchNorm(in_conv_features)
        inplanes = in_conv_features
        for li, (planes, stride) in enumerate(((64, 1), (128, 2), (256, 2), (512, 2))):
            blocks = [BasicBlock(inplanes, planes, stride, dtype), BasicBlock(planes, planes, 1, dtype)]
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
            inplanes = planes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x.to(self.dtype))))
        x = F.max_pool2d(x, 3, 2, padding=1)  # implicit -inf padding, as flax's max_pool
        for li in range(4):
            x = getattr(self, f"layer{li + 1}")(x)
        return x.float().mean(dim=(2, 3))


class TactileEncoder(nn.Module):
    """(N, 6, 64, 64) normalized tactile frames -> (N, visual_features) in
    the compute dtype."""

    def __init__(self, visual_features: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.backbone = ResNet18Features(dtype=dtype)
        self.backbone.requires_grad_(False)
        self.fc1 = nn.Sequential(Linear(1024, 512, dtype), nn.ReLU())
        self.fc2 = Linear(512, visual_features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            feats = torch.cat([self.backbone(x[:, :3]), self.backbone(x[:, 3:6])], dim=-1)
        return self.fc2(self.fc1(feats))

    def frozen_parameters(self):
        return self.backbone.parameters()
