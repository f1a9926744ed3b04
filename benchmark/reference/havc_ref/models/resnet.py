"""Frozen copy of the port's ``havc_tpu_torch/models/resnet.py`` (the benchmark's plain
reference).

torchvision-style ResNet bodies (NCHW, inference form).

Port of ``havc_tpu.models.resnet``: the DeOldify encoder body and
ColorMNet's key and value encoder bodies.  ``ResNetBody.forward`` returns
the stage activations ``(relu, layer1, ..., layer<num_stages>)`` at
strides 2/4/8/16/32; ColorMNet keeps three stages and its value encoder
feeds a 5-channel stem.  Submodule names are the flax ones (``conv1``,
``bn1``, ``layer3_block22.down_conv``, ...).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNormInference

__all__ = ["ResNetBody", "RESNET_CONFIGS"]

RESNET_CONFIGS = {
    # dev/test scale (not a published geometry)
    "nano": dict(block="basic", layers=(1, 1, 1, 1), stem_features=16),
    "resnet18": dict(block="basic", layers=(2, 2, 2, 2)),
    "resnet34": dict(block="basic", layers=(3, 4, 6, 3)),
    "resnet50": dict(block="bottleneck", layers=(3, 4, 6, 3)),
    "resnet101": dict(block="bottleneck", layers=(3, 4, 23, 3)),
}


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, features, 3, stride, 1, bias=False)
        self.bn1 = BatchNormInference(features)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn2 = BatchNormInference(features)
        if downsample:
            self.down_conv = nn.Conv2d(cin, features, 1, stride, 0, bias=False)
            self.down_bn = BatchNormInference(features)
        self.downsample = downsample

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = self.down_bn(self.down_conv(x)) if self.downsample else x
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        out = features * 4
        self.conv1 = nn.Conv2d(cin, features, 1, 1, 0, bias=False)
        self.bn1 = BatchNormInference(features)
        self.conv2 = nn.Conv2d(features, features, 3, stride, 1, bias=False)
        self.bn2 = BatchNormInference(features)
        self.conv3 = nn.Conv2d(features, out, 1, 1, 0, bias=False)
        self.bn3 = BatchNormInference(out)
        if downsample:
            self.down_conv = nn.Conv2d(cin, out, 1, stride, 0, bias=False)
            self.down_bn = BatchNormInference(out)
        self.downsample = downsample

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = self.down_bn(self.down_conv(x)) if self.downsample else x
        return F.relu(out + identity)


class ResNetBody(nn.Module):
    """Headless ResNet returning all stage activations."""

    def __init__(self, block: str = "bottleneck",
                 layers: Sequence[int] = (3, 4, 23, 3),
                 stem_features: int = 64, num_stages: int = 4,
                 in_features: int = 3):
        super().__init__()
        self.conv1 = nn.Conv2d(in_features, stem_features, 7, 2, 3, bias=False)
        self.bn1 = BatchNormInference(stem_features)
        Block = BasicBlock if block == "basic" else Bottleneck
        self.stages = []
        in_ch = stem_features
        for stage, n_blocks in enumerate(layers[:num_stages]):
            width = stem_features * (2 ** stage)
            stride = 1 if stage == 0 else 2
            out_ch = width * Block.expansion
            names = []
            for b in range(n_blocks):
                name = f"layer{stage + 1}_block{b}"
                self.add_module(name, Block(
                    in_ch if b == 0 else out_ch, width,
                    stride=stride if b == 0 else 1,
                    downsample=(b == 0 and (stride != 1 or in_ch != out_ch)),
                ))
                names.append(name)
            in_ch = out_ch
            self.stages.append(names)
        self.out_channels = in_ch

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        relu_out = F.relu(self.bn1(self.conv1(x)))  # stride 2
        x = F.max_pool2d(relu_out, 3, stride=2, padding=1)
        feats = []
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            feats.append(x)
        return (relu_out, *feats)

    @staticmethod
    def from_config(name: str, num_stages: int = 4, in_features: int = 3) -> "ResNetBody":
        return ResNetBody(**RESNET_CONFIGS[name], num_stages=num_stages,
                          in_features=in_features)
