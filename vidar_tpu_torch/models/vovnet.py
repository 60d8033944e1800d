"""VoVNet backbone (port of vidar_tpu/models/vovnet.py; reference
bevformer/backbones/vovnet.py): one-shot-aggregation (OSA) blocks with
identity past the first block of a stage and eSE channel attention (hard
sigmoid), frozen BatchNorm. NHWC in and out, NCHW inside.

The max-pool between stages pads only the bottom and the right (flax's
``padding=[(0, 1), (0, 1)]``), with -inf; the stem and the first
``frozen_stages`` stages are detached, as the JAX package stops their
gradient.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device
from .layers import Conv2d
from .resnet import FrozenBN

# stage specs: (stage_ch, concat_ch, layers_per_block, blocks)
VOVNET_SPECS = {
    'V-99-eSE': dict(
        stem=(64, 64, 128),
        stage_ch=(128, 160, 192, 224),
        concat_ch=(256, 512, 768, 1024),
        block_per_stage=(1, 3, 9, 3),
        layer_per_block=5,
    ),
    'V-39-eSE': dict(
        stem=(64, 64, 128),
        stage_ch=(128, 160, 192, 224),
        concat_ch=(256, 512, 768, 1024),
        block_per_stage=(1, 1, 2, 2),
        layer_per_block=5,
    ),
}


def _conv_bn_relu(parent: nn.Module, in_ch: int, ch: int, k: int, s: int,
                  name: str, dtype, device):
    """Registers ``{name}_conv`` (k x k, stride s, padding k // 2, no bias)
    and ``{name}_bn`` on ``parent``; -> the function applying them with a
    relu."""
    conv = Conv2d(in_ch, ch, k, stride=s, padding=k // 2, use_bias=False,
                  dtype=dtype, device=device)
    bn = FrozenBN(ch, device)
    parent.add_module(f'{name}_conv', conv)
    parent.add_module(f'{name}_bn', bn)
    return lambda x: torch.relu(bn(conv(x)))


class _eSE(nn.Module):
    """Effective squeeze-excitation: the global mean through a 1x1 conv,
    a hard sigmoid, times the input."""

    def __init__(self, channels: int, dtype=None, device=None):
        super().__init__()
        self.fc = Conv2d(channels, channels, 1, dtype=dtype, device=device)

    def forward(self, x):
        att = self.fc(x.mean(dim=(2, 3), keepdim=True))
        return x * (torch.clamp(att + 3.0, 0.0, 6.0) / 6.0)


class _OSABlock(nn.Module):
    def __init__(self, in_ch: int, stage_ch: int, concat_ch: int,
                 layer_per_block: int, identity: bool = False, dtype=None,
                 device=None):
        super().__init__()
        self.identity = identity
        self.layers = []
        ch = in_ch
        for i in range(layer_per_block):
            self.layers.append(_conv_bn_relu(self, ch, stage_ch, 3, 1,
                                             f'layer{i}', dtype, device))
            ch = stage_ch
        self.concat = _conv_bn_relu(
            self, in_ch + layer_per_block * stage_ch, concat_ch, 1, 1,
            'concat', dtype, device)
        self.ese = _eSE(concat_ch, dtype=dtype, device=device)

    def forward(self, x):
        outputs = [x]
        h = x
        for layer in self.layers:
            h = layer(h)
            outputs.append(h)
        h = self.ese(self.concat(torch.cat(outputs, dim=1)))
        return h + x if self.identity else h


class VoVNet(nn.Module):
    """[N, H, W, 3] -> the NHWC maps of ``out_stages`` (stage index 0-3;
    strides 4, 8, 16, 32). Entry point: builds on the card unless the
    caller passes ``device='cpu'``."""

    def __init__(self, spec: str = 'V-99-eSE',
                 out_stages: Tuple[int, ...] = (1, 2, 3),
                 frozen_stages: int = 1, dtype=None, device='cuda'):
        super().__init__()
        device = resolve_device(device)
        cfg = VOVNET_SPECS[spec]
        self.out_stages = tuple(out_stages)
        self.frozen_stages = frozen_stages
        s1, s2, s3 = cfg['stem']
        self.stem = [
            _conv_bn_relu(self, 3, s1, 3, 2, 'stem1', dtype, device),
            _conv_bn_relu(self, s1, s2, 3, 1, 'stem2', dtype, device),
            _conv_bn_relu(self, s2, s3, 3, 2, 'stem3', dtype, device)]
        self.stages = []
        in_ch = s3
        for stage in range(4):
            names = []
            for b in range(cfg['block_per_stage'][stage]):
                name = f'stage{stage + 2}_block{b}'
                self.add_module(name, _OSABlock(
                    in_ch, cfg['stage_ch'][stage], cfg['concat_ch'][stage],
                    cfg['layer_per_block'], identity=(b > 0), dtype=dtype,
                    device=device))
                in_ch = cfg['concat_ch'][stage]
                names.append(name)
            self.stages.append(names)

    def forward(self, x):
        h = x.permute(0, 3, 1, 2)
        for layer in self.stem:
            h = layer(h)
        if self.frozen_stages >= 0:
            h = h.detach()
        outs = []
        for stage, names in enumerate(self.stages):
            if stage > 0:  # the first OSA stage keeps the stem's stride
                h = F.max_pool2d(F.pad(h, (0, 1, 0, 1), value=-math.inf),
                                 3, stride=2)
            for name in names:
                h = getattr(self, name)(h)
            if stage + 1 <= self.frozen_stages:
                h = h.detach()
            if stage in self.out_stages:
                outs.append(h.permute(0, 2, 3, 1))
        return outs
