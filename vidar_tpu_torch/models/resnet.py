"""Caffe-style ResNet with frozen BN and DCNv2 stages (port of
vidar_tpu/models/resnet.py).

Public layout stays NHWC as in the JAX package: ``ResNet`` takes
[N, H, W, 3] and returns NHWC maps. Inside, tensors are NCHW in PyTorch's
channels-last memory format, so the switches between the two layouts at the
edges and around the deformable conv are views, not copies.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.dcn import dcn_conv, dcn_sample
from .layers import Conv2d

ARCH_SETTINGS = {
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}


class FrozenBN(nn.Module):
    """Frozen BatchNorm folded to y = x * scale + bias (buffers)."""

    def __init__(self, features: int, device=None):
        super().__init__()
        self.register_buffer('scale', torch.ones(features, device=device))
        self.register_buffer('bias', torch.zeros(features, device=device))

    def forward(self, x):  # NCHW
        return (x * self.scale.to(x.dtype).view(1, -1, 1, 1) +
                self.bias.to(x.dtype).view(1, -1, 1, 1))


class DeformConv2d(nn.Module):
    """Modulated deformable conv (DCNv2), 3x3, stride 1, dilation 1,
    deform_groups=1 (the only form the bottlenecks use).

    ``conv_offset`` predicts mmcv's [o1_y, o1_x, ..., o9_y, o9_x, m1..m9]
    channels (sigmoid on the masks); ``kernel`` is [9*C, CO] with rows
    ordered (ky, kx, cin). A bf16 input runs the fused ``dcn_conv`` (K2 on
    the card), an f32 input ``dcn_sample`` (K9) and a matrix product, as the
    JAX module splits on its dtype.
    """

    def __init__(self, in_ch: int, features: int, dtype=None, device=None):
        super().__init__()
        self.conv_offset = Conv2d(in_ch, 27, 3, padding=1, dtype=dtype,
                                  device=device)
        self.kernel = nn.Parameter(torch.empty(9 * in_ch, features,
                                               device=device))

    def forward(self, x):  # NCHW
        b, _, h, w = x.shape
        dev = x.device
        off_mask = self.conv_offset(x).permute(0, 2, 3, 1)    # [b, h, w, 27]
        off = off_mask[..., :18].float().reshape(b, h, w, 9, 2)
        mask = torch.sigmoid(off_mask[..., 18:].float())
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=dev),
            torch.arange(w, dtype=torch.float32, device=dev), indexing='ij')
        # tap base offsets k*d - d with dilation d = 1
        taps = torch.arange(3, dtype=torch.float32, device=dev) - 1.0
        ky, kx = torch.meshgrid(taps, taps, indexing='ij')
        sy = (gy[None, :, :, None] + ky.reshape(-1) + off[..., 0]).reshape(
            b, h * w, 9)
        sx = (gx[None, :, :, None] + kx.reshape(-1) + off[..., 1]).reshape(
            b, h * w, 9)
        x_nhwc, mask = x.permute(0, 2, 3, 1), mask.reshape(b, h * w, 9)
        if x.dtype == torch.bfloat16:
            out = dcn_conv(x_nhwc, sx, sy, mask, self.kernel.to(x.dtype))
        elif x.dtype == torch.float32:
            # the taps, then the conv product outside the kernel, in f32
            # (vidar_tpu/models/resnet.py:137-164); the [b, h*w, 9*C] taps
            # live only until the product is taken
            out = torch.matmul(dcn_sample(x_nhwc, sx, sy, mask).reshape(
                b, h * w, -1), self.kernel)
        else:
            raise TypeError(f'DeformConv2d: no deformable conv for {x.dtype}'
                            f' (bfloat16 runs K2, float32 K9)')
        return out.to(x.dtype).reshape(b, h, w, -1).permute(0, 3, 1, 2)


class Bottleneck(nn.Module):
    """Caffe-style bottleneck: stride on conv1; optional DCN on conv2."""

    def __init__(self, in_ch: int, mid_channels: int, stride: int = 1,
                 with_downsample: bool = False, with_dcn: bool = False,
                 dtype=None, device=None):
        super().__init__()
        out_ch = mid_channels * 4
        kw = dict(dtype=dtype, device=device)
        self.conv1 = Conv2d(in_ch, mid_channels, 1, stride=stride,
                            use_bias=False, **kw)
        self.bn1 = FrozenBN(mid_channels, device)
        if with_dcn:
            self.conv2 = DeformConv2d(mid_channels, mid_channels, **kw)
        else:
            self.conv2 = Conv2d(mid_channels, mid_channels, 3, padding=1,
                                use_bias=False, **kw)
        self.bn2 = FrozenBN(mid_channels, device)
        self.conv3 = Conv2d(mid_channels, out_ch, 1, use_bias=False, **kw)
        self.bn3 = FrozenBN(out_ch, device)
        if with_downsample:
            self.downsample_conv = Conv2d(in_ch, out_ch, 1, stride=stride,
                                          use_bias=False, **kw)
            self.downsample_bn = FrozenBN(out_ch, device)
        else:
            self.downsample_conv = None

    def forward(self, x):
        h = torch.relu(self.bn1(self.conv1(x)))
        h = torch.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        identity = x
        if self.downsample_conv is not None:
            identity = self.downsample_bn(self.downsample_conv(x))
        return torch.relu(h + identity)


class ResNet(nn.Module):
    """ResNet returning the NHWC maps of stages 2-4 (out_indices (1, 2, 3)),
    stage strides (1, 2, 2, 2). ``frozen_stages`` cuts the gradient after
    the stem (when >= 0) and after each of the first ``frozen_stages``
    stages, as the JAX package's ``stop_gradient``s do
    (vidar_tpu/models/resnet.py:246-274); the frozen weights keep their
    parameters and receive no gradient."""

    def __init__(self, depth: int = 101,
                 stage_with_dcn: Tuple[bool, ...] = (False, False, True,
                                                     True),
                 frozen_stages: int = 1, dtype=None, device=None):
        super().__init__()
        self.frozen_stages = frozen_stages
        kw = dict(dtype=dtype, device=device)
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, use_bias=False,
                            **kw)
        self.bn1 = FrozenBN(64, device)
        self.stages = []
        in_ch, mid = 64, 64
        for stage, num_blocks in enumerate(ARCH_SETTINGS[depth]):
            names = []
            for i in range(num_blocks):
                name = f'layer{stage + 1}_{i}'
                self.add_module(name, Bottleneck(
                    in_ch, mid, stride=2 if i == 0 and stage > 0 else 1,
                    with_downsample=(i == 0),
                    with_dcn=stage_with_dcn[stage], **kw))
                names.append(name)
                in_ch = mid * 4
            self.stages.append(names)
            mid *= 2

    def forward(self, x):
        """x: [N, H, W, 3] -> list of NHWC maps."""
        h = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        h = torch.relu(self.bn1(self.conv1(h)))
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        if self.frozen_stages >= 0:
            h = h.detach()
        outs = []
        for stage, names in enumerate(self.stages):
            for name in names:
                h = getattr(self, name)(h)
            if stage + 1 <= self.frozen_stages:
                h = h.detach()
            if stage > 0:
                outs.append(h.permute(0, 2, 3, 1))
        return outs
