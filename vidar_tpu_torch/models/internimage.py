"""InternImage backbone (port of vidar_tpu/models/internimage.py; reference
bevformer/backbones/internimage.py): a stem of two stride-2 convs, then 4
stages of DCNv3 blocks with channel doubling between them, LayerNorm
everywhere, layer-scale residuals and GELU MLPs; multi-scale NHWC outputs
for an FPN.

Channel-last throughout, as the linears that dominate it want; the few
convs (stem, downsampling, the depthwise offset branch) switch to NCHW
around themselves with flax's ``SAME`` padding. DCNv3's sampling core is
``ops/dcnv3.dcnv3_core``: K1 and K5 on the card. Block modules keep the
flax names ``levels_{i}_blocks_{j}``, which ``layer_decay_lr_mult`` reads.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.dcnv3 import dcnv3_core
from .layers import Conv2d, LayerNorm, TorchLinear, same_padding


def _gelu(x):
    """flax's ``nn.gelu`` (tanh approximation)."""
    return F.gelu(x, approximate='tanh')


def _conv_nhwc(conv: Conv2d, x, kernel: int, stride: int):
    """An NHWC map through an NCHW conv with flax's SAME padding."""
    y = conv(same_padding(x.permute(0, 3, 1, 2), kernel, stride))
    return y.permute(0, 2, 3, 1)


class DCNv3Module(nn.Module):
    """value_proj -> depthwise-conv offset and mask branch -> dcnv3_core
    -> output_proj (reference ops_dcnv3/modules/dcnv3.py DCNv3)."""

    def __init__(self, channels: int, groups: int,
                 kernel: Tuple[int, int] = (3, 3), offset_scale: float = 1.0,
                 dtype=None, device=None):
        super().__init__()
        self.groups, self.kernel = groups, tuple(kernel)
        self.offset_scale = offset_scale
        k = self.kernel[0] * self.kernel[1]
        self.value_proj = TorchLinear(channels, channels, device=device)
        self.dw_conv = Conv2d(channels, channels, self.kernel[0],
                              groups=channels, dtype=dtype, device=device)
        self.dw_norm = LayerNorm(channels, device)
        self.offset = TorchLinear(channels, groups * k * 2, device=device)
        self.mask = TorchLinear(channels, groups * k, device=device)
        self.output_proj = TorchLinear(channels, channels, device=device)

    def forward(self, x):
        """x [B, H, W, C] -> [B, H, W, C]."""
        v = self.value_proj(x)
        q = _gelu(self.dw_norm(_conv_nhwc(self.dw_conv, x, self.kernel[0],
                                          1)))
        out = dcnv3_core(v, self.offset(q) * self.offset_scale, self.mask(q),
                         kernel=self.kernel, groups=self.groups)
        return self.output_proj(out.to(x.dtype))


class InternImageBlock(nn.Module):
    """DCNv3 and MLP residual branches, each with a LayerNorm before
    (``post_norm`` False) or after it, and a layer scale ``gamma1`` /
    ``gamma2`` (none where ``layer_scale`` is None)."""

    def __init__(self, channels: int, groups: int, mlp_ratio: float = 4.0,
                 layer_scale: Optional[float] = 1.0, post_norm: bool = False,
                 dtype=None, device=None):
        super().__init__()
        self.post_norm = post_norm
        self.dcn = DCNv3Module(channels, groups, dtype=dtype, device=device)
        self.norm1 = LayerNorm(channels, device)
        self.norm2 = LayerNorm(channels, device)
        hidden = int(channels * mlp_ratio)
        self.mlp_fc1 = TorchLinear(channels, hidden, device=device)
        self.mlp_fc2 = TorchLinear(hidden, channels, device=device)
        if layer_scale is None:
            self.gamma1 = self.gamma2 = None
        else:
            self.gamma1 = nn.Parameter(torch.full((channels,), layer_scale,
                                                  device=device))
            self.gamma2 = nn.Parameter(torch.full((channels,), layer_scale,
                                                  device=device))

    @staticmethod
    def _scaled(gamma, y):
        return y if gamma is None else y * gamma

    def _mlp(self, x):
        return self.mlp_fc2(_gelu(self.mlp_fc1(x)))

    def forward(self, x):
        if self.post_norm:
            x = x + self._scaled(self.gamma1, self.norm1(self.dcn(x)))
            return x + self._scaled(self.gamma2, self.norm2(self._mlp(x)))
        x = x + self._scaled(self.gamma1, self.dcn(self.norm1(x)))
        return x + self._scaled(self.gamma2, self._mlp(self.norm2(x)))


class InternImage(nn.Module):
    """4-stage DCNv3 backbone; the defaults are InternImage-T (channels 64,
    depths (4, 4, 18, 4), groups (4, 8, 16, 32)). [N, H, W, 3] -> the NHWC
    maps of ``out_indices`` (strides 8, 16, 32 for (1, 2, 3)). Entry point:
    builds on the card unless the caller passes ``device='cpu'``."""

    def __init__(self, channels: int = 64,
                 depths: Tuple[int, ...] = (4, 4, 18, 4),
                 groups: Tuple[int, ...] = (4, 8, 16, 32),
                 mlp_ratio: float = 4.0, layer_scale: Optional[float] = 1.0,
                 post_norm: bool = False,
                 out_indices: Tuple[int, ...] = (1, 2, 3), dtype=None,
                 device='cuda'):
        super().__init__()
        device = resolve_device(device)
        self.depths = tuple(depths)
        self.out_indices = tuple(out_indices)
        kw = dict(dtype=dtype, device=device)
        self.stem_conv1 = Conv2d(3, channels // 2, 3, stride=2, **kw)
        self.stem_norm1 = LayerNorm(channels // 2, device)
        self.stem_conv2 = Conv2d(channels // 2, channels, 3, stride=2, **kw)
        self.stem_norm2 = LayerNorm(channels, device)
        ch = channels
        for i, depth in enumerate(self.depths):
            for j in range(depth):
                self.add_module(f'levels_{i}_blocks_{j}', InternImageBlock(
                    ch, groups[i], mlp_ratio=mlp_ratio,
                    layer_scale=layer_scale, post_norm=post_norm, **kw))
            if i in self.out_indices:
                self.add_module(f'out_norm{i}', LayerNorm(ch, device))
            if i < len(self.depths) - 1:
                self.add_module(f'downsample{i}_conv',
                                Conv2d(ch, 2 * ch, 3, stride=2, **kw))
                self.add_module(f'downsample{i}_norm',
                                LayerNorm(2 * ch, device))
                ch *= 2

    def forward(self, x):
        x = _gelu(self.stem_norm1(_conv_nhwc(self.stem_conv1, x, 3, 2)))
        x = self.stem_norm2(_conv_nhwc(self.stem_conv2, x, 3, 2))
        outs = []
        for i, depth in enumerate(self.depths):
            for j in range(depth):
                x = getattr(self, f'levels_{i}_blocks_{j}')(x)
            if i in self.out_indices:
                outs.append(getattr(self, f'out_norm{i}')(x))
            if i < len(self.depths) - 1:
                x = getattr(self, f'downsample{i}_norm')(_conv_nhwc(
                    getattr(self, f'downsample{i}_conv'), x, 3, 2))
        return outs
