"""Feature Pyramid Network (port of vidar_tpu/models/fpn.py): 1x1 laterals,
2x nearest top-down with a crop for odd sizes, 3x3 outputs, and extra
levels from a stride-2 conv on relu(last output). NHWC in and out, NCHW
(channels-last memory) inside."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv2d


class FPN(nn.Module):

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_outs: int = 4, dtype=None, device=None):
        super().__init__()
        self.num_ins = len(in_channels)
        self.num_outs = num_outs
        kw = dict(dtype=dtype, device=device)
        for i, c in enumerate(in_channels):
            self.add_module(f'lateral_convs_{i}',
                            Conv2d(c, out_channels, 1, **kw))
        for i in range(num_outs):
            self.add_module(f'fpn_convs_{i}', Conv2d(
                out_channels, out_channels, 3,
                stride=1 if i < self.num_ins else 2, padding=1, **kw))

    def forward(self, inputs):
        """list of NHWC maps -> list of ``num_outs`` NHWC maps."""
        laterals = [getattr(self, f'lateral_convs_{i}')(x.permute(0, 3, 1, 2))
                    for i, x in enumerate(inputs)]
        for i in range(self.num_ins - 1, 0, -1):
            up = F.interpolate(laterals[i], scale_factor=2, mode='nearest')
            h, w = laterals[i - 1].shape[2:]
            laterals[i - 1] = laterals[i - 1] + up[:, :, :h, :w]
        outs = [getattr(self, f'fpn_convs_{i}')(laterals[i])
                for i in range(self.num_ins)]
        for i in range(self.num_ins, self.num_outs):
            outs.append(getattr(self, f'fpn_convs_{i}')(torch.relu(outs[-1])))
        return [o.permute(0, 2, 3, 1) for o in outs]
