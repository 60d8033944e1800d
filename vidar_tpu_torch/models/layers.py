"""Shared building blocks (port of vidar_tpu/models/layers.py).

Modules take a compute ``dtype`` the way flax modules do: ``Dense`` and
``Conv2d`` cast their input and parameters to it (or, when it is None, to
the promoted type of input and parameters), so a bf16 model keeps f32
parameters and computes in bf16. ``LayerNorm`` always normalises in f32 and
returns f32, as flax's LayerNorm does for bf16 inputs with f32 parameters.

Parameters are created empty: a model is filled from JAX weights
(``vidar_tpu_torch.convert``) or with random values.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


def compute_dtype(x: torch.Tensor, param: torch.Tensor,
                  dtype: Optional[torch.dtype]) -> torch.dtype:
    return dtype if dtype is not None else torch.promote_types(x.dtype,
                                                               param.dtype)


class Dense(nn.Module):
    """flax ``nn.Dense``: weight [out, in]."""

    def __init__(self, in_features: int, out_features: int, dtype=None,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features,
                                               device=device))
        self.bias = nn.Parameter(torch.empty(out_features, device=device))
        self.dtype = dtype

    def forward(self, x):
        dt = compute_dtype(x, self.weight, self.dtype)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class TorchLinear(nn.Module):
    """The JAX ``TorchLinear`` wrapper: a ``Dense`` named ``linear``."""

    def __init__(self, in_features: int, out_features: int, dtype=None,
                 device=None):
        super().__init__()
        self.linear = Dense(in_features, out_features, dtype, device)

    def forward(self, x):
        return self.linear(x)


class Conv2d(nn.Module):
    """flax ``nn.Conv`` on NCHW tensors: weight OIHW, explicit padding."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1, use_bias: bool = True,
                 dtype=None, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel,
                                               device=device))
        self.bias = (nn.Parameter(torch.empty(out_ch, device=device))
                     if use_bias else None)
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.dtype = dtype

    def forward(self, x):
        dt = compute_dtype(x, self.weight, self.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride,
                        self.padding, self.dilation)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (epsilon 1e-6), computed and returned in f32."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x):
        return F.layer_norm(x.float(), self.weight.shape, self.weight,
                            self.bias, 1e-6)


class FFN(nn.Module):
    """mmcv FFN at eval: identity + fc2(relu(fc1(x)))."""

    def __init__(self, feedforward_channels: int, embed_dims: int,
                 dtype=None, device=None):
        super().__init__()
        self.fc1 = TorchLinear(embed_dims, feedforward_channels, dtype=dtype,
                               device=device)
        self.fc2 = TorchLinear(feedforward_channels, embed_dims, dtype=dtype,
                               device=device)

    def forward(self, x):
        return x + self.fc2(torch.relu(self.fc1(x)))


class LearnedPositionalEncoding(nn.Module):
    """concat(col_embed[x], row_embed[y]) -> [bs, H, W, 2*num_feats]."""

    def __init__(self, num_feats: int = 128, row_num_embed: int = 200,
                 col_num_embed: int = 200, device=None):
        super().__init__()
        self.row_embed = nn.Parameter(torch.empty(row_num_embed, num_feats,
                                                  device=device))
        self.col_embed = nn.Parameter(torch.empty(col_num_embed, num_feats,
                                                  device=device))

    def forward(self, bs: int):
        h, f = self.row_embed.shape
        w = self.col_embed.shape[0]
        x_embed = self.col_embed[None, :, :].expand(h, w, f)
        y_embed = self.row_embed[:, None, :].expand(h, w, f)
        pos = torch.cat([x_embed, y_embed], dim=-1)
        return pos[None].expand(bs, h, w, 2 * f)


class MLP(nn.Module):
    """Linear/ReLU stack with a trailing LayerNorm (the can-bus MLPs)."""

    def __init__(self, in_features: int, hidden: Sequence[int], dtype=None,
                 device=None):
        super().__init__()
        self.num_fcs = len(hidden)
        for i, f in enumerate(hidden):
            self.add_module(f'fc{i}', TorchLinear(in_features, f, dtype=dtype,
                                                  device=device))
            in_features = f
        self.norm = LayerNorm(in_features, device)

    def forward(self, x):
        for i in range(self.num_fcs):
            x = torch.relu(getattr(self, f'fc{i}')(x))
        return self.norm(x)
