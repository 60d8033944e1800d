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
    """flax ``nn.Conv`` on NCHW tensors: weight OIHW, explicit padding;
    ``groups`` is flax's ``feature_group_count`` (weight [O, I/groups, kh,
    kw])."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1, use_bias: bool = True,
                 dtype=None, device=None, groups: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch // groups,
                                               kernel, kernel,
                                               device=device))
        self.bias = (nn.Parameter(torch.empty(out_ch, device=device))
                     if use_bias else None)
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.groups = groups
        self.dtype = dtype

    def forward(self, x):
        dt = compute_dtype(x, self.weight, self.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride,
                        self.padding, self.dilation, self.groups)


def same_padding(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Pad an NCHW map as flax's ``padding='SAME'`` pads it for a conv of
    ``kernel`` and ``stride``: the total that keeps ceil(size / stride)
    outputs, its odd unit at the bottom and right."""
    pads = []
    for size in (x.shape[3], x.shape[2]):
        total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (epsilon 1e-6), computed and returned in f32."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x):
        return F.layer_norm(x.float(), self.weight.shape, self.weight,
                            self.bias, 1e-6)


class GroupNorm(nn.GroupNorm):
    """flax ``nn.GroupNorm`` on NCHW maps, computed and returned in f32 as
    flax's is for a bf16 input with f32 parameters; a group of one value
    (one channel of a 1x1 map) normalises to 0, as in flax, where
    ``F.group_norm`` refuses it."""

    def forward(self, x):
        n, c = x.shape[:2]
        g = x.float().reshape(n, self.num_groups, -1)
        mean = g.mean(-1, keepdim=True)
        var = ((g - mean) ** 2).mean(-1, keepdim=True)
        y = ((g - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        shape = (1, c) + (1,) * (x.dim() - 2)
        return y * self.weight.reshape(shape) + self.bias.reshape(shape)


# dropout rate of the FFNs and attention outputs (reference config
# ffn_dropout=0.1; vidar_tpu/models/layers.py:95,97, attention.py:151,420,479)
DROPOUT = 0.1


class FFN(nn.Module):
    """mmcv FFN: identity + drop(fc2(drop(relu(fc1(x))))); the dropouts act
    under ``train()`` only."""

    def __init__(self, feedforward_channels: int, embed_dims: int,
                 dtype=None, device=None):
        super().__init__()
        self.fc1 = TorchLinear(embed_dims, feedforward_channels, dtype=dtype,
                               device=device)
        self.fc2 = TorchLinear(feedforward_channels, embed_dims, dtype=dtype,
                               device=device)
        self.drop = nn.Dropout(DROPOUT)

    def forward(self, x):
        return x + self.drop(self.fc2(self.drop(torch.relu(self.fc1(x)))))


class MultiHeadDotProductAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` with ``qkv_features`` =
    ``out_features`` = ``embed_dims``: the query, key and value projections
    (flax's DenseGeneral kernels [E, heads, head_dim], here ``Dense`` over
    the flattened heads), scaled dot products by 1/sqrt(head_dim), a softmax
    in f32, and the output projection ``out``. ``forward(inputs_q,
    inputs_k, inputs_v, mask=None)``, [..., L, E] each, any leading batch
    dims (the key's and value's broadcast against the query's);
    ``mask`` (True = attend) broadcasts to [..., heads, Lq, Lk], and a
    masked logit takes the dtype's lowest value, as flax's. ``dropout`` is
    flax's ``dropout_rate``: dropout on the attention weights under
    ``train()``."""

    def __init__(self, embed_dims: int, num_heads: int, dtype=None,
                 device=None, dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        kw = dict(dtype=dtype, device=device)
        self.query = Dense(embed_dims, embed_dims, **kw)
        self.key = Dense(embed_dims, embed_dims, **kw)
        self.value = Dense(embed_dims, embed_dims, **kw)
        self.out = Dense(embed_dims, embed_dims, **kw)
        self.drop = nn.Dropout(dropout) if dropout else None

    def forward(self, inputs_q, inputs_k, inputs_v, mask=None):
        *lead, lq, e = inputs_q.shape
        h = self.num_heads

        def heads(proj, x):        # -> [..., heads, L, head_dim]
            return proj(x).reshape(*x.shape[:-1], h, e // h).transpose(-2,
                                                                       -3)

        q = heads(self.query, inputs_q)
        k = heads(self.key, inputs_k)
        v = heads(self.value, inputs_v)
        q = q / (e // h) ** 0.5
        logits = (q @ k.transpose(-1, -2)).float()
        if mask is not None:
            logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
        attn = torch.softmax(logits, dim=-1)
        if self.drop is not None:
            attn = self.drop(attn)
        out = (attn.to(v.dtype) @ v).transpose(-2, -3).reshape(*lead, lq, e)
        return self.out(out)


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
