"""Post-norm transformer blocks of the UniAD heads (port of
vidar_tpu/uniad/blocks.py): ``torch.nn.TransformerEncoderLayer`` /
``TransformerDecoderLayer`` (post-norm, ReLU FFN) with the flax module
names, and the small fusers. Dropouts act under ``train()`` only."""

from __future__ import annotations

import torch
import torch.nn as nn

from ..models.layers import (LayerNorm, MultiHeadDotProductAttention,
                             TorchLinear)


class TorchEncoderLayer(nn.Module):
    """self-attn -> add & norm -> FFN -> add & norm."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 feedforward: int = 512, dropout: float = 0.1, dtype=None,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.self_attn = MultiHeadDotProductAttention(
            embed_dims, num_heads, dropout=dropout, **kw)
        self.norm1 = LayerNorm(embed_dims, device)
        self.linear1 = TorchLinear(embed_dims, feedforward, **kw)
        self.linear2 = TorchLinear(feedforward, embed_dims, **kw)
        self.norm2 = LayerNorm(embed_dims, device)
        self.drop = nn.Dropout(dropout)

    def forward(self, x, mask=None):
        x = self.norm1(x + self.drop(self.self_attn(x, x, x, mask)))
        h = self.linear2(self.drop(torch.relu(self.linear1(x))))
        return self.norm2(x + self.drop(h))


class TorchDecoderLayer(nn.Module):
    """self-attn, cross-attn into ``memory``, FFN; each add & norm."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 feedforward: int = 512, dropout: float = 0.1, dtype=None,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.self_attn = MultiHeadDotProductAttention(
            embed_dims, num_heads, dropout=dropout, **kw)
        self.norm1 = LayerNorm(embed_dims, device)
        self.cross_attn = MultiHeadDotProductAttention(
            embed_dims, num_heads, dropout=dropout, **kw)
        self.norm2 = LayerNorm(embed_dims, device)
        self.linear1 = TorchLinear(embed_dims, feedforward, **kw)
        self.linear2 = TorchLinear(feedforward, embed_dims, **kw)
        self.norm3 = LayerNorm(embed_dims, device)
        self.drop = nn.Dropout(dropout)

    def forward(self, x, memory, self_mask=None, cross_mask=None):
        x = self.norm1(x + self.drop(self.self_attn(x, x, x, self_mask)))
        x = self.norm2(x + self.drop(self.cross_attn(x, memory, memory,
                                                     cross_mask)))
        h = self.linear2(self.drop(torch.relu(self.linear1(x))))
        return self.norm3(x + self.drop(h))


class TorchDecoder(nn.Module):
    """A stack of ``TorchDecoderLayer`` (nn.TransformerDecoder, no final
    norm), ``layers_{i}``."""

    def __init__(self, num_layers: int = 3, embed_dims: int = 256,
                 num_heads: int = 8, feedforward: int = 512,
                 dropout: float = 0.1, dtype=None, device=None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f'layers_{i}', TorchDecoderLayer(
                embed_dims, num_heads, feedforward, dropout, dtype=dtype,
                device=device))

    def forward(self, x, memory, cross_mask=None):
        for i in range(self.num_layers):
            x = getattr(self, f'layers_{i}')(x, memory,
                                             cross_mask=cross_mask)
        return x


class FuserMLP(nn.Module):
    """Linear -> ReLU -> Linear (the reference's *_fuser Sequentials)."""

    def __init__(self, in_features: int, hidden: int, out: int, dtype=None,
                 device=None):
        super().__init__()
        self.fc0 = TorchLinear(in_features, hidden, dtype=dtype,
                               device=device)
        self.fc1 = TorchLinear(hidden, out, dtype=dtype, device=device)

    def forward(self, x):
        return self.fc1(torch.relu(self.fc0(x)))


class LinLNReLU(nn.Module):
    """Linear -> LayerNorm -> ReLU."""

    def __init__(self, in_features: int, out: int, dtype=None, device=None):
        super().__init__()
        self.fc = TorchLinear(in_features, out, dtype=dtype, device=device)
        self.ln = LayerNorm(out, device)

    def forward(self, x):
        return torch.relu(self.ln(self.fc(x)))
