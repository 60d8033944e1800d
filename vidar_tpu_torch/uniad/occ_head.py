"""OccFormer, the future instance occupancy head (port of
vidar_tpu/uniad/occ_head.py; reference occ_head.py, occ_head_plugin/).

``n_future + 1`` blocks, each: downscale the BEV state, evolve the instance
queries in time, a mask-guided attention mask, masked cross-attention of
the pixels to the queries, and an upsample back. Maps are NCHW here (the
JAX package's are NHWC); the norms are GroupNorm, as the JAX package has
them; bilinear resizes are ``F.interpolate`` with half-pixel centres, which
for the integer upscales here equal ``jax.image.resize``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.layers import Conv2d, LayerNorm, TorchLinear
from .blocks import LinLNReLU, TorchDecoderLayer


def _gn(ch: int) -> int:
    g = 32
    while ch % g:
        g //= 2
    return max(g, 1)


def group_norm(ch: int, device=None) -> nn.GroupNorm:
    """flax's ``GroupNorm`` (epsilon 1e-6) with the repository's group
    count."""
    return nn.GroupNorm(_gn(ch), ch, eps=1e-6, device=device)


def _up2(x):
    return F.interpolate(x, scale_factor=2, mode='bilinear',
                         align_corners=False)


class _MLP(nn.Module):
    """ReLU MLP, no activation after the last layer."""

    def __init__(self, in_features: int, hidden: int, out: int,
                 num_layers: int = 2, dtype=None, device=None):
        super().__init__()
        self.num_layers = num_layers
        dims = [in_features] + [hidden] * (num_layers - 1) + [out]
        for i in range(num_layers):
            self.add_module(f'fc{i}', TorchLinear(dims[i], dims[i + 1],
                                                  dtype=dtype, device=device))

    def forward(self, x):
        for i in range(self.num_layers - 1):
            x = torch.relu(getattr(self, f'fc{i}')(x))
        return getattr(self, f'fc{self.num_layers - 1}')(x)


class SimpleConv2d(nn.Module):
    """(Conv3x3 + GroupNorm + ReLU) x (n - 1) + Conv1x1."""

    def __init__(self, in_channels: int, out_channels: int,
                 conv_channels: int = 64, num_conv: int = 1, dtype=None,
                 device=None):
        super().__init__()
        self.num_conv = num_conv
        cc = in_channels if num_conv == 1 else conv_channels
        kw = dict(dtype=dtype, device=device)
        ch = in_channels
        for i in range(num_conv - 1):
            self.add_module(f'conv{i}', Conv2d(ch, cc, 3, padding=1,
                                               use_bias=False, **kw))
            self.add_module(f'norm{i}', group_norm(cc, device))
            ch = cc
        self.conv_out = Conv2d(ch, out_channels, 1, **kw)

    def forward(self, x):
        for i in range(self.num_conv - 1):
            x = torch.relu(getattr(self, f'norm{i}')(
                getattr(self, f'conv{i}')(x)))
        return self.conv_out(x)


class Bottleneck(nn.Module):
    """Residual bottleneck with an optional stride-2 down- or
    upsampling."""

    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 downsample: bool = False, upsample: bool = False,
                 dtype=None, device=None):
        super().__init__()
        out_ch = out_channels or in_channels
        mid = in_channels // 2
        self.downsample, self.upsample = downsample, upsample
        kw = dict(dtype=dtype, device=device)
        self.conv_down_project = Conv2d(in_channels, mid, 1, use_bias=False,
                                        **kw)
        self.abn_down = group_norm(mid, device)
        self.conv = Conv2d(mid, mid, 3, stride=1 if upsample else
                           (2 if downsample else 1), padding=1,
                           use_bias=False, **kw)
        self.abn = group_norm(mid, device)
        self.conv_up_project = Conv2d(mid, out_ch, 1, use_bias=False, **kw)
        self.abn_up = group_norm(out_ch, device)
        self.project_skip = not (out_ch == in_channels and
                                 not (downsample or upsample))
        if self.project_skip:
            self.conv_skip_proj = Conv2d(in_channels, out_ch, 1,
                                         use_bias=False, **kw)
            self.bn_skip_proj = group_norm(out_ch, device)

    def forward(self, x):
        h = torch.relu(self.abn_down(self.conv_down_project(x)))
        if self.upsample:
            h = _up2(h)
        h = torch.relu(self.abn(self.conv(h)))
        h = torch.relu(self.abn_up(self.conv_up_project(h)))
        skip = x
        if self.project_skip:
            if self.upsample:
                skip = _up2(skip)
            elif self.downsample:
                skip = F.max_pool2d(skip, 2, 2)
            skip = self.bn_skip_proj(self.conv_skip_proj(skip))
        return h + skip


class UpsamplingAdd(nn.Module):
    """Bilinear x2 + Conv1x1 + GroupNorm, then the skip added."""

    def __init__(self, in_channels: int, out_channels: int, dtype=None,
                 device=None):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, 1, use_bias=False,
                           dtype=dtype, device=device)
        self.norm = group_norm(out_channels, device)

    def forward(self, x, skip):
        return self.norm(self.conv(_up2(x))) + skip


class CVTDecoderBlock(nn.Module):
    """Upsampling conv block with a projected skip."""

    def __init__(self, in_channels: int, out_channels: int, skip_dim: int,
                 factor: int = 2, with_relu: bool = True, dtype=None,
                 device=None):
        super().__init__()
        dim = out_channels // factor
        self.with_relu = with_relu
        kw = dict(dtype=dtype, device=device)
        self.conv0 = Conv2d(in_channels, dim, 3, padding=1, use_bias=False,
                            **kw)
        self.norm0 = group_norm(dim, device)
        self.conv1 = Conv2d(dim, out_channels, 1, use_bias=False, **kw)
        self.norm1 = group_norm(out_channels, device)
        self.up = Conv2d(skip_dim, out_channels, 1, **kw)

    def forward(self, x, skip):
        y = torch.relu(self.norm0(self.conv0(_up2(x))))
        y = self.norm1(self.conv1(y))
        up = F.interpolate(self.up(skip), size=y.shape[-2:], mode='bilinear',
                           align_corners=False)
        y = y + up
        return torch.relu(y) if self.with_relu else y


class CVTDecoder(nn.Module):
    """CVT blocks upsampling /4 -> /1: [B, T, C, H, W] -> [B, T, C_last,
    4H, 4W]."""

    def __init__(self, dim: int, blocks, dtype=None, device=None):
        super().__init__()
        self.num_blocks = len(blocks)
        ch = dim
        for i, out_ch in enumerate(blocks):
            self.add_module(f'block{i}', CVTDecoderBlock(
                ch, out_ch, dim, with_relu=i < len(blocks) - 1, dtype=dtype,
                device=device))
            ch = out_ch

    def forward(self, x):
        b, t = x.shape[:2]
        y = x.reshape(b * t, *x.shape[2:])
        skip = y
        for i in range(self.num_blocks):
            y = getattr(self, f'block{i}')(y, skip)
            skip = y
        return y.reshape(b, t, *y.shape[1:])


class _MultiQueryFuser(nn.Module):
    """Linear(-> 2 query_dim) + LN + ReLU + Linear(-> out)."""

    def __init__(self, in_features: int, query_dim: int, out: int,
                 dtype=None, device=None):
        super().__init__()
        self.fc0 = TorchLinear(in_features, query_dim * 2, dtype=dtype,
                               device=device)
        self.ln = LayerNorm(query_dim * 2, device)
        self.fc1 = TorchLinear(query_dim * 2, out, dtype=dtype,
                               device=device)

    def forward(self, x):
        return self.fc1(torch.relu(self.ln(self.fc0(x))))


class OccHead(nn.Module):
    """Future instance occupancy from the BEV and the fused agent queries
    (base_e2e.py:330-394: 4 projection convs, 5 decoder layers over
    ``n_future + 1`` blocks, attention mask threshold 0.3)."""

    def __init__(self, embed_dims: int = 256, n_future: int = 4,
                 bev_h: int = 200, bev_w: int = 200, bev_proj_dim: int = 256,
                 bev_proj_nlayers: int = 4, num_trans_layers: int = 5,
                 num_heads: int = 8, query_dim: int = 256,
                 query_mlp_layers: int = 3, temporal_mlp_layer: int = 2,
                 attn_mask_thresh: float = 0.3, detach_query_pos: bool = True,
                 test_seg_thresh: float = 0.1, dtype=None, device=None):
        super().__init__()
        d, pd = query_dim, bev_proj_dim
        self.bev_h, self.bev_w = bev_h, bev_w
        self.n_future_blocks = n_future + 1
        self.num_trans_layers = num_trans_layers
        self.attn_mask_thresh = attn_mask_thresh
        self.detach_query_pos = detach_query_pos
        self.test_seg_thresh = test_seg_thresh
        kw = dict(dtype=dtype, device=device)
        self.bev_light_proj = SimpleConv2d(embed_dims, pd,
                                           conv_channels=embed_dims,
                                           num_conv=bev_proj_nlayers, **kw)
        for i in range(2):
            self.add_module(f'base_downscale_{i}',
                            Bottleneck(pd, downsample=True, **kw))
        for i in range(self.n_future_blocks):
            self.add_module(f'temporal_mlps_{i}',
                            _MLP(pd, d, pd, temporal_mlp_layer, **kw))
            self.add_module(f'downscale_convs_{i}',
                            Bottleneck(pd, downsample=True, **kw))
            self.add_module(f'upsample_adds_{i}', UpsamplingAdd(pd, pd,
                                                                **kw))
        # the layers the blocks use: a remainder of num_trans_layers /
        # blocks has no parameters in the JAX package either
        per_block = num_trans_layers // self.n_future_blocks
        for i in range(per_block * self.n_future_blocks):
            self.add_module(f'trans_layers_{i}', TorchDecoderLayer(
                pd, num_heads, 2048, dropout=0.0, **kw))
        self.dense_decoder = CVTDecoder(pd, (pd, pd), **kw)
        self.mode_fuser = LinLNReLU(embed_dims, pd, **kw)
        self.multi_query_fuser = _MultiQueryFuser(pd + 2 * embed_dims, d, pd,
                                                  **kw)
        self.query_to_occ_feat = _MLP(pd, d, pd, query_mlp_layers, **kw)
        self.temporal_mlp_for_mask = _MLP(pd, d, pd, query_mlp_layers, **kw)

    def get_attn_mask(self, state, ins_query):
        """state [B, C, h, w]; ins_query [B, Q, C] -> (attention mask [B,
        Q, h, w], True = masked; the mask logits upsampled to [B, Q, H,
        W]; the mask embedding)."""
        ins_embed = self.temporal_mlp_for_mask(ins_query)
        mask_pred = torch.einsum('bqc,bchw->bqhw', ins_embed, state)
        attn_mask = torch.sigmoid(mask_pred) < self.attn_mask_thresh
        # an all-background mask is disabled (occ_head.py:190-192)
        all_bg = attn_mask.flatten(2).all(-1)[..., None, None]
        attn_mask = (attn_mask & ~all_bg).detach()
        b, q, h, w = mask_pred.shape
        up = F.interpolate(mask_pred.reshape(b * q, 1, h, w),
                           size=(self.bev_h, self.bev_w), mode='bilinear',
                           align_corners=False)
        return attn_mask, up.reshape(b, q, self.bev_h, self.bev_w), ins_embed

    def forward(self, bev, ins_query):
        """bev [B, HW, C]; ins_query [B, Q, C] (``merge_queries``) ->
        dict(mask_preds, ins_occ_logits [B, Q, T, H, W], seg_out [B, T, H,
        W])."""
        b = bev.shape[0]
        base = bev.reshape(b, self.bev_h, self.bev_w, -1).permute(0, 3, 1, 2)
        base = self.bev_light_proj(base)
        for i in range(2):
            base = getattr(self, f'base_downscale_{i}')(base)      # /4
        last_state, last_q = base, ins_query
        future_states, mask_preds, ins_embeds = [], [], []
        per_block = self.num_trans_layers // self.n_future_blocks
        for i in range(self.n_future_blocks):
            cur = getattr(self, f'downscale_convs_{i}')(last_state)  # /8
            cur_q = getattr(self, f'temporal_mlps_{i}')(last_q)
            attn_mask, mask_pred, ins_emb = self.get_attn_mask(cur, cur_q)
            mask_preds.append(mask_pred)
            ins_embeds.append(ins_emb)
            c, hh, ww = cur.shape[1:]
            pix = cur.flatten(2).transpose(1, 2)
            # pixels attend the instance queries where the mask allows
            cross = ~attn_mask.permute(0, 2, 3, 1).reshape(b, hh * ww, -1)
            for j in range(per_block):
                pix = getattr(self, f'trans_layers_{i * per_block + j}')(
                    pix, cur_q, cross_mask=cross[:, None])
            cur = pix.transpose(1, 2).reshape(b, c, hh, ww)
            cur = getattr(self, f'upsample_adds_{i}')(cur, last_state)  # /4
            future_states.append(cur)
            last_state, last_q = cur, cur_q
        future = self.dense_decoder(torch.stack(future_states, 1))
        ins_occ_q = self.query_to_occ_feat(torch.stack(ins_embeds, 1))
        logits = torch.einsum('btqc,btchw->bqthw', ins_occ_q, future)
        seg_out = (torch.sigmoid(logits) > self.test_seg_thresh).any(1)
        return dict(mask_preds=torch.stack(mask_preds, 2),
                    ins_occ_logits=logits, seg_out=seg_out.float())

    def merge_queries(self, traj_query, track_query, track_query_pos):
        """traj_query [B, Q, P, D] (the last decoder layer's), track_query
        / track_query_pos [B, Q, D] -> the fused instance queries."""
        if self.detach_query_pos:
            track_query_pos = track_query_pos.detach()
        ins = self.mode_fuser(traj_query).amax(2)
        return self.multi_query_fuser(torch.cat(
            [ins, track_query, track_query_pos], -1))


# ----------------------------------- losses (occflow_loss.py: BCE + dice)

def _bce_logits(logits, targets):
    return (logits.clamp(min=0) - logits * targets +
            torch.log1p(torch.exp(-logits.abs())))


def fiery_binary_seg_loss(logits, targets, valid, num_valid,
                          top_k_ratio=0.25, future_discount=0.95):
    """Top-k BCE with a future discount over [B, Q, T, H, W] masks, the
    slots outside ``valid`` zeroed, summed and divided by ``num_valid``
    (the global batch's count of valid agent slots)."""
    t_axis = logits.shape[2]
    bce = _bce_logits(logits, targets)
    disc = future_discount ** torch.arange(t_axis, dtype=torch.float32,
                                           device=logits.device)
    bce = bce * disc[None, None, :, None, None] * valid
    b, q, t, h, w = bce.shape
    k = max(1, int(h * w * top_k_ratio))
    top = torch.topk(bce.reshape(b, q, t, h * w), k, -1).values
    return top.mean((2, 3)).sum() / num_valid.clamp(min=1.0)


def dice_loss_with_masks(logits, targets, valid, num_valid,
                         eps: float = 1.0):
    """Dice over sigmoid masks, the slots outside ``valid`` zeroed, summed
    and divided by ``num_valid`` (the global batch's count of valid
    slots)."""
    p = torch.sigmoid(logits) * valid
    targets = targets * valid
    axes = tuple(range(2, logits.dim()))
    num = 2.0 * (p * targets).sum(axes)
    den = p.sum(axes) + targets.sum(axes) + eps
    per = 1.0 - (num + eps) / den
    b, q = per.shape[:2]
    slot_valid = valid.reshape(b, q)
    per = per.reshape(b, q, -1).mean(-1) * slot_valid
    return per.sum() / num_valid.clamp(min=1.0)
