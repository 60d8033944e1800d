"""Latent rendering: radial ray marching over BEV features (port of
``LatentRendering``, vidar_tpu/models/latent_rendering.py:489-568).

Per BEV cell: an occupancy head (``num_pred_fcs`` x Linear + LayerNorm +
ReLU, then a Linear) gives per-height logits; the first-hit
probability along the radial ray through the cell (K3) weights an
aggregation of LoRA-down features along the same ray (K4); the LoRA-up
features, scaled per height group by the first-hit probability, replace the
cell embedding.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from ..ops.latent_render import ray_aggregate, ray_first_hit
from .layers import LayerNorm, TorchLinear


def bev_center_grids(h: int, w: int) -> np.ndarray:
    """Normalised [0,1] cell-centre coordinates, row-major [H*W, 2]."""
    ys = (np.arange(h, dtype=np.float32) + 0.5) / h
    xs = (np.arange(w, dtype=np.float32) + 0.5) / w
    gx, gy = np.meshgrid(xs, ys)
    return np.stack([gx.reshape(-1), gy.reshape(-1)], -1)


def ray_geometry(bev_h: int, bev_w: int, grid_num: int, grid_step: float,
                 device):
    """(grids [N, 2], radial_norm [N, 2], steps [G]) f32 on ``device``."""
    grids = torch.from_numpy(bev_center_grids(bev_h, bev_w)).to(device)
    radial = grids - 0.5
    radial_norm = torch.nan_to_num(
        radial / torch.sqrt((radial ** 2).sum(-1, keepdim=True)))
    step = grid_step / (min(bev_h, bev_w) // 2)
    steps = (torch.arange(grid_num, dtype=torch.float32, device=device) +
             0.5) * step
    return grids, radial_norm, steps


class LatentRendering(nn.Module):

    def __init__(self, embed_dims: int = 256, num_pred_fcs: int = 0,
                 pred_height: int = 16, grid_num: int = 128,
                 grid_step: float = 0.5, reduction: int = 16,
                 act: str = 'exp', dtype=None, device=None):
        super().__init__()
        if act not in ('exp', 'sigmoid'):
            raise NotImplementedError(act)
        self.embed_dims, self.pred_height = embed_dims, pred_height
        self.grid_num, self.grid_step = grid_num, grid_step
        self.act, self.dtype = act, dtype
        self.c_r = embed_dims // reduction
        kw = dict(dtype=dtype, device=device)
        self.num_pred_fcs = num_pred_fcs
        # flax's occ_fc{i} / occ_ln{i} (LayerNorm epsilon 1e-6), in order
        for i in range(num_pred_fcs):
            setattr(self, f'occ_fc{i}',
                    TorchLinear(embed_dims, embed_dims, **kw))
            setattr(self, f'occ_ln{i}', LayerNorm(embed_dims, device=device))
        self.occ_head = TorchLinear(embed_dims, pred_height, **kw)
        self.lora_a = TorchLinear(embed_dims, self.c_r, **kw)
        self.lora_b = TorchLinear(self.c_r, embed_dims, **kw)

    def forward(self, embed, eps: float = 1e-3):
        """embed [bs, bev_h, bev_w, C] -> same shape (f32)."""
        bs, bev_h, bev_w, c = embed.shape
        n, zdim = bev_h * bev_w, self.pred_height
        h = embed
        for i in range(self.num_pred_fcs):
            h = torch.relu(getattr(self, f'occ_ln{i}')(
                getattr(self, f'occ_fc{i}')(h)))
        occ_pred = self.occ_head(h)                        # [bs, H, W, Z]
        grids, radial_norm, steps = ray_geometry(
            bev_h, bev_w, self.grid_num, self.grid_step, embed.device)
        occ_path_prob = ray_first_hit(occ_pred, grids, radial_norm, steps,
                                      self.act)            # [bs, N, Z] f32
        lora_a = self.lora_a(embed)
        prob_map = occ_path_prob.reshape(bs, bev_h, bev_w, zdim)
        if self.dtype == torch.bfloat16:
            # the first-hit map is rounded to bf16 in the fused map
            fused_map = torch.cat([lora_a, prob_map.to(torch.bfloat16)], -1)
        else:
            fused_map = torch.cat([lora_a.float(), prob_map], -1)
        ray_feat = ray_aggregate(fused_map, grids, radial_norm, steps,
                                 self.c_r, zdim, eps)
        up = self.lora_b(ray_feat).reshape(bs, n, zdim, c // zdim)
        out = up * occ_path_prob[..., None]
        return out.reshape(bs, bev_h, bev_w, c)
