"""Pansegformer, the BEV map panoptic segmentation head (port of
vidar_tpu/uniad/panseg_head.py; reference panseg_head.py,
seg_deformable_transformer.py, seg_mask_head.py).

A 6-layer deformable encoder over the one BEV level (its 40,000 cells at
200x200 the queries: K1 on the card, K5 in its backward), a 6-layer
deformable-DETR decoder with box refinement over the thing queries (K1/K5
again), and the thing / stuff mask heads, whose per-head attention logits
become BEV masks. The mask heads run on the ``num_mask_queries``
top-scoring thing queries, ties broken towards the lower index as
``jax.lax.top_k`` breaks them.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.bbox import (focal_loss_cost, hungarian_assign,
                         sigmoid_focal_loss, stable_topk)
from ..models.attention import PredictionMSDeformableAttention
from ..models.layers import (DROPOUT, FFN, Dense, LayerNorm,
                             MultiHeadDotProductAttention, TorchLinear)
from ..models.position_embedding import sine_positional_encoding


def inverse_sigmoid(x, eps: float = 1e-5):
    x = x.clamp(eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


class SegEncoderLayer(nn.Module):
    """deformable self-attention -> norm -> FFN -> norm."""

    def __init__(self, embed_dims: int = 256, feedforward: int = 1024,
                 dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.attn = PredictionMSDeformableAttention(
            embed_dims, num_levels=1, num_points=4, **kw)
        self.norm0 = LayerNorm(embed_dims, device)
        self.ffn = FFN(feedforward, embed_dims, **kw)
        self.norm1 = LayerNorm(embed_dims, device)

    def forward(self, x, ref_points, spatial_shapes, pos=None):
        x = self.norm0(self.attn(x, x, ref_points, spatial_shapes,
                                 query_pos=pos))
        return self.norm1(self.ffn(x))


class SegDecoderLayer(nn.Module):
    """self-attention (MHA) -> norm -> deformable cross-attention -> norm
    -> FFN -> norm."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 feedforward: int = 1024, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.self_attn = MultiHeadDotProductAttention(
            embed_dims, num_heads, dropout=DROPOUT, **kw)
        self.drop = nn.Dropout(DROPOUT)
        self.norm0 = LayerNorm(embed_dims, device)
        self.cross_attn = PredictionMSDeformableAttention(
            embed_dims, num_levels=1, num_points=4, **kw)
        self.norm1 = LayerNorm(embed_dims, device)
        self.ffn = FFN(feedforward, embed_dims, **kw)
        self.norm2 = LayerNorm(embed_dims, device)

    def forward(self, query, memory, ref_points, spatial_shapes,
                query_pos=None):
        q = query + query_pos if query_pos is not None else query
        query = self.norm0(query + self.drop(self.self_attn(q, q, query)))
        query = self.norm1(self.cross_attn(query, memory, ref_points,
                                           spatial_shapes,
                                           query_pos=query_pos))
        return self.norm2(self.ffn(query))


def _head_logits(q_lin, k_lin, query, key, num_heads):
    """Per-head scaled logits [B, H, N, L] of two TorchLinear projections."""
    b, n, c = query.shape
    l = key.shape[1]
    hd = c // num_heads
    q = q_lin(query).reshape(b, n, num_heads, hd).transpose(1, 2)
    k = k_lin(key).reshape(b, l, num_heads, hd).transpose(1, 2)
    return (q @ k.transpose(-1, -2)) * hd ** -0.5


class AttentionTail(nn.Module):
    """Mask-only attention: per-head logits -> Linear(H) -> ReLU ->
    Linear(1) -> ReLU, a mask [B, N, L, 1]."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8, dtype=None,
                 device=None):
        super().__init__()
        self.num_heads = num_heads
        kw = dict(dtype=dtype, device=device)
        self.q = TorchLinear(embed_dims, embed_dims, **kw)
        self.k = TorchLinear(embed_dims, embed_dims, **kw)
        self.linear_l1 = TorchLinear(num_heads, num_heads, **kw)
        self.linear = TorchLinear(num_heads, 1, **kw)

    def mask(self, attn):
        m = torch.relu(self.linear_l1(attn.permute(0, 2, 3, 1)))
        return torch.relu(self.linear(m))

    def forward(self, query, key):
        return self.mask(_head_logits(self.q, self.k, query, key,
                                      self.num_heads))


class MaskAttention(AttentionTail):
    """Cross-attention whose per-head logits also emit a mask."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8, dtype=None,
                 device=None):
        super().__init__(embed_dims, num_heads, dtype, device)
        kw = dict(dtype=dtype, device=device)
        self.v = TorchLinear(embed_dims, embed_dims, **kw)
        self.proj = TorchLinear(embed_dims, embed_dims, **kw)

    def forward(self, query, key, value):
        b, n, c = query.shape
        attn = _head_logits(self.q, self.k, query, key, self.num_heads)
        mask = self.mask(attn)
        v = self.v(value).reshape(b, value.shape[1], self.num_heads,
                                  c // self.num_heads).transpose(1, 2)
        attn = torch.softmax(attn.float(), -1).to(v.dtype)
        x = (attn @ v).transpose(1, 2).reshape(b, n, c)
        return self.proj(x), mask


class MaskBlock(nn.Module):
    """LN + (optional self-attention) + MaskAttention + GELU MLP."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 self_attn: bool = False, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.with_self_attn = self_attn
        if self_attn:
            self.norm_sa = LayerNorm(embed_dims, device)
            self.sa = MultiHeadDotProductAttention(embed_dims, num_heads,
                                                   **kw)
        self.attn = MaskAttention(embed_dims, num_heads, **kw)
        self.norm1 = LayerNorm(embed_dims, device)
        self.norm2 = LayerNorm(embed_dims, device)
        self.mlp_fc1 = TorchLinear(embed_dims, embed_dims * 4, **kw)
        self.mlp_fc2 = TorchLinear(embed_dims * 4, embed_dims, **kw)

    def forward(self, query, key, value):
        if self.with_self_attn:
            q = self.norm_sa(query)
            query = query + self.sa(q, q, q)
        x, mask = self.attn(self.norm1(query), key, value)
        query = query + x
        # flax's gelu is the tanh approximation
        h = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(query)),
                                approximate='tanh'))
        return query + h, mask


class SegMaskHead(nn.Module):
    """``blocks_{i}`` MaskBlocks and the ``attnen`` AttentionTail."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_layers: int = 4, self_attn: bool = False, dtype=None,
                 device=None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f'blocks_{i}', MaskBlock(
                embed_dims, num_heads, self_attn, dtype=dtype, device=device))
        self.attnen = AttentionTail(embed_dims, num_heads, dtype=dtype,
                                    device=device)

    def forward(self, memory, memory_pos, query, query_pos):
        masks, inter_q = [], []
        key = memory + memory_pos if memory_pos is not None else memory
        for i in range(self.num_layers):
            q_in = query + query_pos if query_pos is not None else query
            query, mask = getattr(self, f'blocks_{i}')(q_in, key, memory)
            masks.append(mask)
            inter_q.append(query)
        attn = self.attnen(query + query_pos if query_pos is not None
                           else query, key)
        return attn, masks, inter_q


class _RegBranch4(nn.Module):
    """2 x (Linear + ReLU) + Linear(4)."""

    def __init__(self, embed_dims: int, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.fc0 = TorchLinear(embed_dims, embed_dims, **kw)
        self.fc1 = TorchLinear(embed_dims, embed_dims, **kw)
        self.out = TorchLinear(embed_dims, 4, **kw)

    def forward(self, x):
        return self.out(torch.relu(self.fc1(torch.relu(self.fc0(x)))))


class PansegformerHead(nn.Module):
    """Things/stuff panoptic BEV segmentation."""

    def __init__(self, embed_dims: int = 256, num_query: int = 300,
                 num_things_classes: int = 3, num_stuff_classes: int = 1,
                 num_enc_layers: int = 6, num_dec_layers: int = 6,
                 num_thing_mask_layers: int = 4,
                 num_stuff_mask_layers: int = 6, bev_h: int = 200,
                 bev_w: int = 200, feedforward: int = 1024,
                 with_box_refine: bool = True, num_mask_queries: int = 32,
                 dtype=None, device=None):
        super().__init__()
        d = embed_dims
        self.embed_dims, self.num_query = d, num_query
        self.num_stuff_classes = num_stuff_classes
        self.bev_h, self.bev_w = bev_h, bev_w
        self.num_enc_layers, self.num_dec_layers = (num_enc_layers,
                                                    num_dec_layers)
        self.num_thing_mask_layers = num_thing_mask_layers
        self.num_stuff_mask_layers = num_stuff_mask_layers
        self.with_box_refine = with_box_refine
        self.num_mask_queries = num_mask_queries
        kw = dict(dtype=dtype, device=device)
        self.query_embedding = nn.Parameter(torch.empty(num_query, 2 * d,
                                                        device=device))
        self.stuff_query = nn.Parameter(torch.empty(num_stuff_classes, 2 * d,
                                                    device=device))
        self.reference_points_fc = Dense(d, 2, **kw)
        for i in range(num_enc_layers):
            self.add_module(f'encoder_{i}', SegEncoderLayer(
                d, feedforward, **kw))
        for i in range(num_dec_layers):
            self.add_module(f'decoder_{i}', SegDecoderLayer(
                d, feedforward=feedforward, **kw))
            self.add_module(f'cls_branches_{i}', TorchLinear(
                d, num_things_classes, **kw))
            self.add_module(f'reg_branches_{i}', _RegBranch4(d, **kw))
        self.things_mask_head = SegMaskHead(
            d, num_layers=num_thing_mask_layers, **kw)
        self.stuff_mask_head = SegMaskHead(
            d, num_layers=num_stuff_mask_layers, self_attn=True, **kw)
        for i in range(num_thing_mask_layers):
            self.add_module(f'cls_thing_branches_{i}', TorchLinear(
                d, num_things_classes, **kw))
        for i in range(num_stuff_mask_layers):
            self.add_module(f'cls_stuff_branches_{i}', TorchLinear(d, 1,
                                                                   **kw))

    def _encoder_ref_points(self, bs: int, device):
        h, w = self.bev_h, self.bev_w
        ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
        gy, gx = torch.meshgrid(ys, xs, indexing='ij')
        ref = torch.stack([gx, gy], -1).reshape(1, h * w, 1, 2)
        return ref.expand(bs, h * w, 1, 2)

    def forward(self, bev, *, with_masks: bool = False):
        """bev [B, HW, D] -> dict(outputs_classes [L, B, Q, 3],
        outputs_coords [L, B, Q, 4] cxcywh in [0, 1], args_tuple (the
        motion head's inputs), reference, masks where ``with_masks``)."""
        bs, d = bev.shape[0], self.embed_dims
        shapes = ((self.bev_h, self.bev_w),)
        pos = sine_positional_encoding(self.bev_h, self.bev_w, d // 2,
                                       device=bev.device).reshape(1, -1, d)
        pos = pos.expand(bs, -1, d).to(bev.dtype)
        memory = bev
        enc_ref = self._encoder_ref_points(bs, bev.device)
        for i in range(self.num_enc_layers):
            memory = getattr(self, f'encoder_{i}')(memory, enc_ref, shapes,
                                                   pos=pos)

        qe = self.query_embedding
        query_pos = qe[None, :, :d].expand(bs, -1, d)
        query = qe[None, :, d:].expand(bs, -1, d)
        ref = torch.sigmoid(self.reference_points_fc(query_pos))
        inter_states, inter_refs = [], []
        for lid in range(self.num_dec_layers):
            query = getattr(self, f'decoder_{lid}')(
                query, memory, ref[:, :, None, :], shapes,
                query_pos=query_pos)
            inter_states.append(query)
            inter_refs.append(ref)
            if self.with_box_refine:
                tmp = getattr(self, f'reg_branches_{lid}')(query)
                ref = torch.sigmoid(tmp[..., :2] +
                                    inverse_sigmoid(ref)).detach()

        classes, coords = [], []
        for lid in range(self.num_dec_layers):
            classes.append(getattr(self, f'cls_branches_{lid}')(
                inter_states[lid]))
            tmp = getattr(self, f'reg_branches_{lid}')(inter_states[lid])
            tmp = torch.cat([tmp[..., :2] + inverse_sigmoid(inter_refs[lid]),
                             tmp[..., 2:]], -1)
            coords.append(torch.sigmoid(tmp))
        out = dict(outputs_classes=torch.stack(classes),
                   outputs_coords=torch.stack(coords),
                   args_tuple=(memory, None, pos, inter_states[-1], None,
                               query_pos, shapes),
                   reference=ref)
        if with_masks:
            k = min(self.num_mask_queries, self.num_query)
            top = stable_topk(torch.sigmoid(classes[-1]).amax(-1), k)
            idx = top[..., None].expand(-1, -1, d)
            out['masks'] = self.forward_masks(
                memory, pos, torch.gather(inter_states[-1], 1, idx),
                torch.gather(query_pos, 1, idx))
            out['masks']['thing_index'] = top
        return out

    def forward_masks(self, memory, memory_pos, thing_query,
                      thing_query_pos):
        """Both mask decoders on thing queries [B, K, D] -> per-query BEV
        masks and the per-layer class logits."""
        bs, d = memory.shape[0], self.embed_dims
        attn_t, masks_t, inter_t = self.things_mask_head(
            memory, memory_pos, thing_query, thing_query_pos)
        sq = self.stuff_query
        attn_s, masks_s, inter_s = self.stuff_mask_head(
            memory, memory_pos, sq[None, :, d:].expand(bs, -1, d),
            sq[None, :, :d].expand(bs, -1, d))
        hw = (self.bev_h, self.bev_w)

        def to_map(m):            # [B, N, L, 1] -> [B, N, H, W]
            return m[..., 0].reshape(m.shape[0], m.shape[1], *hw)

        return dict(
            thing_masks=to_map(attn_t), stuff_masks=to_map(attn_s),
            thing_masks_inter=[to_map(m) for m in masks_t],
            stuff_masks_inter=[to_map(m) for m in masks_s],
            thing_cls=[getattr(self, f'cls_thing_branches_{i}')(inter_t[i])
                       for i in range(self.num_thing_mask_layers)],
            stuff_cls=[getattr(self, f'cls_stuff_branches_{i}')(inter_s[i])
                       for i in range(self.num_stuff_mask_layers)])


def _cxcywh_to_xyxy(b):
    cx, cy, w, h = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def giou(boxes1, boxes2):
    """Generalised IoU of [..., 4] xyxy boxes."""
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    a1 = ((boxes1[..., 2] - boxes1[..., 0]) *
          (boxes1[..., 3] - boxes1[..., 1]))
    a2 = ((boxes2[..., 2] - boxes2[..., 0]) *
          (boxes2[..., 3] - boxes2[..., 1]))
    union = a1 + a2 - inter
    iou = inter / union.clamp(min=1e-7)
    elt = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    erb = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    ewh = (erb - elt).clamp(min=0.0)
    enclose = (ewh[..., 0] * ewh[..., 1]).clamp(min=1e-7)
    return iou - (enclose - union) / enclose


def panseg_loss_single(cls_scores, bbox_preds, gt_labels, gt_boxes,
                       num_valid_gt, num_things_classes: int = 3,
                       cls_weight: float = 2.0, bbox_weight: float = 5.0,
                       iou_weight: float = 2.0):
    """One decoder layer's DETR loss of one sample: cls_scores [Q, C],
    bbox_preds [Q, 4] cxcywh in [0, 1], gt_labels [G], gt_boxes [G, 4],
    num_valid_gt [] -> dict(loss_cls, loss_bbox, loss_iou, assign [Q])."""
    g = gt_boxes.shape[0]
    cls_cost = focal_loss_cost(cls_scores.float(), gt_labels.clamp(min=0),
                               weight=cls_weight)
    l1_cost = (bbox_preds[:, None] - gt_boxes[None]).abs().sum(-1)
    giou_cost = -giou(_cxcywh_to_xyxy(bbox_preds)[:, None],
                      _cxcywh_to_xyxy(gt_boxes)[None])
    cost = cls_cost + bbox_weight * l1_cost + iou_weight * giou_cost
    assign = hungarian_assign(cost, num_valid_gt)
    matched = assign >= 0
    safe = assign.clamp(0, g - 1)
    labels = torch.where(matched, gt_labels.long()[safe],
                         torch.full_like(safe, num_things_classes))
    loss_cls = sigmoid_focal_loss(cls_scores, labels,
                                  num_things_classes).sum() * cls_weight
    tgt = gt_boxes[safe]
    mw = matched.float()
    loss_bbox = ((bbox_preds - tgt).abs().sum(-1) * mw).sum() * bbox_weight
    loss_iou = ((1.0 - giou(_cxcywh_to_xyxy(bbox_preds),
                            _cxcywh_to_xyxy(tgt))) * mw).sum() * iou_weight
    denom = num_valid_gt.float().clamp(min=1.0)
    return dict(loss_cls=loss_cls / denom, loss_bbox=loss_bbox / denom,
                loss_iou=loss_iou / denom, assign=assign)
