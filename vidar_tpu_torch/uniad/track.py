"""Query-based multi-object tracking with a fixed capacity (port of
vidar_tpu/uniad/track.py).

``TrackInstances`` is a dataclass of tensors ``[..., cap, X]`` with
``replace``: births fill free slots, deaths free them, shapes never change.
``RuntimeTracker.update`` is the vectorised birth/death rule, object ids
allocated by a cumulative sum over the birth mask. ``QueryInteractionModule``
and ``MemoryBank`` refresh the track queries between frames.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn

from ..models.layers import (LayerNorm, MultiHeadDotProductAttention,
                             TorchLinear)


@dataclasses.dataclass
class TrackInstances:
    """Fixed-capacity instance store (struct of tensors, [..., cap, X])."""
    query: torch.Tensor           # [..., cap, 2C] (pos + content)
    ref_points: torch.Tensor      # [..., cap, 3]
    obj_idxes: torch.Tensor       # [..., cap] int64, -1 = unassigned slot
    scores: torch.Tensor          # [..., cap]
    pred_boxes: torch.Tensor      # [..., cap, 10] normalised code
    pred_logits: torch.Tensor     # [..., cap, num_classes]
    disappear_time: torch.Tensor  # [..., cap] int64
    next_obj_id: torch.Tensor     # [...] int64
    memory: torch.Tensor          # [..., cap, M, C] past content FIFO

    def replace(self, **changes) -> 'TrackInstances':
        return dataclasses.replace(self, **changes)

    @staticmethod
    def empty(capacity: int, embed_dims: int, num_classes: int,
              query_init: torch.Tensor, ref_init: torch.Tensor,
              memory_len: int = 0, batch_shape: Tuple[int, ...] = ()):
        b = tuple(batch_shape)
        dev = query_init.device
        return TrackInstances(
            query=query_init.expand(b + tuple(query_init.shape)),
            ref_points=ref_init.expand(b + tuple(ref_init.shape)),
            obj_idxes=torch.full(b + (capacity,), -1, dtype=torch.int64,
                                 device=dev),
            scores=torch.zeros(b + (capacity,), device=dev),
            pred_boxes=torch.zeros(b + (capacity, 10), device=dev),
            pred_logits=torch.zeros(b + (capacity, num_classes), device=dev),
            disappear_time=torch.zeros(b + (capacity,), dtype=torch.int64,
                                       device=dev),
            next_obj_id=torch.zeros(b, dtype=torch.int64, device=dev),
            memory=torch.zeros(b + (capacity, memory_len, embed_dims),
                               device=dev),
        )


class RuntimeTracker:
    """Score-thresholded track birth and death (reference tracker.py:6-41)."""

    def __init__(self, score_thresh: float = 0.4,
                 filter_score_thresh: float = 0.35,
                 miss_tolerance: int = 5):
        self.score_thresh = score_thresh
        self.filter_score_thresh = filter_score_thresh
        self.miss_tolerance = miss_tolerance

    def update(self, tr: TrackInstances) -> TrackInstances:
        confident = tr.scores >= self.score_thresh
        disappear = torch.where(confident, torch.zeros_like(
            tr.disappear_time), tr.disappear_time)
        # births: unassigned slots that became confident
        birth = (tr.obj_idxes == -1) & confident
        birth_rank = torch.cumsum(birth.long(), -1) - 1
        new_ids = torch.where(birth, tr.next_obj_id[..., None] + birth_rank,
                              tr.obj_idxes)
        # deaths: assigned slots below the filter threshold for too long
        weak = (tr.obj_idxes >= 0) & (tr.scores < self.filter_score_thresh)
        disappear = torch.where(weak, disappear + 1, disappear)
        dead = disappear >= self.miss_tolerance
        return tr.replace(
            obj_idxes=torch.where(dead, torch.full_like(new_ids, -1),
                                  new_ids),
            disappear_time=torch.where(dead, torch.zeros_like(disappear),
                                       disappear),
            next_obj_id=tr.next_obj_id + birth.sum(-1))


class QueryInteractionModule(nn.Module):
    """Track-query refresh between frames: an active track's content is
    updated from its prediction by a gated MLP; a dead slot is re-seeded
    from the learned initial query."""

    def __init__(self, embed_dims: int = 256, dtype=None, device=None):
        super().__init__()
        self.embed_dims = embed_dims
        kw = dict(dtype=dtype, device=device)
        self.box_proj = TorchLinear(10, embed_dims, **kw)
        self.ln_in = LayerNorm(embed_dims, device)
        self.fc1 = TorchLinear(embed_dims, embed_dims, **kw)
        self.fc2 = TorchLinear(embed_dims, embed_dims, **kw)
        self.gate = TorchLinear(embed_dims, embed_dims, **kw)
        self.ln_out = LayerNorm(embed_dims, device)

    def forward(self, tr: TrackInstances, init_query: torch.Tensor
                ) -> TrackInstances:
        d = self.embed_dims
        content = tr.query[..., d:]
        h = self.ln_in(content + self.box_proj(tr.pred_boxes))
        upd = self.fc2(torch.relu(self.fc1(h)))
        gate = torch.sigmoid(self.gate(h))
        new_content = self.ln_out(content * (1 - gate) + upd * gate)
        active = (tr.obj_idxes >= 0)[..., None]
        content_out = torch.where(active, new_content, init_query[..., d:])
        pos_out = torch.where(active, tr.query[..., :d], init_query[..., :d])
        return tr.replace(query=torch.cat([pos_out, content_out], -1))


class MemoryBank(nn.Module):
    """Per-track memory of past content embeddings (a FIFO of
    ``memory_len``), attended by the current content."""

    def __init__(self, embed_dims: int = 256, memory_len: int = 4, dtype=None,
                 device=None):
        super().__init__()
        self.mem_attn = MultiHeadDotProductAttention(embed_dims, 8,
                                                     dtype=dtype,
                                                     device=device)
        self.ln = LayerNorm(embed_dims, device)

    def forward(self, content, memory, active):
        """content [..., cap, C], memory [..., cap, M, C], active [..., cap]
        -> (fused, new_memory)."""
        attn = self.mem_attn(content[..., None, :], memory, memory)
        fused = self.ln(content + attn[..., 0, :])
        fused = torch.where(active[..., None], fused, content)
        new_memory = torch.cat([memory[..., 1:, :], fused[..., None, :]], -2)
        new_memory = torch.where(active[..., None, None], new_memory, memory)
        return fused, new_memory
