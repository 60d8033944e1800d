"""3D box helpers of the detection fine-tune (port of vidar_tpu/core/bbox.py):
the box codec, the focal loss, the matching costs, the Hungarian assignment
and the NMS-free top-k decode.

``hungarian_assign`` solves the assignment with scipy on the host, as the
JAX package's ``pure_callback`` does (``_lap_host``, bbox.py:78-88): one
device-to-host copy of the cost and one ``linear_sum_assignment`` per call;
with ``impl='auction'`` it runs ``auction_assign`` (bbox.py:91-145), the
jittable epsilon auction, as plain PyTorch on the cost's device.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

POST_CENTER_RANGE = (-61.2, -61.2, -10.0, 61.2, 61.2, 10.0)


def stable_topk(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest along the last dim, equal values in index
    order (``jax.lax.top_k``'s tie rule)."""
    return torch.sort(x, dim=-1, descending=True, stable=True)[1][..., :k]


def normalize_bbox(bboxes: torch.Tensor) -> torch.Tensor:
    """[..., 9] (cx cy cz w l h rot vx vy) -> [..., 10] network format
    (cx cy log w, log l, cz, log h, sin rot, cos rot, vx, vy)."""
    rot = bboxes[..., 6:7]
    return torch.cat([bboxes[..., 0:2], torch.log(bboxes[..., 3:5]),
                      bboxes[..., 2:3], torch.log(bboxes[..., 5:6]),
                      torch.sin(rot), torch.cos(rot), bboxes[..., 7:9]], -1)


def denormalize_bbox(nb: torch.Tensor) -> torch.Tensor:
    """[..., 10] network format -> [..., 9] (cx cy cz w l h rot vx vy)."""
    rot = torch.atan2(nb[..., 6:7], nb[..., 7:8])
    return torch.cat([nb[..., 0:2], nb[..., 4:5], torch.exp(nb[..., 2:4]),
                      torch.exp(nb[..., 5:6]), rot, nb[..., 8:10]], -1)


def sigmoid_focal_loss(logits: torch.Tensor, labels: torch.Tensor,
                       num_classes: int, alpha: float = 0.25,
                       gamma: float = 2.0) -> torch.Tensor:
    """Per-element focal loss [..., num_classes]; ``labels == num_classes``
    is background (mmdet's sum over the result)."""
    onehot = F.one_hot(labels.long(), num_classes + 1)[..., :num_classes]
    onehot = onehot.to(logits.dtype)
    p = torch.sigmoid(logits)
    ce = (-onehot * F.logsigmoid(logits) -
          (1 - onehot) * F.logsigmoid(-logits))
    p_t = p * onehot + (1 - p) * (1 - onehot)
    alpha_t = alpha * onehot + (1 - alpha) * (1 - onehot)
    return alpha_t * ((1 - p_t) ** gamma) * ce


def focal_loss_cost(cls_logits: torch.Tensor, gt_labels: torch.Tensor,
                    alpha: float = 0.25, gamma: float = 2.0,
                    eps: float = 1e-12, weight: float = 2.0) -> torch.Tensor:
    """mmdet FocalLossCost: cost[q, g] = pos_cost[q, label_g] -
    neg_cost[q, label_g], times ``weight``. [Q, C], [G] -> [Q, G]."""
    scores = torch.sigmoid(cls_logits)
    neg_cost = (1 - alpha) * (scores ** gamma) * (-torch.log(1 - scores + eps))
    pos_cost = alpha * ((1 - scores) ** gamma) * (-torch.log(scores + eps))
    idx = gt_labels.long()
    return (pos_cost[:, idx] - neg_cost[:, idx]) * weight


def bbox3d_l1_cost(bbox_pred: torch.Tensor, gt_normalized: torch.Tensor,
                   weight: float = 0.25) -> torch.Tensor:
    """L1 distance over the first 8 code dims, times ``weight``: [Q, 10],
    [G, 10] -> [Q, G]."""
    diff = (bbox_pred[:, None, :8] - gt_normalized[None, :, :8]).abs()
    return diff.sum(-1) * weight


def auction_assign(cost: torch.Tensor, num_valid_gt, eps_scale: float = 1e-3,
                   max_iters: int = 512, return_iters: bool = False):
    """The auction algorithm for the tall assignment (bbox.py:91-145), on
    cost's device: the valid GTs bid for queries over value = -cost, one
    epsilon pass, eps = max(value span, 1) * eps_scale. Each round every
    unassigned valid GT bids (best - second best + eps) for its best query
    (the first on a tie); the highest bid per query wins, the lowest GT
    index among equal bids; a won query's owner is replaced and its price
    rises by max(winning bid, eps); rounds stop when every valid GT owns a
    query or after ``max_iters``. Within G * eps of the optimum.
    cost [Q, G] -> [Q] int64 GT index or -1 (and the rounds run, where
    ``return_iters``)."""
    qn, g = cost.shape
    dev = cost.device
    value = -cost.detach().float().T                            # [G, Q]
    eps = (value.max() - value.min()).clamp(min=1.0) * eps_scale
    gt_valid = torch.arange(g, device=dev) < int(num_valid_gt)
    gt_idx = torch.arange(g, device=dev)
    prices = torch.zeros(qn, device=dev)
    owner = torch.full((qn,), -1, dtype=torch.int64, device=dev)
    neg_inf = torch.tensor(-float('inf'), device=dev)

    def unassigned():
        assigned = torch.zeros(g + 1, dtype=torch.bool, device=dev)
        assigned[torch.where(owner >= 0, owner, g)] = True
        return gt_valid & ~assigned[:g]

    it = 0
    bidders = unassigned()
    while it < max_iters and bool(bidders.any()):
        net = value - prices[None, :]
        best_q = net.argmax(1)                     # the first on a tie
        best_v = net.gather(1, best_q[:, None])[:, 0]
        second_v = net.scatter(1, best_q[:, None], -float('inf')).amax(1)
        bid = torch.where(bidders, best_v - second_v + eps, neg_inf)
        # the highest bid per query, then the lowest GT index that bid it
        winners_bid = torch.full((qn,), -float('inf'), device=dev
                                 ).scatter_reduce(0, best_q, bid, 'amax')
        is_winner = (bidders & (bid >= winners_bid[best_q]) &
                     torch.isfinite(bid))
        winner_gt = torch.full((qn,), g, dtype=torch.int64, device=dev
                               ).scatter_reduce(
            0, best_q, torch.where(is_winner, gt_idx, g), 'amin')
        has_winner = winner_gt < g
        owner = torch.where(has_winner, winner_gt, owner)
        prices = torch.where(has_winner,
                             prices + torch.maximum(winners_bid, eps),
                             prices)
        it += 1
        bidders = unassigned()
    return (owner, it) if return_iters else owner


def hungarian_assign(cost: torch.Tensor, num_valid_gt,
                     impl: str = 'auto') -> torch.Tensor:
    """Optimal assignment of the first ``num_valid_gt`` columns of cost
    [Q, G]; the cost is detached: no gradient flows through the
    assignment. Returns [Q] int64 on cost's device: the gt index of each
    query, -1 where unassigned. ``impl``: 'scipy' (exact, on the host),
    'auction' (``auction_assign``, on the device) or 'auto', which is scipy
    here: JAX's 'auto' picks the auction only where its device relay has
    no host callbacks (bbox.py:166-171), and the card has none such."""
    if impl == 'auction':
        return auction_assign(cost, num_valid_gt)
    if impl not in ('auto', 'scipy'):
        raise ValueError(f'hungarian_assign impl {impl!r}')
    from scipy.optimize import linear_sum_assignment
    c = cost.detach().float().cpu().numpy()
    out = np.full((c.shape[0],), -1, np.int64)
    n = int(num_valid_gt)
    if n > 0:
        rows, cols = linear_sum_assignment(c[:, :n])
        out[rows] = cols
    return torch.from_numpy(out).to(cost.device)


def nms_free_decode(cls_logits: torch.Tensor, bbox_preds: torch.Tensor, *,
                    max_num: int = 300, num_classes: int = 10,
                    post_center_range: Sequence[float] = POST_CENTER_RANGE
                    ) -> Dict[str, torch.Tensor]:
    """Top-k decode of one sample (reference nms_free_coder.py:41-100):
    cls_logits [Q, C], bbox_preds [Q, 10] -> dict(bboxes [K, 9], scores
    [K], labels [K], valid [K]), K = min(max_num, Q * C)."""
    scores = torch.sigmoid(cls_logits).reshape(-1)
    top_scores, idx = torch.topk(scores, min(max_num, scores.numel()))
    labels = idx % num_classes
    boxes = denormalize_bbox(bbox_preds[idx // num_classes])
    pcr = torch.tensor(post_center_range, dtype=boxes.dtype,
                       device=boxes.device)
    valid = ((boxes[:, :3] >= pcr[:3]).all(-1) &
             (boxes[:, :3] <= pcr[3:]).all(-1))
    return dict(bboxes=boxes, scores=top_scores, labels=labels, valid=valid)
