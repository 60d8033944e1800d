"""Standalone loss functions (port of vidar_tpu/train/losses.py).

``label_smoothing_loss`` matches reference
bevformer/losses/label_smoothing.py:9-40 (in the reference registry, unused
by the released configs).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def label_smoothing_loss(logits: torch.Tensor, labels: torch.Tensor,
                         smoothing: float = 0.1,
                         weights: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """KL(smooth one-hot || softmax(logits)), the mean over the (weighted)
    elements. logits [..., C], labels [...] int, weights [...]."""
    num_classes = logits.shape[-1]
    conf = 1.0 - smoothing
    low = smoothing / max(num_classes - 1, 1)
    onehot = F.one_hot(labels.long(), num_classes).to(logits.dtype)
    target = onehot * conf + (1.0 - onehot) * low
    loss = -(target * F.log_softmax(logits, dim=-1)).sum(-1)
    if weights is not None:
        return (loss * weights).sum() / weights.sum().clamp(min=1.0)
    return loss.mean()
