"""The UniAD task heads under one import path (port of
vidar_tpu/uniad/heads.py)."""

from .motion_head import (MotionDeformableAttention, MotionHead,
                          MotionTransformerAttentionLayer, default_anchors,
                          min_ade, min_fde, miss_rate, traj_loss, traj_nll)
from .occ_head import (Bottleneck, CVTDecoder, OccHead, SimpleConv2d,
                       UpsamplingAdd, dice_loss_with_masks,
                       fiery_binary_seg_loss)
from .panseg_head import (AttentionTail, MaskAttention, PansegformerHead,
                          SegMaskHead, giou, panseg_loss_single)
from .planning_head import (PlanningHeadSingleMode, collision_optimize,
                            planning_loss)

__all__ = [
    'MotionHead', 'MotionDeformableAttention',
    'MotionTransformerAttentionLayer', 'default_anchors', 'traj_loss',
    'min_ade', 'min_fde', 'miss_rate', 'traj_nll',
    'OccHead', 'SimpleConv2d', 'Bottleneck', 'UpsamplingAdd', 'CVTDecoder',
    'fiery_binary_seg_loss', 'dice_loss_with_masks',
    'PansegformerHead', 'SegMaskHead', 'MaskAttention', 'AttentionTail',
    'panseg_loss_single', 'giou',
    'PlanningHeadSingleMode', 'collision_optimize', 'planning_loss',
]
