"""The presets of vidar_tpu/configs.py that the port runs, as plain dicts.

Kept here so that the port and ``chip_smoke.py`` import nothing of the JAX
package; ``tests/test_torch_package_import.py`` holds them equal to the JAX
package's presets.
"""

from __future__ import annotations

from typing import Any, Dict

POINT_CLOUD_RANGE = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)

LATENT_RENDER_CFG = dict(embed_dims=256, pred_height=16, num_pred_fcs=0,
                         grid_step=0.5, grid_num=256, reduction=16,
                         act='sigmoid')


def vidar_base(**overrides) -> Dict[str, Any]:
    """vidar_1_8_nusc_3future: the flagship forecast model."""
    cfg = dict(
        embed_dims=256,
        bev_h=200,
        bev_w=200,
        pc_range=POINT_CLOUD_RANGE,
        num_cams=6,
        backbone_depth=101,
        backbone_dcn=(False, False, True, True),
        frozen_stages=1,
        future_pred_frame_num=3,
        test_future_frame_num=6,
        history_queue_length=4,
        supervise_all_future=True,
        pred_history_frame_num=3,
        pred_future_frame_num=1,
        per_frame_loss_weight=(0.2, 0.4, 0.6, 1.0, 1.2),
        loss_weight=((1,), (1,), (1,), (1,), (0,)),
        num_pred_height=16,
        ray_grid_num=512,
        ray_grid_step=1.0,
        use_ce_loss=True,
        use_dist_loss=False,
        use_dense_loss=True,
        decoder_num_layers=3,
        encoder_num_layers=6,
        latent_render_lids=(2,),
        latent_render_cfg=dict(LATENT_RENDER_CFG),
        sca_capacity_ratio=0.30,
    )
    cfg.update(overrides)
    return cfg


def vidar_tiny(**overrides) -> Dict[str, Any]:
    """Small config for tests and smoke runs (ResNet-50 at full width)."""
    cfg = vidar_base(
        embed_dims=32,
        bev_h=16,
        bev_w=16,
        num_cams=3,
        backbone_depth=50,
        future_pred_frame_num=1,
        test_future_frame_num=2,
        history_queue_length=2,
        pred_history_frame_num=1,
        pred_future_frame_num=1,
        per_frame_loss_weight=(0.5, 1.0, 1.2),
        loss_weight=((1,), (1,), (0,)),
        num_pred_height=4,
        ray_grid_num=16,
        decoder_num_layers=2,
        encoder_num_layers=2,
        latent_render_lids=(1,),
        latent_render_cfg=dict(embed_dims=32, pred_height=4, grid_num=8,
                               grid_step=0.5, reduction=8, act='sigmoid',
                               num_pred_fcs=0),
    )
    cfg.update(overrides)
    return cfg


def vidar_dryrun(**overrides) -> Dict[str, Any]:
    """``vidar_tiny`` with one encoder and one decoder layer."""
    return vidar_tiny(encoder_num_layers=1, decoder_num_layers=1,
                      latent_render_lids=(0,), **overrides)
