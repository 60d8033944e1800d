"""Config-driven model and dataset construction (the port of
vidar_tpu/core/builder.py: the mmcv Registry + ``build_from_cfg`` contract,
SURVEY §5: the ``type`` leaf selects the class, the rest are its keyword
arguments)."""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict

import torch

MODELS: Dict[str, Callable] = {}
DATASETS: Dict[str, Callable] = {}

# registered by the JAX package's builder, not ported yet (ROADMAP.md queue 1)
NOT_PORTED = ()


def _model_registry():
    if not MODELS:
        from ..models import BEVFormer, BEVFormerFP16, BEVFormerV2, ViDAR
        from ..uniad import UniAD, UniADTrack
        MODELS.update(ViDAR=ViDAR, BEVFormer=BEVFormer,
                      BEVFormer_fp16=BEVFormerFP16,
                      BEVFormerFP16=BEVFormerFP16, BEVFormerV2=BEVFormerV2,
                      UniAD=UniAD, UniADTrack=UniADTrack)
    return MODELS


def _dataset_registry():
    if not DATASETS:
        from ..data.nuplan import NuPlanViDARDataset
        from ..data.nuscenes import NuScenesDetDataset, NuScenesViDARDataset
        from ..data.uniad_data import UniADDataset
        DATASETS.update(
            NuScenesViDARDatasetV1=NuScenesViDARDataset,
            NuScenesViDARDataset=NuScenesViDARDataset,
            CustomNuScenesDataset=NuScenesDetDataset,
            NuScenesDetDataset=NuScenesDetDataset,
            NuPlanViDARDatasetV1=NuPlanViDARDataset,
            NuPlanViDARDataset=NuPlanViDARDataset,
            UniADDataset=UniADDataset,
        )
    return DATASETS


def _lookup(reg, name: str, kind: str):
    if name in NOT_PORTED:
        raise KeyError(f'{kind} type {name!r} is not ported to '
                       f'vidar_tpu_torch yet')
    if name not in reg:
        raise KeyError(f'unknown {kind} type {name!r}; have {sorted(reg)}')
    return reg[name]


def _normalize(cfg: Dict[str, Any]) -> Dict[str, Any]:
    # underscore leaves are runtime flags read by the CLIs
    # (e.g. _submission / _submission_path), not ctor kwargs
    out = {k: copy.deepcopy(v) for k, v in dict(cfg).items()
           if not k.startswith('_') and k != 'type'}
    for k, v in out.items():
        if isinstance(v, list):
            out[k] = tuple(tuple(e) if isinstance(e, list) else e for e in v)
    return out


def build_model(model_cfg: Dict[str, Any], **overrides):
    """Instantiate the model named by ``model_cfg['type']`` (default ViDAR);
    ``overrides`` (e.g. ``device``) are passed on."""
    cls = _lookup(_model_registry(), model_cfg.get('type', 'ViDAR'), 'model')
    kwargs = _normalize(model_cfg)
    # the JAX train CLI sets remat=True on a ViDAR (vidar_tpu/tools/train.py:
    # 67-72); the port's train forward always checkpoints the backbone camera
    # by camera (models/vidar.py:extract_feats_cam_seq), so it has no switch
    kwargs.pop('remat', None)
    dtype = kwargs.get('dtype')
    if isinstance(dtype, str):         # --cfg-options model.dtype=bfloat16
        # float32 is the models' default compute dtype, None
        kwargs['dtype'] = None if dtype == 'float32' else getattr(torch,
                                                                  dtype)
    kwargs.update(overrides)
    return cls(**kwargs)


def build_dataset(data_cfg: Dict[str, Any], **overrides):
    cls = _lookup(_dataset_registry(),
                  data_cfg.get('type', 'NuScenesViDARDataset'), 'dataset')
    kwargs = _normalize(data_cfg)
    # dataset kwargs stay plain python (host side)
    kwargs = {k: (list(v) if isinstance(v, tuple) and k == 'classes' else v)
              for k, v in kwargs.items()}
    kwargs.update(overrides)
    return cls(**kwargs)
