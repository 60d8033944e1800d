"""Weight bridge: a JAX/flax ``ViDAR`` parameter tree -> a state dict that
``vidar_tpu_torch.models.ViDAR`` loads with ``strict=True``.

The port names its modules after the flax modules, so a key is the flax
path joined by dots, with the leaf renamed and transformed:

* ``kernel`` of a conv, HWIO -> ``weight`` OIHW;
* ``kernel`` of a deformable conv (the module holding a ``conv_offset``),
  [(ky kx cin), out] -> ``kernel`` unchanged (the layout K2 takes);
* any other ``kernel`` (a Dense), [in, out] -> ``weight`` [out, in];
* ``scale``/``bias`` of a frozen BatchNorm (``bn*``, ``downsample_bn``)
  -> the buffers ``scale``/``bias``;
* ``scale`` of a LayerNorm -> ``weight``;
* ``bias`` and the embedding tables keep their names.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch

_FROZEN_BN = re.compile(r'^(bn\d+|downsample_bn)$')


def _leaf(parent: Mapping, path, name: str, arr: np.ndarray):
    """-> (torch leaf name, transformed array)."""
    if name == 'kernel':
        if arr.ndim == 4:
            return 'weight', arr.transpose(3, 2, 0, 1)
        if 'conv_offset' in parent:
            return 'kernel', arr
        return 'weight', arr.T
    if name == 'scale' and not (path and _FROZEN_BN.match(path[-1])):
        return 'weight', arr
    return name, arr


def state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Nested dict of arrays (a flax variables dict, with or without the
    top ``params`` level) -> {torch key: f32 tensor}."""
    tree = params['params'] if 'params' in params else params
    out = {}

    def walk(node, path):
        for name, value in node.items():
            if isinstance(value, Mapping):
                walk(value, path + (name,))
                continue
            leaf, arr = _leaf(node, path, name, np.asarray(value))
            out['.'.join(path + (leaf,))] = torch.from_numpy(
                np.ascontiguousarray(arr, dtype=np.float32))

    walk(tree, ())
    return out
