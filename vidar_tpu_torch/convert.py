"""Weight bridge: a JAX/flax parameter tree (``ViDAR``, ``BEVFormer``,
``BEVFormerV2``, ``UniAD``, and the backbones and heads beside them) -> a state dict that the port's model of the same name loads with
``strict=True``.

The port names its modules after the flax modules, so a key is the flax
path joined by dots, with the leaf renamed and transformed:

* ``kernel`` of a conv, HWIO -> ``weight`` OIHW (a depthwise conv's
  [kh, kw, 1, C] -> [C, 1, kh, kw]);
* ``kernel`` of a deformable conv (the module holding a ``conv_offset``),
  [(ky kx cin), out] -> ``kernel`` unchanged (the layout K2 takes);
* the DenseGeneral ``kernel``s of flax's multi-head attention, ``query``,
  ``key``, ``value`` [in, heads, head_dim] and ``out`` [heads, head_dim,
  out], flattened to [in, out] first, and their [heads, head_dim] biases
  flattened;
* any other ``kernel`` (a Dense), [in, out] -> ``weight`` [out, in];
* ``scale``/``bias`` of a frozen BatchNorm (``bn*``, ``downsample_bn``,
  VoVNet's ``*_bn``) -> the buffers ``scale``/``bias``;
* ``scale`` of a LayerNorm or GroupNorm -> ``weight``; a scalar ``scale``
  (DD3D's learned scales) keeps its name;
* ``bias``, the embedding tables and other leaves (InternImage's layer
  scales ``gamma1``/``gamma2``, DD3D's ``offset``) keep their names.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch

_FROZEN_BN = re.compile(r'^(bn\d+|downsample_bn|\w+_bn)$')


def _leaf(parent: Mapping, path, name: str, arr: np.ndarray):
    """-> (torch leaf name, transformed array)."""
    if name == 'kernel':
        if arr.ndim == 4:
            return 'weight', arr.transpose(3, 2, 0, 1)
        if 'conv_offset' in parent:
            return 'kernel', arr
        if arr.ndim == 3:          # DenseGeneral of an attention block
            flat = (arr.reshape(-1, arr.shape[-1]) if path[-1] == 'out'
                    else arr.reshape(arr.shape[0], -1))
            return 'weight', flat.T
        return 'weight', arr.T
    if name == 'bias' and arr.ndim == 2:
        return 'bias', arr.reshape(-1)
    if name == 'scale' and arr.ndim and not (path and
                                            _FROZEN_BN.match(path[-1])):
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
                np.array(arr, dtype=np.float32, order='C'))

    walk(tree, ())
    return out
