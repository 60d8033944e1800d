"""Where the port's entry points build: on the card unless the caller asks
for another device."""

from __future__ import annotations

import torch


def resolve_device(device='cuda') -> torch.device:
    """``device`` as a ``torch.device`` ('cuda' when None); raise when it
    names a CUDA device and none is present, rather than fall back to the
    CPU. Only an explicit ``device='cpu'`` runs on the CPU."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f'device {dev}: no CUDA device is present; pass device="cpu" '
            f'to run on the CPU')
    return dev
