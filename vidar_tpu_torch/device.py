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


def use_f32_convolutions(model: torch.nn.Module) -> None:
    """Make cuDNN compute the convolutions of a model that computes in f32
    in f32 (``torch.backends.cudnn.allow_tf32 = False``; the caller restores
    the switch). PyTorch's default lets cuDNN round f32 convolutions to
    TF32, a 10-bit mantissa, which moves the released f32 fine-tune's loss
    terms by percents (ROADMAP.md §3). A model with a layer of another
    compute dtype (bf16) keeps the switch as it is."""
    if all(getattr(m, 'dtype', None) in (None, torch.float32)
           for m in model.modules()):
        torch.backends.cudnn.allow_tf32 = False
