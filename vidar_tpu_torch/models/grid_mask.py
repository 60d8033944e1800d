"""GridMask augmentation (port of vidar_tpu/models/grid_mask.py:22-50):
mode 1, ratio 0.5, prob 0.7, no rotation. One square grid of period d in
[2, H) masks all images of the call: pixel (y, x) is kept iff its row or its
column lies on a grid bar, ``((y + off_h - st_h) mod d) < l`` (the same for
x), where the offsets reproduce the reference's crop of a 1.5x canvas.

The draws come from an explicit ``torch.Generator``; they are not the JAX
package's draws (another generator), only the same distribution.
"""

from __future__ import annotations

from typing import Optional

import torch


def grid_mask(generator: Optional[torch.Generator], images: torch.Tensor, *,
              ratio: float = 0.5, prob: float = 0.7,
              mode: int = 1) -> torch.Tensor:
    """Apply GridMask to [N, H, W, C] images (one shared mask)."""
    _, h, w, _ = images.shape
    dev = images.device
    gdev = generator.device if generator is not None else 'cpu'

    def randint(low, high):
        return int(torch.randint(low, high, (), generator=generator,
                                 device=gdev))

    d = randint(2, h)
    length = min(max(int(d * ratio + 0.5), 1), d - 1)
    st_h = randint(0, d)
    st_w = randint(0, d)
    if float(torch.rand((), generator=generator, device=gdev)) >= prob:
        return images
    off_h = (int(1.5 * h) - h) // 2
    off_w = (int(1.5 * w) - w) // 2
    ys = torch.arange(h, device=dev)
    xs = torch.arange(w, device=dev)
    row_masked = ((ys + off_h - st_h) % d) < length
    col_masked = ((xs + off_w - st_w) % d) < length
    drop = row_masked[:, None] | col_masked[None, :]
    keep = drop if mode == 1 else ~drop   # mode 1 inverts: bars survive
    return images * keep.to(images.dtype)[None, :, :, None]
