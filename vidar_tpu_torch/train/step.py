"""The train steps (port of ``make_train_step`` and
``make_det_train_step``, vidar_tpu/train/step.py:62-157).

``TrainStep``, the pre-training step: one call runs the train forward of
``ViDAR`` (grid mask, frozen history, the current frame with gradient, the
gated rollout, the ray CE and dense chamfer losses), the backward pass and
the clipped AdamW update, and returns the step's metrics. ``DetTrainStep``,
the fine-tune step: the train forward of ``BEVFormer``, its
Hungarian-matched focal + L1 loss, the backward pass and the update."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..device import resolve_device
from ..models.encoder import sca_overflow_count


class _Step:
    """What both steps share: the model, its optimizer, the generator of
    its random draws, and the backward pass and update of a loss dict."""

    def __init__(self, model, optimizer, *,
                 generator: Optional[torch.Generator] = None, device='cuda'):
        self.device = resolve_device(device)
        self.model = model
        self.optimizer = optimizer
        self.generator = generator

    def backward(self, total: torch.Tensor) -> None:
        """The step's backward pass (a method, so a profiler can time it)."""
        total.backward()

    def _update(self, losses) -> Dict[str, float]:
        """Backward of the sum of ``losses`` and the clipped update -> every
        loss, ``loss`` and ``grad_norm`` as Python numbers."""
        total = sum(losses.values())
        self.backward(total)
        grad_norm = self.optimizer.step()
        metrics = {k: float(v.detach()) for k, v in losses.items()}
        metrics['loss'] = float(total.detach())
        metrics['grad_norm'] = float(grad_norm)
        return metrics


class TrainStep(_Step):
    """``step(batch) -> metrics``: every loss, ``loss`` (their sum),
    ``grad_norm`` (the global norm before clipping, as
    ``optax.global_norm(grads)``) and ``sca_overflow`` (visible queries the
    SCA capacity dropped anywhere in the batch), as Python numbers.

    ``supervise_all_future`` False supervises one future frame, drawn from
    ``generator``, and rolls the others out without gradient (reference
    vidar.py:336-338). ``generator`` also draws the grid mask and the Gumbel
    noise of the dense loss, as the JAX step does (vidar_tpu/train/step.py:
    79-96). Dropout draws from PyTorch's default generator."""

    def __init__(self, model, optimizer, *, supervise_all_future: bool = True,
                 generator: Optional[torch.Generator] = None,
                 device='cuda'):
        super().__init__(model, optimizer, generator=generator, device=device)
        self.supervise_all_future = supervise_all_future

    def frame_gate(self):
        """The [num_future] 0/1 gate of the supervised rollout frames."""
        num_future = self.model.future_pred_frame_num
        if self.supervise_all_future or num_future == 0:
            return [1.0] * max(num_future, 1)
        gdev = self.generator.device if self.generator is not None else 'cpu'
        pick = int(torch.randint(0, num_future, (), generator=self.generator,
                                 device=gdev))
        return [float(i == pick) for i in range(num_future)]

    def __call__(self, batch) -> Dict[str, float]:
        m = self.model
        batch = batch.to(self.device)
        m.train()
        self.optimizer.zero_grad(set_to_none=True)
        metrics = self._update(m(batch, generator=self.generator,
                                 gumbel_generator=self.generator,
                                 train_frame_gate=self.frame_gate()))
        metrics['sca_overflow'] = int(sca_overflow_count(
            batch.lidar2img, tuple(batch.images.shape[3:5]), m.bev_h,
            m.bev_w, m.pc_range, m.sca_capacity_ratio))
        return metrics


class DetTrainStep(_Step):
    """``step(det_batch) -> metrics``: every loss of every decoder layer,
    ``loss`` (their sum) and ``grad_norm`` (the global norm before
    clipping), as Python numbers. ``generator`` draws the grid mask;
    dropout draws from PyTorch's default generator."""

    def __call__(self, batch) -> Dict[str, float]:
        m = self.model
        batch = batch.to(self.device)
        m.train()
        self.optimizer.zero_grad(set_to_none=True)
        preds = m(batch.frames, train=True, generator=self.generator)
        return self._update(m.loss(preds, batch.gt_bboxes, batch.gt_labels,
                                   batch.num_valid_gt))
