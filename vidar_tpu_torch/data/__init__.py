"""Batch structures and synthetic batches of the port."""

from .structures import DetBatch, ViDARBatch
from .synthetic import make_synthetic_batch, make_synthetic_det_batch

__all__ = ['DetBatch', 'ViDARBatch', 'make_synthetic_batch',
           'make_synthetic_det_batch']
