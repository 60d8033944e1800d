"""Batch structure and synthetic batches of the port."""

from .structures import ViDARBatch
from .synthetic import make_synthetic_batch

__all__ = ['ViDARBatch', 'make_synthetic_batch']
