"""Model modules of the port: the ViDAR forecast and its pre-training
forward, and the BEVFormer detection fine-tune."""

from .bevformer import BEVFormer, BEVFormerFP16, StreamState
from .vidar import ViDAR

__all__ = ['BEVFormer', 'BEVFormerFP16', 'StreamState', 'ViDAR']
