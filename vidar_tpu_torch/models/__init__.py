"""Model modules of the port: the ViDAR forecast and its pre-training
forward, the BEVFormer detection fine-tune and the BEVFormerV2 family."""

from .bevformer import BEVFormer, BEVFormerFP16, StreamState
from .bevformer_v2 import BEVFormerV2
from .vidar import ViDAR

__all__ = ['BEVFormer', 'BEVFormerFP16', 'BEVFormerV2', 'StreamState',
           'ViDAR']
