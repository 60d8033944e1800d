"""Model modules of the port: the ViDAR forecast and its pre-training
forward."""

from .vidar import ViDAR

__all__ = ['ViDAR']
