"""Model modules of the port (eval path of the ViDAR forecast)."""

from .vidar import ViDAR

__all__ = ['ViDAR']
