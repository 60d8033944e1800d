"""vidar_tpu_torch: the ViDAR forecast path in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (``csrc/``).

A port of the JAX package ``vidar_tpu`` (the reference, kept beside it).
Importing this package imports neither JAX nor flax and builds nothing: the
kernels are compiled at their first launch (``ops/_build.py``).
"""

__version__ = "0.1.0"
