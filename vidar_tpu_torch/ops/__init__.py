"""Tensor ops of the port: bilinear helpers, the masked chamfer distance and
the kernel-backed ops (``msda``, ``dcn``, ``latent_render``), each with its
plain PyTorch version and its gradient."""
