"""Tensor ops of the port: bilinear helpers and the four kernel-backed ops
(``msda``, ``dcn``, ``latent_render``), each with its plain PyTorch version."""
