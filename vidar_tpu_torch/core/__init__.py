"""Core helpers of the port: the 3D box codec, losses and assignment of the
detection fine-tune (``bbox``)."""
