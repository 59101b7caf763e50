"""PyTorch port of ``repro`` (LAMB / BERT-large pretraining) for NVIDIA Hopper.

Mirrors the JAX package's layout and names; imports torch and numpy, never
jax or ``repro``.  Entry points run on ``cuda`` unless the caller asks for
the CPU (see :func:`repro_torch.device.resolve_device`).
"""
