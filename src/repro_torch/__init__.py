"""PyTorch + CUDA port of the ITA split-brain serving system.

Beside the JAX package ``repro`` (the reference), this package serves the
split-brain W4A8 paged main path on an NVIDIA H100: LAQ-quantized device
projections through a hand-written W4A8 CUDA kernel, decode attention
through a hand-written paged flash-decode CUDA kernel, and the
continuous-batching scheduler driving both.  It imports ``torch`` and never
``jax`` or ``repro``.
"""
