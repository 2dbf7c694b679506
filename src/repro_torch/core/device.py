"""The device rule of the port's entry points: they run on the card unless
the caller asks for the CPU, and a CUDA device without a card raises.  Also
the float-matmul settings under which the card's tokens equal the CPU's."""
from __future__ import annotations

from typing import Dict

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card raises
    (nothing carries on on the CPU unless the caller asks for it)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port serves on the GPU; pass "
            "device='cpu' explicitly to run the plain versions on the CPU")
    return dev


def matmul_settings() -> Dict[str, bool]:
    """The process-wide float-matmul flags, as torch reads them back."""
    return {"allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "allow_bf16_reduced_precision_reduction":
                torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}


def exact_matmuls() -> Dict[str, bool]:
    """Make float matmuls on the card reduce as they do on the CPU: no TF32
    for float32 products, and no reduced-precision reduction inside
    cuBLAS's bf16 products.  The flags are process-wide; the serving engine
    sets them for a CUDA device.  Returns them as read back."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return matmul_settings()
