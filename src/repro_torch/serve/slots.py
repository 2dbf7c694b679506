"""Slot helpers of the continuous-batching serve loop: power-of-two shape
buckets and the finite-logits sentinel with its fault-injection hook."""
from __future__ import annotations

import torch

__all__ = ["bucket", "corrupt_logits", "finite_logits"]


def bucket(n: int, floor: int = 1) -> int:
    """Round ``n`` up to the next power of two (>= floor)."""
    n = max(int(n), floor)
    return 1 << (n - 1).bit_length()


def corrupt_logits(logits: torch.Tensor, corrupt: torch.Tensor) -> torch.Tensor:
    """NaN-poison the logits of slots where ``corrupt`` is True — the
    fault-injection half of the finite-logits sentinel, applied inside the
    decode step so injected corruption flows the real detection path."""
    shape = [corrupt.shape[0]] + [1] * (logits.dim() - 1)
    return torch.where(corrupt.reshape(shape),
                       torch.full_like(logits, float("nan")), logits)


def finite_logits(logits: torch.Tensor) -> torch.Tensor:
    """Per-slot ``(n_slots,)`` bool: True iff every logit of that slot is
    finite.  Returned with the sampled tokens in the same device-to-host
    copy, costing no extra sync."""
    return torch.isfinite(logits).reshape(logits.shape[0], -1).all(dim=1)
