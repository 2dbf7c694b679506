"""Slot helpers of the continuous-batching serve loop: power-of-two shape
buckets, the in-place slot insert of the dense slot cache, and the
finite-logits sentinel with its fault-injection hook.

A dense slot cache is the family cache built for ``batch = max_slots``;
each leaf names its batch axis in an ``axes`` dict (a list of leaves shares
its entry).  Where the JAX package returned a new cache from a jitted
insert and froze inactive rows with a ``where`` over the whole new cache,
the port writes in place: ``insert_slot`` copies a B=1 request cache into
row ``slot``, and a masked decode step writes only one token per row
(``models/layers.py::cache_write`` with ``write=``) and advances ``len``
by the active mask.
"""
from __future__ import annotations

import torch

__all__ = ["bucket", "insert_slot", "corrupt_logits", "finite_logits"]


def bucket(n: int, floor: int = 1) -> int:
    """Round ``n`` up to the next power of two (>= floor)."""
    n = max(int(n), floor)
    return 1 << (n - 1).bit_length()


def insert_slot(batched, single, slot: int, axes):
    """Write every leaf of a batch-1 cache into row ``slot`` of the batched
    cache along that leaf's batch axis, IN PLACE (the counterpart of the
    JAX package's ``make_slot_insert``).  Returns ``batched``."""
    for name, b in batched.items():
        s, ax = single[name], axes[name]
        for bl, sl in (zip(b, s) if isinstance(b, list) else [(b, s)]):
            bl.narrow(ax, slot, 1).copy_(sl)
    return batched


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
