"""Canonical Signed Digit (CSD) cost tables for logic-aware rounding.

A constant weight ``w`` times an activation is a shift-add tree whose adder
count is set by the number of non-zero digits of ``w``'s CSD (non-adjacent
form) encoding.  LAQ (``core/quant.py``) prefers the cheaper of the two
nearest INT4 codes, so it needs only the per-value cost table below; the
shift-add evaluation helpers of the JAX package stay there.
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np

__all__ = ["csd_encode", "csd_nonzero_digits", "csd_cost_table"]


def csd_encode(n: int) -> List[Tuple[int, int]]:
    """Encode integer ``n`` in canonical signed digit (non-adjacent) form.

    Returns a list of ``(sign, shift)`` with ``sign in {-1, +1}`` such that
    ``n == sum(sign * 2**shift)`` and no two non-zero digits are adjacent.
    """
    n = int(n)
    digits: List[Tuple[int, int]] = []
    shift = 0
    while n != 0:
        if n & 1:
            # r = 2 - (n mod 4): maps n%4==1 -> +1, n%4==3 -> -1
            r = 2 - (n & 3)
            digits.append((r, shift))
            n -= r
        n >>= 1
        shift += 1
    return digits


def csd_nonzero_digits(n: int) -> int:
    """Number of non-zero digits in the CSD encoding of ``n``."""
    return len(csd_encode(n))


@functools.lru_cache(maxsize=None)
def csd_cost_table(num_bits: int = 4) -> np.ndarray:
    """CSD non-zero-digit count for every signed ``num_bits`` integer.

    Index ``i`` holds the cost of the value ``i - 2**(num_bits-1)``
    (i.e. index 0 -> most negative).  Used to vectorize logic-aware rounding.
    """
    lo = -(2 ** (num_bits - 1))
    hi = 2 ** (num_bits - 1)
    return np.array([csd_nonzero_digits(v) for v in range(lo, hi)], np.int32)
