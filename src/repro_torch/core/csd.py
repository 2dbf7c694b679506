"""Canonical Signed Digit (CSD) encoding and shift-add synthesis.

A constant weight ``w`` multiplying an activation ``x`` is not a generic
multiplier but a shift-add tree

    y = sum_i c_i * (x << s_i),   c_i in {-1, +1}

where the (c_i, s_i) come from the CSD (non-adjacent form) encoding of the
integer weight (the paper's Logic-Aware Quantization, §IV-C).  CSD minimises
the number of non-zero digits, which sets the number of adders in the
synthesized tree (adders = nnz - 1).  LAQ (``core/quant.py``) reads the
per-value cost table, and so do the cost and FPGA models
(``core/costmodel.py``, ``core/fpga.py``).

Everything here is exact Python / numpy, except :func:`shift_add_eval`,
which evaluates a plan on an integer tensor in int32 on the tensor's own
device, so that tests can check the plan against ordinary integer
multiplication on every representable input.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

__all__ = [
    "csd_encode",
    "csd_nonzero_digits",
    "binary_nonzero_digits",
    "ShiftAddPlan",
    "shift_add_plan",
    "shift_add_eval",
    "csd_cost_table",
    "binary_cost_table",
    "adder_reduction",
]


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


def binary_nonzero_digits(n: int) -> int:
    """Number of non-zero digits in plain two's-complement binary.

    For negative numbers we count ``popcount(|n|) + 1`` (sign handling adds
    one subtractor), which matches the adder-count accounting used for
    unsigned shift-add trees.
    """
    n = int(n)
    if n < 0:
        return bin(-n).count("1") + 1
    return bin(n).count("1")


@dataclass(frozen=True)
class ShiftAddPlan:
    """A synthesized constant multiplier: ``y = sum_i signs[i]*(x << shifts[i])``."""

    weight: int
    signs: Tuple[int, ...]
    shifts: Tuple[int, ...]

    @property
    def num_terms(self) -> int:
        return len(self.signs)

    @property
    def num_adders(self) -> int:
        """Adders in the tree: combining k shifted terms needs k-1 adders.

        A weight of zero (pruned) or a single power of two (pure wire
        routing) needs zero adders — §IV-C.3, §IV-C.2.
        """
        return max(0, self.num_terms - 1)


@functools.lru_cache(maxsize=None)
def shift_add_plan(weight: int) -> ShiftAddPlan:
    digits = csd_encode(weight)
    signs = tuple(d[0] for d in digits)
    shifts = tuple(d[1] for d in digits)
    return ShiftAddPlan(weight=int(weight), signs=signs, shifts=shifts)


def shift_add_eval(plan: ShiftAddPlan, x) -> torch.Tensor:
    """Bit-exact evaluation of the shift-add tree on integer activations.

    ``x`` is an integer tensor (or anything ``torch.as_tensor`` takes); the
    tree is evaluated in int32 on ``x``'s device.  Shifts are wire routing
    (§IV-C.2): left shifts of the int32 activations, which cannot overflow
    for int8 activations and INT4/INT8 weights.
    """
    x = torch.as_tensor(x).to(torch.int32)
    acc = torch.zeros_like(x)
    for sign, shift in zip(plan.signs, plan.shifts):
        acc = acc + sign * torch.bitwise_left_shift(x, shift)
    return acc


@functools.lru_cache(maxsize=None)
def csd_cost_table(num_bits: int = 4) -> np.ndarray:
    """CSD non-zero-digit count for every signed ``num_bits`` integer.

    Index ``i`` holds the cost of the value ``i - 2**(num_bits-1)``
    (i.e. index 0 -> most negative).  Used to vectorize logic-aware rounding.
    """
    lo = -(2 ** (num_bits - 1))
    hi = 2 ** (num_bits - 1)
    return np.array([csd_nonzero_digits(v) for v in range(lo, hi)], np.int32)


@functools.lru_cache(maxsize=None)
def binary_cost_table(num_bits: int = 4) -> np.ndarray:
    lo = -(2 ** (num_bits - 1))
    hi = 2 ** (num_bits - 1)
    return np.array([binary_nonzero_digits(v) for v in range(lo, hi)], np.int32)


def adder_reduction(values: np.ndarray, num_bits: int = 4) -> dict:
    """CSD-vs-binary adder statistics over a population of integer weights.

    Reproduces the paper's claim that CSD reduces shift-add adders by
    30-40% on average (§IV-C.1, citing Gustafsson [21]).
    """
    values = np.asarray(values).astype(np.int64)
    offset = 2 ** (num_bits - 1)
    csd = csd_cost_table(num_bits)[values + offset]
    binary = binary_cost_table(num_bits)[values + offset]
    # adders = max(0, nnz - 1) per weight
    csd_adders = np.maximum(0, csd - 1)
    bin_adders = np.maximum(0, binary - 1)
    total_bin = float(bin_adders.sum())
    total_csd = float(csd_adders.sum())
    return {
        "mean_nnz_binary": float(binary.mean()),
        "mean_nnz_csd": float(csd.mean()),
        "total_adders_binary": total_bin,
        "total_adders_csd": total_csd,
        "adder_reduction_frac": 0.0 if total_bin == 0 else 1.0 - total_csd / total_bin,
    }
