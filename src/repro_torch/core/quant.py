"""Logic-Aware Quantization (LAQ) — the paper's §IV-C in software, in torch.

Pipeline (per weight matrix):
  1. symmetric per-output-channel INT4 quantization (scale = amax/7),
  2. zero-weight pruning: |w| below ``prune_threshold`` * full scale is forced
     to zero, deleting the MAC entirely (§IV-C.3; paper threshold 2^-6),
  3. logic-aware rounding: between the two nearest INT4 codes, prefer the
     one whose CSD encoding needs fewer adders when the extra quantization
     error stays within ``laq_slack`` of the scale.

Activations are INT8 symmetric (§V-C), per row by default (the serving
path's dynamic range) or per tensor (the paper's static calibrated range).

Every function is elementwise torch on whatever device its input lies on,
and rounds exactly as the JAX package does (``torch.round`` rounds half to
even like ``jnp.round``), so codes and scales are bit-identical to it.  A
division by a constant divides by a tensor (:func:`_true_div`): PyTorch on
CUDA turns a division by a Python number into a multiplication by its
reciprocal, which misses the quotient's last bit on some inputs, and at
tinyllama-1.1b's full width that moved LAQ codes on the card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import functools

import torch

from repro_torch.core import csd
from repro_torch.kernels.w4a8_matmul import pack_codes

__all__ = [
    "QuantizedLinear",
    "QuantizedLeaf",
    "KV_DTYPES",
    "KV_QMAX",
    "quantize_weights",
    "dequantize",
    "quantize_activations_int8",
    "w4a8_matmul_ref",
    "pruned_fraction",
]

INT4_MIN, INT4_MAX = -7, 7  # symmetric grid keeps the CSD tables balanced
DEFAULT_PRUNE_THRESHOLD = 2.0 ** -6  # §IV-C.3, fraction of full scale
DEFAULT_LAQ_SLACK = 0.35  # extra quant error allowed (in units of scale) to buy a cheaper CSD code


@dataclass
class QuantizedLinear:
    """An INT4 weight matrix plus per-channel scales — the 'hardwired' layer.

    ``codes`` is int8 storage of INT4 values in [-7, 7], shape ``(..., K, N)``;
    ``scales`` is float32 of shape ``(..., N)`` (per output channel).
    ``packed`` is the same codes in the CUDA kernel's layout, two per byte
    (``kernels/w4a8_matmul.py::pack_codes``), made once with the device
    weights (:meth:`with_packed`): the kernel reads only it, the plain
    version and the CPU path only ``codes``.
    """

    codes: torch.Tensor
    scales: torch.Tensor
    packed: Optional[torch.Tensor] = None

    def __getitem__(self, idx) -> "QuantizedLinear":
        """Index leading (layer) axes of codes, scales and packed together."""
        return QuantizedLinear(
            self.codes[idx], self.scales[idx],
            None if self.packed is None else self.packed[idx])

    def to(self, device) -> "QuantizedLinear":
        return QuantizedLinear(
            self.codes.to(device), self.scales.to(device),
            None if self.packed is None else self.packed.to(device))

    def with_packed(self) -> "QuantizedLinear":
        """This layer with its packed codes, packing them if it has none."""
        if self.packed is not None:
            return self
        return QuantizedLinear(self.codes, self.scales, pack_codes(self.codes))


# KV-cache page quantization formats (paged pools); fp8 is e4m3.
KV_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
KV_QMAX = {"int8": 127.0, "fp8": 448.0}


class QuantizedLeaf:
    """A quantized page-pool cache leaf: int8 / fp8-e4m3 codes plus
    per-page, per-KV-head float32 scales beside the page table.

    ``codes`` has the pool leaf's layout ``(*lead, num_pages, page_size,
    *tail)``; ``scales`` drops the ``page_size`` axis and the trailing
    head_dim axis, one scale per (leading dims x) page x KV head.
    ``kv_dtype`` names the code format ("int8" / "fp8"), ``out_dtype`` the
    dense dtype a dequantized view is produced in.  Indexing takes the same
    leading index of codes and scales, so a per-layer slice of a stacked
    pool is again a ``QuantizedLeaf`` (the operand pair of the paged
    kernel)."""

    def __init__(self, codes: torch.Tensor, scales: torch.Tensor,
                 kv_dtype: str = "int8", out_dtype=torch.bfloat16):
        self.codes = codes
        self.scales = scales
        self.kv_dtype = kv_dtype
        self.out_dtype = out_dtype

    def __getitem__(self, idx) -> "QuantizedLeaf":
        return QuantizedLeaf(self.codes[idx], self.scales[idx],
                             self.kv_dtype, self.out_dtype)

    def to(self, device) -> "QuantizedLeaf":
        return QuantizedLeaf(self.codes.to(device), self.scales.to(device),
                             self.kv_dtype, self.out_dtype)

    @property
    def shape(self):
        return self.codes.shape

    @property
    def nbytes(self) -> int:
        return (self.codes.numel() * self.codes.element_size()
                + self.scales.numel() * self.scales.element_size())

    def __repr__(self):
        return (f"QuantizedLeaf({self.kv_dtype}, codes={tuple(self.codes.shape)}"
                f", scales={tuple(self.scales.shape)})")


@functools.lru_cache(maxsize=None)
def _constant(value: float, device: torch.device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def _true_div(x: torch.Tensor, value: float) -> torch.Tensor:
    """``x / value`` for a float32 ``x``, correctly rounded on every device:
    the divisor is a 0-d float32 tensor on ``x``'s device (made once per
    device), which CUDA divides by, where a Python number would be
    multiplied by its reciprocal."""
    return x / _constant(float(value), x.device)


def quantize_weights(
    w: torch.Tensor,
    *,
    prune_threshold: float = DEFAULT_PRUNE_THRESHOLD,
    laq_slack: float = DEFAULT_LAQ_SLACK,
    logic_aware: bool = True,
) -> QuantizedLinear:
    """Quantize a (in, out) weight matrix to LAQ INT4 (on ``w``'s device)."""
    w = w.to(torch.float32)
    scales = _true_div(w.abs().amax(dim=0, keepdim=True), INT4_MAX)
    scales = torch.clamp_min(scales, 1e-12)
    x = w / scales

    lo = torch.clamp(torch.floor(x), INT4_MIN, INT4_MAX)
    hi = torch.clamp(lo + 1, INT4_MIN, INT4_MAX)
    err_lo = (x - lo).abs()
    err_hi = (x - hi).abs()
    del x

    if logic_aware:
        cost = torch.as_tensor(csd.csd_cost_table(4), device=w.device)
        cost_lo = cost[(lo + 8).to(torch.int64)]
        cost_hi = cost[(hi + 8).to(torch.int64)]
        # Nearest code, unless the other code is CSD-cheaper and the error
        # penalty stays within the slack budget.
        nearest_is_lo = err_lo <= err_hi
        prefer_lo = (cost_lo < cost_hi) & (err_lo <= err_hi + laq_slack)
        prefer_hi = (cost_hi < cost_lo) & (err_hi <= err_lo + laq_slack)
        take_lo = torch.where(prefer_lo, True,
                              torch.where(prefer_hi, False, nearest_is_lo))
    else:
        take_lo = err_lo <= err_hi
    q = torch.where(take_lo, lo, hi).to(torch.int8)

    # Zero-weight pruning: synthesis deletes the MAC (§IV-C.3).
    full_scale = scales * INT4_MAX
    q = torch.where(w.abs() < prune_threshold * full_scale,
                    torch.zeros_like(q), q)
    return QuantizedLinear(codes=q, scales=scales[0].to(torch.float32))


def dequantize(ql: QuantizedLinear, dtype=torch.bfloat16) -> torch.Tensor:
    return (ql.codes.to(torch.float32) * ql.scales).to(dtype)


def quantize_activations_int8(x: torch.Tensor, *, per_tensor: bool = False,
                              reciprocal: bool = False):
    """Symmetric INT8 activation quantization -> (codes int8, scale f32).

    Default is per-row dynamic scaling (``amax(row)/127``, scale shape
    ``x.shape[:-1] + (1,)``), which the W4A8 matmul consumes;
    ``per_tensor=True`` uses one ``amax(x)/127`` for the whole tensor,
    broadcast to the same shape.  ``reciprocal=True`` takes the scale as
    ``amax * float32(1/127)``, as the JAX package's compiled programs do
    (XLA rewrites the division by a constant; its eager ops divide): the
    two differ in the last bit on some rows.
    """
    x = x.to(torch.float32)
    amax = x.abs().amax() if per_tensor else x.abs().amax(dim=-1, keepdim=True)
    scale = amax * (1.0 / 127.0) if reciprocal else _true_div(amax, 127.0)
    if per_tensor:
        scale = scale.expand(x.shape[:-1] + (1,)).contiguous()
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int_matmul(qx: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of int8 operands, on any device.

    The product runs in float64: every partial sum is an integer far below
    2^53 (|acc| <= 127 * 7 * K), so each float64 add is exact and the result
    does not depend on summation order."""
    acc = qx.to(torch.float64) @ codes.to(torch.float64)
    return acc.to(torch.int32)


def w4a8_matmul_ref(x: torch.Tensor, ql: QuantizedLinear,
                    dtype=torch.bfloat16) -> torch.Tensor:
    """Reference W4A8 matmul: int8 activations x int4 weights, int32 accum,
    rescaled by (act_scale * weight_scale)."""
    qx, act_scale = quantize_activations_int8(x)
    shape = qx.shape
    acc = int_matmul(qx.reshape(-1, shape[-1]), ql.codes)
    acc = acc.reshape(shape[:-1] + (ql.codes.shape[-1],))
    return (acc.to(torch.float32) * act_scale * ql.scales).to(dtype)


def pruned_fraction(ql: QuantizedLinear) -> torch.Tensor:
    """Share of ``ql``'s codes that LAQ pruned to zero: a float32 0-d tensor
    on the codes' device.

    The JAX package takes ``jnp.mean`` of the float32 zero mask, which XLA
    compiles as the mask's float32 sum times the float32 reciprocal of the
    element count (it rewrites the division by a constant).  The port
    counts the zeros exactly in int64 and multiplies by that reciprocal, so
    below 2^24 elements, where the float32 sum of ones is exact in any
    order, the two are bit-identical (the tests show it there).  Above,
    the port rounds the count once, and the JAX package's float32 sum may
    round on the way."""
    size = torch.tensor(float(ql.codes.numel()), dtype=torch.float32)
    inv = (1.0 / size).to(ql.codes.device)       # the float32 reciprocal
    return (ql.codes == 0).sum().to(torch.float32) * inv
