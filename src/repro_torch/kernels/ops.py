"""The kernel dispatcher: one entry per op, chosen by the tensors' device.

A CUDA tensor goes to the hand-written kernel's wrapper, which launches it
or raises; a CPU tensor goes to the plain PyTorch version in
``kernels/ref.py``.  There is no switch that could pick the plain version
for a tensor on the card, and no fallback when a kernel cannot be built.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import rwkv_scan as _rwkv
from repro_torch.kernels import w4a8_matmul as _w4a8

# the kernel wrappers whose launches the main path is held to
KERNELS = {"w4a8_matmul": _w4a8.w4a8_matmul,
           "paged_decode_attention": _pa.paged_decode_attention,
           "flash_attention": _fa.flash_attention,
           "rwkv6_scan": _rwkv.rwkv6_scan}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def w4a8_matmul(qx: torch.Tensor, x_scale: torch.Tensor, codes: torch.Tensor,
                w_scale: torch.Tensor, *, out_dtype=torch.bfloat16
                ) -> torch.Tensor:
    if build.is_cuda(qx):
        return _w4a8.w4a8_matmul(qx, x_scale, codes, w_scale, out_dtype)
    return ref.w4a8_matmul(qx, x_scale, codes, w_scale, out_dtype)


def attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
              softcap: Optional[float] = None, scale: Optional[float] = None,
              kv_offset: int = 0) -> torch.Tensor:
    """Prefill attention, (B, H, T, D) operands: the flash kernel for a
    CUDA tensor (operands made contiguous for it), the plain version for a
    CPU tensor."""
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
              kv_offset=kv_offset)
    if build.is_cuda(q):
        return _fa.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), **kw)
    return ref.flash_attention(q, k, v, **kw)


def decode_attention(q, k_cache, v_cache, cache_len, *,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Dense single-position attention (the dense decode step and the
    split-brain engine's token steps).  The JAX package has no Pallas
    kernel for it either: plain PyTorch on every device."""
    return ref.decode_attention(q, k_cache, v_cache, cache_len,
                                window=window, softcap=softcap, scale=scale)


def paged_decode_attention(q, k_pool, v_pool, page_table, cache_len, *,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None,
                           scale: Optional[float] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           return_lse: bool = False):
    """Decode attention through the page table: the paged kernel for a CUDA
    tensor, the plain version for a CPU tensor.  With ``return_lse`` it
    returns ``(out, lse)``, lse the (B, Hkv, group) f32 log-sum-exp."""
    kw = dict(window=window, softcap=softcap, scale=scale, k_scale=k_scale,
              v_scale=v_scale, return_lse=return_lse)
    if build.is_cuda(q):
        return _pa.paged_decode_attention(q, k_pool, v_pool, page_table,
                                          cache_len, **kw)
    return ref.paged_decode_attention(q, k_pool, v_pool, page_table,
                                      cache_len, **kw)


def rwkv6(r, k, v, w, u, state: Optional[torch.Tensor] = None):
    """The RWKV6 WKV recurrence, (B, H, T, D) operands: the CUDA kernel for a
    CUDA tensor with no carried state (the whole-sequence ``forward``,
    operands made contiguous for it), the plain version otherwise.  Taking
    the plain version when a state is carried (each ``decode_step``) is the
    JAX package's own dispatch (``repro/kernels/ops.py::rwkv6``): its kernel
    starts from a zero state only."""
    if state is None and build.is_cuda(r):
        return _rwkv.rwkv6_scan(r.contiguous(), k.contiguous(),
                                v.contiguous(), w.contiguous(),
                                u.contiguous())
    return ref.rwkv6_scan(r, k, v, w, u, state)


def rwkv6_chunked(r, k, v, w, u, state: Optional[torch.Tensor] = None, *,
                  chunk: int = 64):
    """The chunked (matmul-form) WKV recurrence.  The JAX package has no
    Pallas kernel for it either: plain PyTorch on every device."""
    return ref.rwkv6_scan_chunked(r, k, v, w, u, state, chunk=chunk)
