"""The kernel dispatcher: one entry per op, chosen by the tensors' device.

A CUDA tensor goes to the hand-written kernel's wrapper, which launches it
or raises; a CPU tensor goes to the plain PyTorch version in
``kernels/ref.py``.  There is no switch that could pick the plain version
for a tensor on the card, and no fallback when a kernel cannot be built.

Training: in grad mode, where an operand requires grad, ``attention`` and
``rwkv6`` on the card take their kernel's ``torch.autograd.Function``
(the kernel runs the forward, the plain version's gradient is the
backward); on the CPU the plain version is differentiated as it is.  The
W4A8 and paged kernels serve inference only, and their wrappers raise on
an operand that requires grad in grad mode.

The dry run (``launch/dryrun.py``): a ``meta`` tensor goes to the op's
count (``kernels/costs.py``'s ``meta_*``).  A kernel entry records the
CUDA path's own work to the active tally and returns empty outputs of the
kernel's shapes; the plain version is not traced.  In grad mode the
backward is what the card's autograd Function runs, the plain version's
gradient, traced on meta.  The plain ops that loop over time in Python
(the sequential selective scan, the chunked WKV, the WKV scan with a
state, and its plain gradient) count one traced iteration times their trip
count, as ``hlo_analysis`` weights a ``while`` body by its trip count.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.quant import QuantizedLeaf
from repro_torch.distributed import collectives
from repro_torch.kernels import build, costs, ref
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
                w_scale: torch.Tensor, *, out_dtype=torch.bfloat16,
                packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The W4A8 product: the kernel on ``packed`` (the codes in its layout,
    required) for a CUDA tensor, the plain version on ``codes`` for a CPU
    tensor."""
    if build.is_cuda(qx):
        return _w4a8.w4a8_matmul(qx, x_scale, codes, w_scale, out_dtype,
                                 packed)
    if build.is_meta(qx):
        return costs.meta_w4a8(qx, x_scale, codes, w_scale, out_dtype)
    return ref.w4a8_matmul(qx, x_scale, codes, w_scale, out_dtype)


def attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
              softcap: Optional[float] = None, scale: Optional[float] = None,
              kv_offset: int = 0) -> torch.Tensor:
    """Prefill attention, (B, H, T, D) operands: the flash kernel for a
    CUDA tensor (operands made contiguous for it; through
    ``FlashAttentionFn`` when a gradient is wanted), the plain version for
    a CPU tensor."""
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
              kv_offset=kv_offset)
    if build.is_cuda(q):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if build.wants_grad(q, k, v):
            return _fa.FlashAttentionFn.apply(q, k, v, kw)
        return _fa.flash_attention(q, k, v, **kw)
    if build.is_meta(q):
        return costs.meta_attention(q.contiguous(), k.contiguous(),
                                    v.contiguous(), kw)
    return ref.flash_attention(q, k, v, **kw)


def decode_attention(q, k_cache, v_cache, cache_len, *,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None,
                     scale: Optional[float] = None,
                     lse: bool = False, seq=None) -> torch.Tensor:
    """Dense single-position attention (the dense decode step and the
    split-brain engine's token steps).  The JAX package has no Pallas
    kernel for it either: plain PyTorch on every device.

    ``lse`` (the config's ``parallel.decode_attn="shard_map"``, passed by
    the dense decode steps that pass the JAX package's ``dist_axis``) with
    no window: the JAX package's dispatch to its log-sum-exp body
    (``collectives.distributed_decode_attention``), which it runs wherever
    its mesh has the sequence axis, a mesh of one device included.
    ``seq``: the group whose ranks hold the caches cut on the sequence,
    rank r the positions ``[r S, (r + 1) S)`` for a local length S, and
    ``cache_len`` the global lengths; None is one shard."""
    if lse and window is None:
        S = k_cache.shape[2]
        start = 0 if seq is None else seq.rank * S
        pos = start + torch.arange(S, device=q.device)
        valid = pos[None, :] < cache_len.to(torch.int32)[:, None]
        return collectives.distributed_decode_attention(
            q, k_cache, v_cache, valid, seq, softcap=softcap, scale=scale)
    return ref.decode_attention(q, k_cache, v_cache, cache_len,
                                window=window, softcap=softcap, scale=scale)


def chunk_attention(q, k_cache, v_cache, q_pos, *,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention of a chunked-prefill chunk over a linear cache at absolute
    positions.  The JAX package has no Pallas kernel for it either
    (``repro/kernels/ops.py::chunk_attention``): plain PyTorch on every
    device.  Chunks do not go through the flash kernel's ``kv_offset``:
    its blocked online softmax rounds otherwise than the reference's chunk
    path, a plain softmax over the whole cache."""
    return ref.chunk_attention(q, k_cache, v_cache, q_pos, window=window,
                               softcap=softcap, scale=scale)


def paged_decode_attention(q, k_pool, v_pool, page_table, cache_len, *,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None,
                           scale: Optional[float] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           return_lse: bool = False, tp=None,
                           head_cut: bool = False):
    """Decode attention through the page table: the paged kernel for a CUDA
    tensor, the plain version for a CPU tensor.  With ``return_lse`` it
    returns ``(out, lse)``, lse the (B, Hkv, group) f32 log-sum-exp.  A
    quantized pool arrives as a ``QuantizedLeaf`` and is unpacked into its
    codes and per-(page, KV head) scales, which both versions dequantize
    at the page fetch.

    With ``tp`` (a ``TPGroup`` of more than one rank), the JAX package's
    tensor-parallel dispatch (``repro/kernels/ops.py::
    paged_decode_attention``).  ``head_cut``: q and the pools hold this
    rank's block of heads (both head counts divide by the group's size),
    and the kernel runs on them with no collective
    (``collectives.tp_paged_decode_attention``).  Otherwise q holds every
    head over the whole pool: with no window, a float pool and a table
    width the group's size divides, each rank walks its share of the page
    columns and the partials merge by log-sum-exp
    (``collectives.tp_paged_decode_attention_merge``); else every rank runs
    the unsharded kernel.  The JAX package sends a quantized pool under TP
    to its plain version; the port runs its kernel on the rank's codes and
    scales, the same function."""
    if isinstance(k_pool, QuantizedLeaf):
        k_pool, k_scale = k_pool.codes, k_pool.scales
        v_pool, v_scale = v_pool.codes, v_pool.scales
    if tp is not None and tp.size > 1 and not return_lse:
        if head_cut:
            return collectives.tp_paged_decode_attention(
                q, k_pool, v_pool, page_table, cache_len, tp, window=window,
                softcap=softcap, scale=scale, k_scale=k_scale,
                v_scale=v_scale)
        if (window is None and k_scale is None
                and page_table.shape[1] % tp.size == 0):
            return collectives.tp_paged_decode_attention_merge(
                q, k_pool, v_pool, page_table, cache_len, tp,
                softcap=softcap, scale=scale)
    kw = dict(window=window, softcap=softcap, scale=scale, k_scale=k_scale,
              v_scale=v_scale, return_lse=return_lse)
    if build.is_meta(q):
        return costs.meta_paged(q, k_pool, page_table,
                                quantized=k_scale is not None,
                                return_lse=return_lse)
    if build.is_cuda(q):
        return _pa.paged_decode_attention(q, k_pool, v_pool, page_table,
                                          cache_len, **kw)
    return ref.paged_decode_attention(q, k_pool, v_pool, page_table,
                                      cache_len, **kw)


def rwkv6(r, k, v, w, u, state: Optional[torch.Tensor] = None):
    """The RWKV6 WKV recurrence, (B, H, T, D) operands: the CUDA kernel for a
    CUDA tensor with no carried state (the whole-sequence ``forward``,
    operands made contiguous for it; through ``RWKV6ScanFn`` when a
    gradient is wanted), the plain version otherwise.  Taking
    the plain version when a state is carried (each ``decode_step``) is the
    JAX package's own dispatch (``repro/kernels/ops.py::rwkv6``): its kernel
    starts from a zero state only."""
    if state is None and build.is_cuda(r):
        args = [t.contiguous() for t in (r, k, v, w, u)]
        if build.wants_grad(*args):
            return _rwkv.RWKV6ScanFn.apply(*args)
        return _rwkv.rwkv6_scan(*args)
    if build.is_meta(r):
        if state is None:
            return costs.meta_rwkv6(*[t.contiguous() for t in (r, k, v, w, u)])
        return costs.meta_loop("rwkv6_scan", r, k, v, w, u, state)
    return ref.rwkv6_scan(r, k, v, w, u, state)


def rwkv6_chunked(r, k, v, w, u, state: Optional[torch.Tensor] = None, *,
                  chunk: int = 64):
    """The chunked (matmul-form) WKV recurrence.  The JAX package has no
    Pallas kernel for it either: plain PyTorch on every device."""
    if build.is_meta(r) and r.shape[2] > chunk:
        return costs.meta_loop("rwkv6_chunked", r, k, v, w, u, state,
                               chunk=chunk)
    return ref.rwkv6_scan_chunked(r, k, v, w, u, state, chunk=chunk)


def selective_scan(x, delta, A, B, C, state: Optional[torch.Tensor] = None,
                   *, algorithm: str = "sequential"):
    """Hymba's selective state-space scan: the sequential form, or with
    ``algorithm="associative"`` (and more than one step) the associative
    one, as the JAX package's ``ops.selective_scan`` chooses.  The JAX
    package has no kernel for it either: plain PyTorch on every device."""
    if algorithm == "associative" and x.shape[1] > 1:
        return ref.selective_scan_assoc(x, delta, A, B, C, state)
    if build.is_meta(x) and x.shape[1] > 1:
        return costs.meta_loop("selective_scan", x, delta, A, B, C, state)
    return ref.selective_scan(x, delta, A, B, C, state)
