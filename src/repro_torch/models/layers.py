"""Shared building blocks in torch: norms, rope, linear (raw or LAQ W4A8),
SwiGLU, the GQA projections and the in-place paged KV append.

Public functions keep the JAX package's layouts: activations are
``(B, H, T, D)`` after projection, pool slices ``(num_pages, page_size,
Hkv, D)``, weights ``(in, out)`` and W4A8 codes ``(K, N)``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import quant
from repro_torch.kernels import ops


def dense_init(in_dim: int, out_dim: int, generator: torch.Generator, *,
               lead=(), device=None) -> torch.Tensor:
    """Uniform(-1/sqrt(in), 1/sqrt(in)) float32 weights of shape
    ``lead + (in, out)`` (the JAX package's ``dense_init`` bound), drawn
    from ``generator``."""
    scale = 1.0 / math.sqrt(in_dim)
    w = torch.empty(tuple(lead) + (in_dim, out_dim), dtype=torch.float32,
                    device=device)
    return w.uniform_(-scale, scale, generator=generator)


def linear(x: torch.Tensor, w, reciprocal_scale: bool = False
           ) -> torch.Tensor:
    """Apply a linear map; ``w`` is a raw (in, out) tensor or a
    QuantizedLinear.  The quantized branch is the ITA device datapath: per-row
    INT8 activations times the hardwired INT4 codes through the W4A8 op
    (the CUDA kernel on the packed codes for a CUDA tensor, the plain
    version on the codes on the CPU); ``reciprocal_scale`` goes to the
    activation quantizer (``quantize_activations_int8(reciprocal=)``)."""
    if isinstance(w, quant.QuantizedLinear):
        shape = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        qx, xs = quant.quantize_activations_int8(x2,
                                                 reciprocal=reciprocal_scale)
        y = ops.w4a8_matmul(qx, xs, w.codes, w.scales, out_dtype=x.dtype,
                            packed=w.packed)
        return y.reshape(*shape, w.codes.shape[-1])
    return x @ w.to(x.dtype)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """RMS norm in float32, scaled by ``(1 + gamma)``, back in x's dtype."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = (x32 * torch.rsqrt(var + eps)) * (1.0 + gamma.to(torch.float32))
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0
         ) -> torch.Tensor:
    """Rotary embedding over the two HALVES of the head (not interleaved).

    x: (B, H, T, D) with even D; positions: (T,) or (B, T)."""
    D = x.shape[-1]
    half = D // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    pos = positions.to(torch.float32)
    if positions.dim() == 1:
        ang = (pos[:, None] * freqs[None, :])[None, None]          # (1,1,T,half)
    else:
        ang = pos[:, None, :, None] * freqs[None, None, None, :]   # (B,1,T,half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) with sigmoid = 1 / (1 + exp(-x)), one op at a time in
    x's dtype: the JAX package's compiled SwiGLU rounds every one of these
    steps to bfloat16, and so does this (``F.silu`` rounds once and differs
    by a bf16 ulp on about half the entries)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def swiglu(x: torch.Tensor, w1, w3, w2, reciprocal_scale: bool = False
           ) -> torch.Tensor:
    """FFN(x) = W2 . (silu(W1 x) * (W3 x)) — eq. (4)/(5) of the paper."""
    r = reciprocal_scale
    h = silu(linear(x, w1, r)) * linear(x, w3, r)
    return linear(h, w2, r)


# ----------------------------------------------------------------------------
# GQA attention projections
# ----------------------------------------------------------------------------
def qkv_project(p: dict, x: torch.Tensor, num_heads: int, num_kv_heads: int,
                head_dim: int, reciprocal_scale: bool = False):
    """The ITA device phase of attention: static linear maps only.
    x (B, T, d) -> q (B, Hq, T, hd), k and v (B, Hkv, T, hd)."""
    B, T, _ = x.shape

    def heads(w, n):
        return linear(x, w, reciprocal_scale).reshape(
            B, T, n, head_dim).transpose(1, 2)

    return (heads(p["wq"], num_heads), heads(p["wk"], num_kv_heads),
            heads(p["wv"], num_kv_heads))


# ----------------------------------------------------------------------------
# Paged KV append
# ----------------------------------------------------------------------------
# Physical page 0 of every page pool is the reserved scratch page: writes for
# inactive slots are routed there so a step never depends on the active set.
SCRATCH_PAGE = 0


def page_offsets(table: torch.Tensor, pos: torch.Tensor, write: torch.Tensor,
                 page_size: int):
    """Per-slot write coordinates through the page table: position ``pos[b]``
    of slot ``b`` lives at ``(table[b, pos // ps], pos % ps)``; slots with
    ``write=False`` are routed to the scratch page.  (A finished slot's stale
    ``pos`` may sit one page past the table; its column is clamped, and the
    slot writes to scratch anyway.)"""
    col = torch.clamp(pos.to(torch.int64) // page_size, max=table.shape[1] - 1)
    page = torch.gather(table, 1, col[:, None])[:, 0]
    page = torch.where(write, page, torch.full_like(page, SCRATCH_PAGE))
    return page.to(torch.int64), pos.to(torch.int64) % page_size


def paged_cache_write(pool: torch.Tensor, new: torch.Tensor,
                      table: torch.Tensor, pos: torch.Tensor,
                      write: torch.Tensor) -> torch.Tensor:
    """Append one token's K or V per slot directly into the page pool, IN
    PLACE: ``pool`` is one layer's slice ``(num_pages, page_size, Hkv, D)``
    (a view into the stacked pool) and is written with one ``index_put_`` of
    B token rows, so a step moves O(B x token bytes), never the pool.

    new: (B, Hkv, 1, D); table: (B, P) physical page ids; pos: (B,) write
    positions (== ``len``); write: (B,) bool — inactive slots land on the
    scratch page.  Returns ``pool`` (the same tensor, updated)."""
    page, off = page_offsets(table, pos, write, pool.shape[1])
    pool[page, off] = new[:, :, 0, :].to(pool.dtype)
    return pool


def cache_write(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
                aligned: bool = True,
                write: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Write one token's K or V into a dense cache IN PLACE.

    cache: (B, Hkv, S, D); new: (B, Hkv, 1, D); pos: (B,) on the cache's
    device.  ``aligned=True`` (lockstep decode, every row at ``pos[0]``):
    one ``index_copy_`` along the sequence axis.  ``aligned=False`` (ragged
    slot positions): one indexed write of B token rows; with ``write``
    (B,) bool, a row where it is False writes back the token it already
    holds, so a masked step freezes inactive rows without touching more
    than one token per row (the in-place form of the JAX package's
    ``select_slots`` over the new cache).  No host sync either way.
    Returns ``cache``."""
    if aligned:
        return cache.index_copy_(2, pos[:1].to(torch.int64),
                                 new.to(cache.dtype))
    rows = torch.arange(cache.shape[0], device=cache.device)
    idx = pos.to(torch.int64)
    val = new[:, :, 0, :].to(cache.dtype)
    if write is not None:
        val = torch.where(write[:, None, None], val, cache[rows, :, idx, :])
    cache[rows, :, idx, :] = val
    return cache
