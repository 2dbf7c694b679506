"""Plain PyTorch versions of the port's kernels.

Each function here computes what its CUDA kernel computes, with ordinary
tensor ops on whatever device its inputs lie on.  They are the CPU path of
the port (``kernels/ops.py`` dispatches a CPU tensor here) and the yardstick
``chip_smoke.py`` and the ``gpu`` tests hold each kernel against on the card.
They follow the JAX package's oracles (``repro/kernels/ref.py``) step for
step, so the CPU tests compare like with like.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quant import int_matmul

NEG_INF = -1e30


# ----------------------------------------------------------------------------
# W4A8 matmul (the ITA MAC datapath)
# ----------------------------------------------------------------------------
def w4a8_matmul(qx: torch.Tensor, x_scale: torch.Tensor, codes: torch.Tensor,
                w_scale: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """int8 activations (M,K) x int4 codes (K,N) -> scaled (M,N).

    Exact int32 accumulation, then ``(float(acc) * x_scale) * w_scale`` in
    float32 and one rounding to ``out_dtype``.
    """
    acc = int_matmul(qx, codes)
    return (acc.to(torch.float32) * x_scale * w_scale).to(out_dtype)


# ----------------------------------------------------------------------------
# Attention
# ----------------------------------------------------------------------------
def _soft_cap(logits: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return logits
    return cap * torch.tanh(logits / cap)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None,
                    kv_offset: int = 0) -> torch.Tensor:
    """Blocked-softmax attention as the TPU flash kernel computes it.

    q: (B, Hq, Tq, D); k, v: (B, Hkv, Tk, D) with Hq % Hkv == 0; query head
    h reads KV head ``h // group`` (no K/V repeat).  Logits ``q . k`` in
    float32 times ``scale`` (default ``D ** -0.5``), then
    ``softcap * tanh(x / softcap)``, then the mask ``kpos <= qpos`` (causal)
    and ``kpos > qpos - window`` with ``qpos = i + kv_offset``.  The softmax
    is taken in float32 as ``p = exp(x - max)``, ``acc = p . v``,
    ``out = acc / max(sum p, 1e-30)`` -- one block of the Pallas kernel,
    which equals ``repro.kernels.ref.mha`` -- and rounded once to q's dtype.

    ``p`` stays float32 for the value product.  The JAX package's other
    backend, ``ref.mha_chunked``, rounds ``p`` to the value dtype first and
    so differs by up to 2^-7 on bf16 outputs; the port follows the Pallas
    kernel, which is what the TPU computes.
    """
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    s = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, Hkv, group, Tq, D).to(torch.float32)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.to(torch.float32)) * s
    logits = _soft_cap(logits, softcap)
    qpos = torch.arange(Tq, device=q.device)[:, None] + kv_offset
    kpos = torch.arange(Tk, device=q.device)[None, :]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    acc = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(torch.float32))
    out = acc / torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    return out.reshape(B, Hq, Tq, D).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-position attention against a (possibly padded) dense KV cache.

    q: (B, Hq, 1, D); caches: (B, Hkv, S, D); cache_len: (B,) valid lengths.
    Query head h reads KV head ``h // group``.
    """
    B, Hq, _, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    group = Hq // Hkv
    s = scale if scale is not None else D ** -0.5
    qg = q[:, :, 0, :].reshape(B, Hkv, group, D).to(torch.float32)
    logits = torch.einsum("bhgd,bhkd->bhgk", qg,
                          k_cache.to(torch.float32)) * s
    logits = _soft_cap(logits, softcap)
    pos = torch.arange(S, device=q.device)[None, :]
    cl = cache_len.to(torch.int32)[:, None]
    valid = pos < cl
    if window is not None:
        valid &= pos > (cl - 1 - window)
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.to(torch.float32))
    return out.reshape(B, Hq, 1, D).to(q.dtype)


def _fetch_pages(pool: torch.Tensor, pid: torch.Tensor) -> torch.Tensor:
    """pool[pid] as float32 (fp8 pools are gathered through a byte view)."""
    if pool.dtype == torch.float8_e4m3fn:
        return pool.view(torch.uint8)[pid].view(pool.dtype).to(torch.float32)
    return pool[pid].to(torch.float32)


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           cache_len: torch.Tensor, *,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None,
                           scale: Optional[float] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Single-position attention computed THROUGH the page table.

    q: (B, Hq, 1, D); pools: (num_pages, page_size, Hkv, D) in bf16, f32,
    int8 or fp8-e4m3; page_table: (B, P) physical page ids; cache_len: (B,)
    valid lengths.  Position t of slot b lives at
    ``(page_table[b, t // page_size], t % page_size)``.  ``k_scale`` /
    ``v_scale`` (num_pages, Hkv) f32 dequantize each fetched page block.

    A loop over the P table columns with an online softmax in float32; a
    slot whose every position is masked (``cache_len == 0``) returns zeros.
    """
    B, Hq, _, D = q.shape
    ps, Hkv = k_pool.shape[1], k_pool.shape[2]
    P = page_table.shape[1]
    group = Hq // Hkv
    s = scale if scale is not None else D ** -0.5
    dev = q.device
    qg = q[:, :, 0, :].reshape(B, Hkv, group, D).to(torch.float32)
    cl = cache_len.to(device=dev, dtype=torch.int32)[:, None]
    table = page_table.to(device=dev, dtype=torch.int64)
    offs = torch.arange(ps, device=dev)
    m = torch.full((B, Hkv, group), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, group), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, group, D), dtype=torch.float32, device=dev)
    for pi in range(P):
        pid = table[:, pi]
        kb = _fetch_pages(k_pool, pid)                   # (B, ps, Hkv, D)
        vb = _fetch_pages(v_pool, pid)
        if k_scale is not None:
            kb = kb * k_scale[pid][:, None, :, None]
        if v_scale is not None:
            vb = vb * v_scale[pid][:, None, :, None]
        logits = torch.einsum("bhgd,bshd->bhgs", qg, kb) * s
        logits = _soft_cap(logits, softcap)
        pos = (pi * ps + offs)[None, :]                  # absolute positions
        valid = pos < cl
        if window is not None:
            valid &= pos > (cl - 1 - window)
        logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        # rows with nothing valid so far contribute nothing (a cache_len of
        # 0 returns zeros, not an average of raw pool rows)
        live = m_new > NEG_INF
        p = torch.where(live[..., None], torch.exp(logits - m_new[..., None]),
                        0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgs,bshd->bhgd", p, vb)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, Hq, 1, D).to(q.dtype)
