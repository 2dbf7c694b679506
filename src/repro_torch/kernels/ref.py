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
                           v_scale: Optional[torch.Tensor] = None,
                           return_lse: bool = False):
    """Single-position attention computed THROUGH the page table.

    q: (B, Hq, 1, D); pools: (num_pages, page_size, Hkv, D) in bf16, f32,
    int8 or fp8-e4m3; page_table: (B, P) physical page ids; cache_len: (B,)
    valid lengths.  Position t of slot b lives at
    ``(page_table[b, t // page_size], t % page_size)``.  ``k_scale`` /
    ``v_scale`` (num_pages, Hkv) f32 dequantize each fetched page block.

    A loop over the P table columns with an online softmax in float32; a
    slot whose every position is masked (``cache_len == 0``) returns zeros.
    With ``return_lse`` it also returns the (B, Hkv, group) float32
    log-sum-exp of the live logits, ``m + log(max(l, 1e-30))`` as the
    Pallas kernel writes it (about -1e30 for a slot with none).
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
    l = torch.clamp_min(l, 1e-30)
    out = (acc / l[..., None]).reshape(B, Hq, 1, D).to(q.dtype)
    return (out, m + torch.log(l)) if return_lse else out


def paged_decode_order_bound(q: torch.Tensor, k_pool: torch.Tensor,
                             v_pool: torch.Tensor, page_table: torch.Tensor,
                             cache_len: torch.Tensor, **kw) -> torch.Tensor:
    """Per output of :func:`paged_decode_attention` (same arguments, no
    ``return_lse``), what two float32 evaluations that sum the p_i v_i in
    different orders differ by: 8 * 2^-24 * sum_i p_i |v_i| / l, (B, Hq, 1,
    D) float32.  The CUDA kernel splits the positions over lanes, warps and
    page chunks merged by log-sum-exp; this version walks the pages in turn.
    Each order's partial sums grow like sqrt(k) over k random-signed terms
    while l grows like k, so its rounding error over l stays near one
    2^-24 * sum_i p_i |v_i| / l at any length (8 of them cover two orders
    with a wide margin; n of them would be the worst case).  It matters only
    where an output is near zero after cancellation and its bf16 ulp falls
    below that: the kernel's bf16 outputs are held to one bf16 ulp of this
    version's plus this bound."""
    v_abs = v_pool.to(torch.float32).abs()
    mean_abs_v = paged_decode_attention(q.to(torch.float32), k_pool, v_abs,
                                        page_table, cache_len, **kw)
    return 8 * 2.0 ** -24 * mean_abs_v


# ----------------------------------------------------------------------------
# RWKV6 (Finch) WKV recurrence with data-dependent decay
# ----------------------------------------------------------------------------
def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor,
               state: Optional[torch.Tensor] = None):
    """RWKV6 recurrence, one time step at a time in float32.

    r, k, v: (B, H, T, D); w: (B, H, T, D) data-dependent decay in (0, 1);
    u: (H, D) bonus; state: (B, H, D, D) mapping k-dim -> v-dim (zeros when
    None).

      S_t   = diag(w_t) S_{t-1} + k_t v_t^T
      out_t = r_t (S_{t-1} + diag(u) k_t v_t^T)

    Returns (out (B, H, T, D) in r's dtype, final state (B, H, D, D) f32).
    Each elementwise op rounds once in float32, as the CUDA kernel's do, so
    the two carry the same state; only the sum over k in ``out_t`` takes
    another order there.
    """
    B, H, T, D = r.shape
    f32 = torch.float32
    S = (torch.zeros((B, H, D, D), dtype=f32, device=r.device)
         if state is None else state.to(f32))
    rs, ks, vs, ws = (a.to(f32) for a in (r, k, v, w))
    uu = u.to(f32)[..., :, None]                            # (H, D, 1)
    outs = []
    for t in range(T):
        kv = ks[:, :, t, :, None] * vs[:, :, t, None, :]    # (B, H, D, D)
        outs.append(torch.einsum("bhk,bhkv->bhv", rs[:, :, t], S + uu * kv))
        S = ws[:, :, t, :, None] * S + kv
    return torch.stack(outs, dim=2).to(r.dtype), S


def rwkv6_scan_order_bound(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Per output of :func:`rwkv6_scan` from a zero state, what two float32
    sums of out_t's D terms r_i (S_ij + u_i k_i v_j), taken in different
    orders, can differ by: 2 * D * 2^-24 * sum_i |r_i (S_ij + u_i k_i v_j)|,
    (B, H, T, D) float64 on the inputs' device.  The CUDA kernel sums in
    another order than this plain version, and the terms grow with the
    state (hundreds at T = 512 with rwkv6-7b's decays near 1), so an output
    near zero after cancellation can differ by many of its own bf16 ulps
    while the state stays bit-identical: the kernel's bf16 outputs are held
    to one bf16 ulp plus this bound."""
    D = r.shape[-1]
    f64 = torch.float64
    rs, ks, vs, ws = (a.to(f64) for a in (r, k, v, w))
    uu = u.to(f64)[..., :, None]
    S = torch.zeros(r.shape[:2] + (D, D), dtype=f64, device=r.device)
    scale = []
    for t in range(r.shape[2]):
        kv = ks[:, :, t, :, None] * vs[:, :, t, None, :]
        scale.append(torch.einsum("bhk,bhkv->bhv", rs[:, :, t].abs(),
                                  (S + uu * kv).abs()))
        S = ws[:, :, t, :, None] * S + kv
    return 2 * D * 2.0 ** -24 * torch.stack(scale, dim=2)


def rwkv6_scan_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       w: torch.Tensor, u: torch.Tensor,
                       state: Optional[torch.Tensor] = None, chunk: int = 64):
    """Chunked (matmul-form) RWKV6: the state is formed once per chunk of
    C steps and the work inside a chunk is (C, C) / (C, D) products.

      with A_t = sum_{j<=t} log w_j (inclusive cumsum within the chunk):
        inter_t = (r_t * e^{A_{t-1}}) . S_0
        intra_t = sum_{s<t} [(r_t e^{A_{t-1}}) . (k_s e^{-A_s})] v_s
                  + (r_t . (u * k_t)) v_t
        S_end   = diag(e^{A_C}) S_0 + sum_s (k_s e^{A_C - A_s}) v_s^T

    Algebraically the recurrence of :func:`rwkv6_scan`; float differences
    come from the exp/cumsum reassociation.  T must be a multiple of
    ``min(chunk, T)``.  The JAX package has no kernel for this form, so it
    is plain on every device.
    """
    B, H, T, D = r.shape
    C = min(chunk, T)
    assert T % C == 0, (T, C)
    n = T // C
    f32 = torch.float32
    S = (torch.zeros((B, H, D, D), dtype=f32, device=r.device)
         if state is None else state.to(f32))

    def chunks(a):                                   # (n, B, H, C, D)
        return a.reshape(B, H, n, C, D).permute(2, 0, 1, 3, 4).to(f32)

    rs, ks, vs = chunks(r), chunks(k), chunks(v)
    logw = torch.log(torch.clamp_min(w.to(f32), 1e-30))
    As = torch.cumsum(logw.reshape(B, H, n, C, D), dim=3).permute(2, 0, 1, 3, 4)
    mask = torch.tril(torch.ones((C, C), dtype=torch.bool, device=r.device),
                      -1)                            # strict lower: s < t
    uk = u.to(f32)[None, :, None, :]
    outs = []
    for i in range(n):
        rc, kc, vc, Ac = rs[i], ks[i], vs[i], As[i]  # (B, H, C, D)
        # per-step log w from the inclusive cumsum: logw_t = A_t - A_{t-1}
        logw_c = torch.cat([Ac[:, :, :1], torch.diff(Ac, dim=2)], dim=2)
        q_t = rc * torch.exp(Ac - logw_c)            # exclusive prefix
        k_s = kc * torch.exp(-Ac)
        inter = torch.einsum("bhtd,bhdv->bhtv", q_t, S)
        scores = torch.einsum("bhtd,bhsd->bhts", q_t, k_s)
        scores = torch.where(mask, scores, torch.zeros((), dtype=f32,
                                                       device=r.device))
        diag = torch.einsum("bhtd,bhtd->bht", rc, uk * kc)
        intra = (torch.einsum("bhts,bhsv->bhtv", scores, vc)
                 + diag[..., None] * vc)
        A_last = Ac[:, :, -1:, :]                    # (B, H, 1, D)
        S = (torch.exp(A_last[:, :, 0, :, None]) * S
             + torch.einsum("bhsd,bhsv->bhdv", kc * torch.exp(A_last - Ac), vc))
        outs.append(inter + intra)
    out = torch.stack(outs, dim=0).permute(1, 2, 0, 3, 4).reshape(B, H, T, D)
    return out.to(r.dtype), S
