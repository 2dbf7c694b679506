"""The decode-attention collectives of tensor-parallel serving, after the
JAX package's ``distributed/collectives.py``.

The JAX package builds each as a ``shard_map`` over a mesh axis; here each
is the per-rank body, called on every rank with this rank's tensors and the
group (:class:`~repro_torch.distributed.runtime.TPGroup`):

``tp_paged_decode_attention``        the head-cut pool: the unchanged paged
                                     kernel on the rank's ``(N, ps, Hkv/tp,
                                     D)`` slice and its ``Hq/tp`` query
                                     heads, no collective;
``tp_paged_decode_attention_merge``  the Hkv < tp fallback: heads
                                     replicated, each rank walks 1/tp of
                                     every slot's page-table columns with
                                     lengths rebased, and the partial
                                     ``(out, lse)`` pairs combine in
                                     log-sum-exp space (one all-reduce max,
                                     two all-reduce sums);
``distributed_decode_attention``     flash-decode over a dense cache cut on
                                     the sequence, combined the same way.

A CUDA tensor takes the paged kernel, a CPU tensor its plain version, as in
``kernels/ops.py``.  The merges are the only float sums that cross ranks;
the JAX package's do the same.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.distributed.runtime import TPGroup
from repro_torch.kernels import build, ref
from repro_torch.kernels import paged_attention as _pa


def _paged(q, k_pool, v_pool, table, cache_len, plan=None, **kw):
    if build.is_cuda(q):
        return _pa.paged_decode_attention(q, k_pool, v_pool, table,
                                          cache_len, plan=plan, **kw)
    return ref.paged_decode_attention(q, k_pool, v_pool, table, cache_len,
                                      **kw)


def tp_paged_decode_attention(q, k_pool, v_pool, page_table, cache_len,
                              tp: TPGroup, *, window: Optional[int] = None,
                              softcap: Optional[float] = None,
                              scale: Optional[float] = None,
                              k_scale=None, v_scale=None):
    """Paged decode attention over the HEAD-CUT pool: q (B, Hq/tp, 1, D) this
    rank's query heads, the pools (N, ps, Hkv/tp, D) its KV heads (int8 /
    fp8 codes with their (N, Hkv/tp) scales), the page table and lengths
    the same on every rank.  Contiguous head blocks keep GQA aligned, so
    the rank's output heads need no collective.

    The kernel's split plan depends on the (slot, KV head) pairs of its
    grid; it is passed the plan of the whole pool (B * Hkv pairs), so each
    head's page chunks, and the order in which they merge, are the same at
    any tp and the outputs equal the unsharded kernel's bit for bit."""
    B, _, _, D = q.shape
    ps, hkv = k_pool.shape[1], k_pool.shape[2]
    plan = _pa.split_plan(ps, page_table.shape[1], B * hkv * tp.size, D)
    return _paged(q, k_pool, v_pool, page_table, cache_len, plan=plan,
                  window=window, softcap=softcap, scale=scale,
                  k_scale=k_scale, v_scale=v_scale)


def tp_paged_decode_attention_merge(q, k_pool, v_pool, page_table, cache_len,
                                    tp: TPGroup, *,
                                    softcap: Optional[float] = None,
                                    scale: Optional[float] = None):
    """The Hkv < tp fallback: q (B, Hq, 1, D) every head, the whole pool on
    every rank; rank r attends the page-table columns ``[r P/tp, (r+1)
    P/tp)`` with its lengths rebased to that window (``return_lse=True``),
    and the partial outputs merge in log-sum-exp space.  Returns (B, Hq, 1,
    D) in q's dtype, the same on every rank.  Requires no window (a
    windowed leaf never pages in the JAX package) and P divisible by
    tp."""
    B, Hq, _, D = q.shape
    ps, P = k_pool.shape[1], page_table.shape[1]
    cols = P // tp.size
    span = cols * ps
    table = page_table[:, tp.rank * cols:(tp.rank + 1) * cols].contiguous()
    # local position p is global rank * span + p: the kernel's `p < len`
    # mask is exact under the clipped length
    local_len = torch.clamp(cache_len.to(torch.int32) - tp.rank * span, 0,
                            span).to(torch.int32)
    # the partial outputs stay float32 (a float32 query over the pool: the
    # same logits), so the merged result rounds once to q's dtype; the JAX
    # package's merge rounds each partial to it first
    out, lse = _paged(q.to(torch.float32), k_pool, v_pool, table, local_len,
                      softcap=softcap, scale=scale, return_lse=True)
    # (B, Hkv, group) in head order; an empty window's is about -1e30
    lse = torch.clamp_min(lse.reshape(B, Hq, 1), ref.NEG_INF)
    m = tp.all_reduce(lse.clone(), "max")
    w = torch.exp(lse - m)                   # an empty window weighs ~0
    num = tp.all_reduce(out * w[..., None], "sum")
    den = tp.all_reduce(w, "sum")
    return (num / torch.clamp_min(den[..., None], 1e-30)).to(q.dtype)


def distributed_decode_attention(q, k_cache, v_cache, valid, tp: TPGroup, *,
                                 softcap: Optional[float] = None,
                                 scale: Optional[float] = None):
    """Flash-decode with the dense KV cache cut on the sequence: q (B, Hq, 1,
    D) every head on every rank; the caches (B, Hkv, S/tp, D) this rank's
    block of positions; ``valid`` (B, S/tp) its mask.  Each rank computes a
    partial attention and its log-sum-exp statistics over its positions
    (p rounded to the cache dtype before the PV product, as the JAX
    package's body does); an all-reduce max and two all-reduce sums of
    O(B Hq D) combine them.  Returns (B, Hq, 1, D) in q's dtype, the same
    on every rank."""
    B, Hq, _, D = q.shape
    Hkv = k_cache.shape[1]
    s = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, Hkv, Hq // Hkv, D).to(torch.float32)
    logits = torch.einsum("bhgd,bhkd->bhgk", qg,
                          k_cache.to(torch.float32)) * s
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    logits = torch.where(valid[:, None, None, :], logits, ref.NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgk,bhkd->bhgd", p.to(v_cache.dtype).to(torch.float32),
                     v_cache.to(torch.float32))
    m_g = tp.all_reduce(m.clone(), "max")
    corr = torch.exp(m - m_g)
    l_g = tp.all_reduce(l * corr, "sum")
    o_g = tp.all_reduce(o * corr, "sum")
    out = o_g / torch.clamp_min(l_g, 1e-30)
    return out.reshape(B, Hq, 1, D).to(q.dtype)
