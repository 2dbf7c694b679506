"""The collectives of the port, after the JAX package's
``distributed/collectives.py``: the decode-attention collectives of
tensor-parallel serving, Megatron's autograd collectives of tensor-parallel
training, and the int8-compressed data-parallel gradient reduction.

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
                                     the sequence, combined the same way
                                     (one all-gather of the partials).

A CUDA tensor takes the paged kernel, a CPU tensor its plain version, as in
``kernels/ops.py``.  The merges are the only float sums that cross ranks
in serving; the JAX package's do the same.

Training (GSPMD inserts these in the JAX package; here each is an
``autograd.Function`` over one group, a no-op on a group of one rank):

``copy_to``      identity forward, all-reduce backward: the input of a
                 column-cut projection (Megatron's f);
``reduce_from``  all-reduce forward, identity backward: the row-cut
                 projection's partial products, and the partial sums of a
                 value every rank of the group computes alike (Megatron's
                 g);
``gather_from``  all-gather forward, the rank's slice backward: a block
                 whose consumer runs alike on every rank;
``gather_sum``   all-gather forward, reduce-scatter backward: the ZeRO-3
                 weight gather over "data", whose consumers differ by rank
                 (their batch rows);
``scale_grad``   identity forward, the gradient times a constant.

Every float reduction runs in float32 (or float64 for float64 inputs).  ``compressed_psum_mean`` and
``dp_train_step_compressed`` are the int8 data-parallel reduction.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.distributed.runtime import TPGroup
from repro_torch.kernels import build, costs, ref
from repro_torch.kernels import paged_attention as _pa


def _paged(q, k_pool, v_pool, table, cache_len, plan=None, **kw):
    if build.is_meta(q):
        return costs.meta_paged(q, k_pool, table,
                                quantized=kw.get("k_scale") is not None,
                                return_lse=kw.get("return_lse", False))
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


def distributed_decode_attention(q, k_cache, v_cache, valid,
                                 tp: Optional[TPGroup] = None, *,
                                 softcap: Optional[float] = None,
                                 scale: Optional[float] = None):
    """Flash-decode with the dense KV cache cut on the sequence: q (B, Hq, 1,
    D) every head on every rank; the caches (B, Hkv, S/tp, D) this rank's
    block of positions; ``valid`` (B, S/tp) its mask.  Each rank computes a
    partial attention and its log-sum-exp statistics over its positions
    (p rounded to the cache dtype before the PV product, as the JAX
    package's body does); one all-gather of every rank's max, sum and
    partial output (O(B Hq D)) combines them, each rank summing the
    corrected partials in rank order.  Returns (B, Hq, 1,
    D) in q's dtype, the same on every rank.  ``tp`` None (or one rank) is
    the body on one shard with no collective, which is what the JAX
    package runs on a mesh whose sequence axis has one device.

    The body follows the JAX package's compiled one: XLA's tanh and exp
    (``ref.tanh``, ``ref.exp``), and the softcap's division as a
    multiplication by the cap's reciprocal, which XLA makes of a division
    by a constant (the same op on both devices: PyTorch on the card would
    make that rewrite of a division by a Python number itself)."""
    B, Hq, _, D = q.shape
    Hkv = k_cache.shape[1]
    s = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, Hkv, Hq // Hkv, D).to(torch.float32)
    logits = torch.einsum("bhgd,bhkd->bhgk", qg,
                          k_cache.to(torch.float32)) * s
    if softcap is not None:
        logits = softcap * ref.tanh(logits * (1.0 / softcap))
    logits = torch.where(valid[:, None, None, :], logits, ref.NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = ref.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgk,bhkd->bhgd", p.to(v_cache.dtype).to(torch.float32),
                     v_cache.to(torch.float32))
    if tp is not None and tp.size > 1:
        # one all-gather of every rank's (m, l, o); each rank combines them
        # alike, the corrected partials summed in rank order (the JAX
        # package's pmax, then psums of l * corr and o * corr)
        parts = tp.all_gather(torch.cat([m, l, o], dim=-1))
        m_g = parts[0][..., :1]
        for t in parts[1:]:
            m_g = torch.maximum(m_g, t[..., :1])

        def corrected(t):
            corr = ref.exp(t[..., :1] - m_g)
            return t[..., 1:2] * corr, t[..., 2:] * corr
        l_g, o_g = corrected(parts[0])
        rest, n = parts[1:], 1
        if build.is_meta(m_g):
            # the dry run: the tp - 1 alike steps traced as one, weighted
            rest, n = rest[:1], len(rest)
        with costs.repeat(n):
            for t in rest:
                lc, oc = corrected(t)
                l_g, o_g = l_g + lc, o_g + oc
    else:
        # one shard: the combine's correction is exp(0) = 1, exactly
        l_g, o_g = l, o
    out = o_g / torch.clamp_min(l_g, 1e-30)
    return out.reshape(B, Hq, 1, D).to(q.dtype)


# ----------------------------------------------------------------------------
# Megatron's autograd collectives (training)
# ----------------------------------------------------------------------------
def _reduce32(x: torch.Tensor, group: TPGroup) -> torch.Tensor:
    """The sum of every rank's ``x`` in float32 (float64 stays so), in
    ``x``'s dtype."""
    acc = torch.promote_types(x.dtype, torch.float32)
    return group.all_reduce(x.to(acc).clone()).to(x.dtype)


def _gather_cat(x: torch.Tensor, group: TPGroup, dim: int) -> torch.Tensor:
    return torch.cat(group.all_gather(x), dim=dim)


def _block(x: torch.Tensor, group: TPGroup, dim: int) -> torch.Tensor:
    w = x.shape[dim] // group.size
    return x.narrow(dim, group.rank * w, w).contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce32(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _reduce32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.group, ctx.dim), None, None


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, dtype):
        ctx.group, ctx.dim, ctx.dtype = group, dim, x.dtype
        return _gather_cat(x.to(dtype), group, dim)

    @staticmethod
    def backward(ctx, g):
        acc = torch.promote_types(torch.promote_types(g.dtype, ctx.dtype),
                                  torch.float32)
        g = ctx.group.reduce_scatter(g.to(acc), ctx.dim)
        return g.to(ctx.dtype), None, None, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def _one(group: Optional[TPGroup]) -> bool:
    return group is None or group.size == 1


def copy_to(x: torch.Tensor, group: Optional[TPGroup]) -> torch.Tensor:
    """Identity forward; the backward all-reduces the gradient over
    ``group`` (float32): ``x`` feeds a computation that differs by rank."""
    return x if _one(group) else _Copy.apply(x, group)


def reduce_from(x: torch.Tensor, group: Optional[TPGroup]) -> torch.Tensor:
    """The float32 sum of every rank's ``x`` (in ``x``'s dtype); identity
    backward: every rank goes on alike from the sum."""
    return x if _one(group) else _Reduce.apply(x, group)


def gather_from(x: torch.Tensor, group: Optional[TPGroup], dim: int
                ) -> torch.Tensor:
    """Every rank's block of ``x`` concatenated along ``dim``; the backward
    takes the rank's slice (the consumer runs alike on every rank)."""
    return x if _one(group) else _Gather.apply(x, group, dim % x.dim())


def gather_sum(x: torch.Tensor, group: Optional[TPGroup], dim: int,
               dtype=None) -> torch.Tensor:
    """Every rank's block of ``x`` concatenated along ``dim``; the backward
    sums the ranks' gradients (float32) and takes the rank's slice, as a
    reduce-scatter does.  ``dtype``: the blocks travel cast to it (a
    weight that its consumer casts to the compute dtype anyway: the same
    values, half the bytes of float32 at bf16), and the gradient comes
    back in ``x``'s dtype, summed from the consumer's gradient as
    without the cast."""
    if _one(group):
        return x if dtype is None else x.to(dtype)
    return _GatherSum.apply(x, group, dim % x.dim(), dtype or x.dtype)


def scale_grad(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x`` itself; its gradient times ``s``."""
    return x if s == 1 else _ScaleGrad.apply(x, s)


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor,
                       group: TPGroup) -> torch.Tensor:
    """Cross-entropy over logits cut on the vocabulary: ``logits`` (..., V /
    n) float32, this rank's block of columns ``[rank V/n, (rank + 1)
    V/n)``; ``labels`` (...) global ids.  ``-log_softmax(logits)[label]``
    from an all-reduce max (the shift, no gradient), the all-reduced sum of
    exps and the all-reduced label logit (each rank adds the ones it
    holds), so no rank holds the whole row; every rank returns the same
    value and its own block's gradient."""
    n = logits.shape[-1]
    start = group.rank * n
    m = group.all_reduce(logits.detach().amax(dim=-1).clone(), "max")
    sumexp = reduce_from(torch.exp(logits - m[..., None]).sum(dim=-1), group)
    local = labels.to(torch.int64) - start
    inside = (local >= 0) & (local < n)
    picked = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    label_logit = reduce_from(torch.where(inside, picked, torch.zeros_like(
        picked)), group)
    return m + torch.log(sumexp) - label_logit


# ----------------------------------------------------------------------------
# int8-compressed data-parallel reduction
# ----------------------------------------------------------------------------
def compressed_psum_mean(tree, group: TPGroup, block: int = 256):
    """Mean-reduce a tree of tensors over ``group`` with an int8 wire
    format, the JAX package's arithmetic step for step: each leaf in
    float32, flattened and zero-padded to blocks of ``block``; a local
    per-block scale ``max(amax / 127, 1e-20)`` (``amax`` times the
    float32 ``1/127``, as XLA compiles it); its all-reduce max (one
    shared scale per block); ``clip(round(x / scale), -127, 127)`` (round
    half to even) as int8; the exact int32 sum of the codes; ``q_sum *
    scale`` unpadded, over the group's size.  The quantization error is the
    local rounding, at most ``scale / 2`` per rank."""
    n = group.size

    def leaf(g):
        g32 = g.to(torch.float32)
        flat = g32.reshape(-1)
        pad = (-flat.numel()) % block
        blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, block)
        # XLA compiles the division by the constant 127 into a product by
        # its float32 reciprocal, as the optimizer's int8 codec notes
        local = torch.clamp_min(blocks.abs().amax(dim=1, keepdim=True)
                                * np.float32(1.0 / 127.0), 1e-20)
        scale = group.all_reduce(local, "max")
        q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
        q_sum = group.all_reduce(q.to(torch.int32))
        out = (q_sum.to(torch.float32) * scale).reshape(-1)[:g.numel()]
        return out.reshape(g.shape) / n

    return _map_tensors(leaf, tree)


def _map_tensors(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return fn(tree)


def dp_train_step_compressed(loss_fn: Callable, group: TPGroup,
                             block: int = 256) -> Callable:
    """A data-parallel gradient function with the int8 reduction: the
    returned ``fn(params, batch)`` takes this rank's batch rows, and
    returns ``(loss, grads)``: the mean of the ranks' ``loss_fn(params,
    batch)`` (float32 all-reduce) and ``compressed_psum_mean`` of their
    gradients over every tensor of ``params`` (the JAX package's
    ``shard_map`` body).  ``loss_fn`` returns a scalar, or a tuple whose
    first item is the one differentiated."""
    from repro_torch.train.optimizer import leaves, rebuild

    def fn(params, batch):
        keys, flat = zip(*leaves(params))
        for t in flat:
            t.requires_grad_(True)
        out = loss_fn(params, batch)
        loss = out[0] if isinstance(out, tuple) else out
        grads = dict(zip(keys, torch.autograd.grad(loss, flat)))
        grads = compressed_psum_mean(rebuild(params, grads), group, block)
        mean = group.all_reduce(loss.detach().to(torch.float32).clone()
                                ) / group.size
        return mean, grads

    return fn
