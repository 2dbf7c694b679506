"""Shared building blocks in torch: norms, rope, linear (raw or LAQ W4A8),
SwiGLU, the GQA projections, the in-place paged KV append, the KV page
quantizer of int8 / fp8 pools, the family forwards' ``remat``, and the
building blocks of tensor-parallel training (:func:`row_linear`,
:func:`tp_swiglu`, :func:`tp_attn_apply` -- causal or not, self- or
cross-attention --, :func:`vocab_embed`, and for a rank's own channels of
whole leaves or whole-width products :func:`own_slice`,
:func:`whole_weight` and :func:`cut_rmsnorm`).

Public functions keep the JAX package's layouts: activations are
``(B, H, T, D)`` after projection, pool slices ``(num_pages, page_size,
Hkv, D)``, weights ``(in, out)`` and W4A8 codes ``(K, N)``.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch.utils import checkpoint as _ckpt

from repro_torch.core import quant
from repro_torch.distributed.collectives import (copy_to, gather_from,
                                                 gather_sum, reduce_from)
from repro_torch.distributed.sharding import gather, head_cut
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


def linear(x: torch.Tensor, w, reciprocal_scale: bool = True
           ) -> torch.Tensor:
    """Apply a linear map; ``w`` is a raw (in, out) tensor or a
    QuantizedLinear.  The quantized branch is the ITA device datapath: per-row
    INT8 activations times the hardwired INT4 codes through the W4A8 op
    (the CUDA kernel on the packed codes for a CUDA tensor, the plain
    version on the codes on the CPU); ``reciprocal_scale`` goes to the
    activation quantizer (``quantize_activations_int8(reciprocal=)``):
    True, the scale of the JAX package's compiled programs, which every
    model's step follows; False, its eager ops' division (the split-brain
    engine's eager loop)."""
    if isinstance(w, quant.QuantizedLinear):
        shape = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        qx, xs = quant.quantize_activations_int8(x2,
                                                 reciprocal=reciprocal_scale)
        y = ops.w4a8_matmul(qx, xs, w.codes, w.scales, out_dtype=x.dtype,
                            packed=w.packed)
        return y.reshape(*shape, w.codes.shape[-1])
    return x @ w.to(x.dtype)


def head_logits(x: torch.Tensor, head, dtype) -> torch.Tensor:
    """The float32 LM-head product ``x @ head``; a LAQ-quantized head
    (``ita.quantize_weights``: a QuantizedLinear) is the W4A8 product of
    ``x`` in the compute ``dtype``, converted to float32, as the JAX
    package's ``linear(x, head).astype(float32)``."""
    if isinstance(head, quant.QuantizedLinear):
        return linear(x.to(dtype), head).to(torch.float32)
    return x @ head


def in_width(w) -> int:
    """The input width of a raw (in, out) weight or a QuantizedLinear (a
    whole weight: row-parallel weights are never cut)."""
    return (w.codes if isinstance(w, quant.QuantizedLinear) else w).shape[-2]


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


def swiglu(x: torch.Tensor, w1, w3, w2, reciprocal_scale: bool = True,
           tp=None) -> torch.Tensor:
    """FFN(x) = W2 . (silu(W1 x) * (W3 x)) — eq. (4)/(5) of the paper.

    Under tensor parallelism (``tp``, a ``TPGroup``) ``w1`` / ``w3`` are this
    rank's column blocks and ``w2`` is whole: the hidden activation is
    gathered before the W2 product (the JAX package's ``pin_fn``,
    ``sharding.pin_tp_exact``), so no float sum crosses ranks."""
    r = reciprocal_scale
    h = silu(linear(x, w1, r)) * linear(x, w3, r)
    return linear(gather(h, tp, in_width(w2)), w2, r)


# ----------------------------------------------------------------------------
# GQA attention projections
# ----------------------------------------------------------------------------
def qkv_project(p: dict, x: torch.Tensor, num_heads: int, num_kv_heads: int,
                head_dim: int, reciprocal_scale: bool = True, tp=None):
    """The ITA device phase of attention: static linear maps only.
    x (B, T, d) -> q (B, Hq, T, hd), k and v (B, Hkv, T, hd).

    Under tensor parallelism (``tp``) the projections are this rank's
    column blocks: where both head counts divide by the group's size
    (``sharding.head_cut``) the rank keeps its block of heads, else each
    block is gathered and every rank holds every head (a KV head count
    that the group does not divide replicates, as the JAX package's rules
    make it)."""
    cut = head_cut(tp, num_heads, num_kv_heads)
    return tuple(project_heads(x, p[w], n, head_dim, tp, cut,
                               reciprocal_scale)
                 for w, n in (("wq", num_heads), ("wk", num_kv_heads),
                              ("wv", num_kv_heads)))


def project_heads(x: torch.Tensor, w, n: int, head_dim: int, tp=None,
                  cut: bool = False, reciprocal_scale: bool = True
                  ) -> torch.Tensor:
    """x (B, T, d) through ``w`` into heads (B, heads, T, hd): ``n`` heads
    on one device; under tensor parallelism (``tp``) ``w`` is this rank's
    column block, whose heads the rank keeps where ``cut`` (both head
    counts divide, ``sharding.head_cut``), else gathered into all ``n``."""
    B, T, _ = x.shape
    y = linear(x, w, reciprocal_scale)
    if not cut:
        y = gather(y, tp, n * head_dim)
    return y.reshape(B, T, -1, head_dim).transpose(1, 2)


def attn_apply(p: dict, x: torch.Tensor, *, num_heads: int,
               num_kv_heads: int, head_dim: int, positions: torch.Tensor,
               rope_theta: float, window: Optional[int] = None,
               softcap: Optional[float] = None,
               causal: bool = True, kv: Optional[tuple] = None,
               tp=None) -> torch.Tensor:
    """Full attention block over a whole sequence (the forward path): QKV
    projection, rope at ``positions``, ``ops.attention`` (the flash kernel
    on the card, its plain version on the CPU) with ``causal`` / ``window``
    / ``softcap``, and the output projection.  x (B, T, d) -> (B, T, d).

    ``kv = (k, v)``, each (B, Hkv, Tk, hd), is cross-attention: keys and
    values from another sequence, no rope, ``causal`` and ``window`` off.
    The JAX package projects ``wk`` / ``wv`` of ``x`` there too and drops
    them; the port skips those two products (the result is the same).

    Serving under tensor parallelism (``tp``): the projections are the
    rank's column blocks and ``kv`` the rank's heads (:func:`qkv_project`'s
    cut), and the heads' output is gathered before the whole ``wo``
    (``pin_tp_exact``)."""
    B, T, _ = x.shape
    if kv is None:
        q, k, v = qkv_project(p, x, num_heads, num_kv_heads, head_dim, tp=tp)
        q = rope(q, positions, rope_theta)
        k = rope(k, positions, rope_theta)
    else:
        q = project_heads(x, p["wq"], num_heads, head_dim, tp,
                          head_cut(tp, num_heads, num_kv_heads))
        k, v = kv
        causal, window = False, None
    o = ops.attention(q, k, v, causal=causal, window=window, softcap=softcap)
    o = gather(o.transpose(1, 2).reshape(B, T, -1), tp, num_heads * head_dim)
    return linear(o, p["wo"])


# ----------------------------------------------------------------------------
# Tensor-parallel training (Megatron's cuts over the grid's "model" group)
# ----------------------------------------------------------------------------
# A rank holds the column blocks of the ``_COL`` weights and the row blocks
# of the ``_ROW`` weights where the rules cut them (the group's size divides
# the dim): a weight narrower than its whole width is a block.  The residual
# stream is whole on every rank.  A column-cut projection's input passes
# ``copy_to`` (its gradient is the ranks' sum); a row-cut projection's
# partial products meet in ``reduce_from``, summed in float32 and rounded
# once to the compute dtype.
def row_linear(x: torch.Tensor, w: torch.Tensor, model) -> torch.Tensor:
    """``x @ w`` for ``x`` a rank's column block of the input and ``w`` the
    matching row block: each rank's partial product is taken in float32
    from the compute-dtype values of ``x`` and ``w`` (exact products and
    float32 sums, as the compute dtype's GEMM accumulates before it
    rounds), the ranks' partials are summed in float32, and the sum is
    rounded once to ``x``'s dtype, as one device rounds the whole product
    once (a partial rounded to the compute dtype before the sum rounds
    twice, and where the partials cancel the second rounding's error is
    large against the sum)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    partial = x.to(acc) @ w.to(x.dtype).to(acc)
    return reduce_from(partial, model).to(x.dtype)


def tp_swiglu(x: torch.Tensor, w1, w3, w2, model, d_ff: int) -> torch.Tensor:
    """:func:`swiglu` with ``w1`` / ``w3`` column-cut and ``w2`` row-cut on
    ``d_ff`` (each rank its block of the hidden units); whole weights (a
    ``d_ff`` the group does not divide) run whole on every rank."""
    if w1.shape[-1] == d_ff:
        return swiglu(x, w1, w3, w2)
    xc = copy_to(x, model)
    h = silu(linear(xc, w1)) * linear(xc, w3)
    return row_linear(h, w2, model)


def tp_attn_apply(p: dict, x: torch.Tensor, model, *, num_heads: int,
                  num_kv_heads: int, head_dim: int, positions: torch.Tensor,
                  rope_theta: float, window: Optional[int] = None,
                  softcap: Optional[float] = None, causal: bool = True,
                  source: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`attn_apply` over the model group: self-attention with rope
    (``causal`` or not: the decoders, and the encoder), or, given
    ``source`` (B, Tk, d), cross-attention whose K/V are projected from it
    (no rope, not causal, no window), as :func:`attn_apply` with ``kv=``.
    Where both head counts divide by the group's size
    (``sharding.head_cut``) a rank projects its own ``Hq/tp`` query heads
    and ``Hkv/tp`` KV heads (contiguous blocks keep each GQA group whole:
    ``ops.attention``, the flash kernel on the card) and ``wo``'s row block
    takes its heads' output (:func:`row_linear`); ``x`` and ``source``
    pass ``copy_to``, so their gradients are the ranks' sums.  Otherwise
    the cut weights are gathered (``gather_from``) and every rank runs
    every head, as the serve path does where the KV heads do not divide."""
    if source is not None:
        causal, window = False, None
    if not head_cut(model, num_heads, num_kv_heads):
        widths = {"wq": num_heads, "wk": num_kv_heads, "wv": num_kv_heads}
        whole = {k: (gather_from(p[k], model, -1)
                     if p[k].shape[-1] != n * head_dim else p[k])
                 for k, n in widths.items()}
        wo = p["wo"]
        whole["wo"] = (gather_from(wo, model, -2)
                       if wo.shape[-2] != num_heads * head_dim else wo)
        kv = None if source is None else tuple(
            project_heads(source, whole[w], num_kv_heads, head_dim)
            for w in ("wk", "wv"))
        return attn_apply(whole, x, num_heads=num_heads,
                          num_kv_heads=num_kv_heads, head_dim=head_dim,
                          positions=positions, rope_theta=rope_theta,
                          window=window, softcap=softcap, causal=causal,
                          kv=kv)
    B, T, _ = x.shape
    xc = copy_to(x, model)

    def heads(a, w):
        return linear(a, w).reshape(a.shape[0], a.shape[1], -1,
                                    head_dim).transpose(1, 2)

    q = heads(xc, p["wq"])
    if source is None:
        q = rope(q, positions, rope_theta)
        k = rope(heads(xc, p["wk"]), positions, rope_theta)
        v = heads(xc, p["wv"])
    else:
        sc = copy_to(source, model)
        k, v = heads(sc, p["wk"]), heads(sc, p["wv"])
    o = ops.attention(q, k, v, causal=causal, window=window, softcap=softcap)
    return row_linear(o.transpose(1, 2).reshape(B, T, -1), p["wo"], model)


def own_slice(t: torch.Tensor, model, width: int, dim: int = -1
              ) -> torch.Tensor:
    """A rank's block of a leaf that every rank holds whole (a norm scale,
    a decay base, a per-head bonus: no rule cuts it), for a computation on
    the rank's own channels or heads: ``t`` passes ``copy_to`` first, so
    its gradient, which each rank gives only on its block, is the ranks'
    sum.  ``width``: the rank's block's size along ``dim``."""
    return copy_to(t, model).narrow(dim, model.rank * width, width)


def whole_weight(w: torch.Tensor, model, dim: int, width: int
                 ) -> torch.Tensor:
    """A weight whole on every rank for a computation whose consumer
    differs by rank (each rank keeps its own channels of the product):
    a block cut on ``dim`` (narrower than ``width``) is gathered with
    ``gather_sum`` (the backward sums the ranks' gradients and keeps the
    rank's block), a whole one passes ``copy_to`` (its gradient is the
    ranks' sum)."""
    if w.shape[dim] == width:
        return copy_to(w, model)
    return gather_sum(w, model, dim)


def cut_rmsnorm(x: torch.Tensor, gamma: torch.Tensor, width: int, model,
                eps: float = 1e-6) -> torch.Tensor:
    """:func:`rmsnorm` over ``width`` channels of which ``x`` holds the
    rank's block (``gamma`` its block of the scale): each rank's float32
    sum of squares is all-reduced (``reduce_from``, then ``copy_to``: the
    total's gradient, which each rank gives for its own channels, is
    summed back), and each rank normalizes its block."""
    x32 = x.to(torch.float32)
    ss = copy_to(reduce_from(torch.sum(x32 * x32, dim=-1, keepdim=True),
                             model), model)
    out = (x32 * torch.rsqrt(ss / width + eps)) * (
        1.0 + gamma.to(torch.float32))
    return out.to(x.dtype)


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor, model,
                vocab: int) -> torch.Tensor:
    """Float32 embedding rows of ``tokens`` from ``table``: the whole (V, d)
    table, or a rank's block of ``V / tp`` rows (vocabulary-parallel: a
    rank looks up the ids it holds, zeroes the rest, and the ranks' rows
    are summed, which adds only zeros: the rows are exact)."""
    idx = tokens.to(torch.int64)
    if table.shape[0] == vocab:
        return table[idx]
    n = table.shape[0]
    local = idx - model.rank * n
    inside = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    return reduce_from(rows, model)


# ----------------------------------------------------------------------------
# Paged KV append
# ----------------------------------------------------------------------------
# Physical page 0 of every page pool is the reserved scratch page: writes for
# inactive slots are routed there so a step never depends on the active set.
SCRATCH_PAGE = 0


def layer_views(tree, lead: int = 1) -> Callable:
    """Per-layer views of a tree of stacked params (each tensor with
    ``lead`` leading layer axes): ``at(*index)`` gives the tree of one
    layer.  The views come from ``unbind``, one autograd node per leaf,
    whose backward stacks the layers' gradients once; indexing a leaf per
    layer would add a full-size, zero-padded gradient per layer instead
    (quadratic in the depth).  The values are the same slices, and the
    gradients the same sums.  A LAQ-quantized leaf (QuantizedLinear, which
    serves inference only) is indexed per layer, its codes, scales and
    packed codes together."""
    def split(t, n):
        if n == 0:
            return t
        if isinstance(t, quant.QuantizedLinear):
            return [split(t[i], n - 1) for i in range(t.codes.shape[0])]
        return [split(u, n - 1) for u in t.unbind(0)]

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if torch.is_tensor(node) or isinstance(node, quant.QuantizedLinear):
            return split(node, lead)
        return node

    views = walk(tree)

    def at(*index):
        def get(node):
            if isinstance(node, dict):
                return {k: get(v) for k, v in node.items()}
            if isinstance(node, list):
                for i in index:
                    node = node[i]
            return node
        return get(views)

    return at


# the matmuls whose outputs remat="dots" keeps: dot products with no batch
# dimension, as JAX's ``dots_with_no_batch_dims_saveable`` policy keeps
# (projections: ``x @ w`` lowers to ``mm``; the attention einsums are
# ``bmm``, recomputed)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return _ckpt.create_selective_checkpoint_contexts(_save_dots)


def _wants_grad(tree) -> bool:
    if torch.is_tensor(tree):
        return tree.requires_grad
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return False
    return any(_wants_grad(v) for v in tree)


def remat(fn: Callable, mode: str, policy: bool = True) -> Callable:
    """``fn`` under the config's ``parallel.remat`` (the JAX package's
    ``jax.checkpoint`` of a layer or a layer group): ``"none"`` keeps every
    activation for the backward; ``"full"`` keeps only ``fn``'s inputs and
    recomputes the rest in the backward
    (``torch.utils.checkpoint.checkpoint``, non-reentrant); ``"dots"``
    also keeps the outputs of the products without batch dims (a selective
    checkpoint) where ``policy`` is set, as the lm family's group does,
    and is ``"full"`` otherwise, as the other families' layers are in the
    JAX package.  Values and gradients are those of ``"none"``: the
    recomputation repeats the same ops.  ``fn`` runs as it is outside grad
    mode and where no tensor among its arguments (walked through dicts,
    lists and tuples: pass the params it reads) requires grad, as in
    serving."""
    if mode not in ("none", "full", "dots"):
        raise ValueError(f"remat {mode!r} not in none/full/dots")
    if mode == "none":
        return fn
    kw = ({"context_fn": _dots_context} if mode == "dots" and policy
          else {})

    def run(*args):
        if not (torch.is_grad_enabled() and _wants_grad(args)):
            return fn(*args)
        return _ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)

    return run


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


def paged_append(pool, tok: torch.Tensor, page: torch.Tensor,
                 off: torch.Tensor):
    """Write each slot's token ``tok`` (B, Hkv, D) at ``(page, off)`` of one
    layer's pool slice, IN PLACE: a float pool takes one ``index_put_`` of
    B token rows; a :class:`~repro_torch.core.quant.QuantizedLeaf` takes the
    quantize-on-write page append (:func:`quant_page_append`).  Returns
    ``pool``."""
    if isinstance(pool, QuantizedLeaf):
        quant_page_append(pool.codes, pool.scales, tok, page, off,
                          pool.kv_dtype)
        return pool
    pool[page, off] = tok.to(pool.dtype)
    return pool


def paged_cache_write(pool, new: torch.Tensor, table: torch.Tensor,
                      pos: torch.Tensor, write: torch.Tensor):
    """Append one token's K or V per slot directly into the page pool, IN
    PLACE: ``pool`` is one layer's slice ``(num_pages, page_size, Hkv, D)``
    (a view into the stacked pool, or a ``QuantizedLeaf`` of such codes and
    their ``(num_pages, Hkv)`` scales), so a step moves O(B x token bytes)
    of a float pool and O(B x page bytes) of a quantized one, never the
    pool.

    new: (B, Hkv, 1, D); table: (B, P) physical page ids; pos: (B,) write
    positions (== ``len``); write: (B,) bool — inactive slots land on the
    scratch page.  Returns ``pool`` (the same object, updated)."""
    page, off = page_offsets(table, pos, write, pool.shape[1])
    return paged_append(pool, new[:, :, 0, :], page, off)


# ----------------------------------------------------------------------------
# KV page quantization (int8 / fp8 pools)
# ----------------------------------------------------------------------------
QuantizedLeaf = quant.QuantizedLeaf
KV_DTYPES = quant.KV_DTYPES
KV_QMAX = quant.KV_QMAX

# The JAX package's compiled programs compute the page scale as
#     exp(ceil(log(max(amax, 1e-30) * (1 / qmax)) * 1.44269502) * 0.693147182)
# (XLA folds the two divisions into multiplies and lowers exp2 to exp), with
# XLA's own float32 log and exp on the CPU.  Neither is correctly rounded,
# and only two of their properties reach the scale:
#   * where ceil steps: for r = amax * (1 / qmax) near 2^k the exponent
#     becomes k + 1 from the float32 whose bit pattern is that of 2^k plus
#     _LOG_STEP_ULPS[k + 110] (k in [-110, 127]), which can fall a few ulps
#     below 2^k or step only past it;
#   * the value of exp(e * 0.693147182) for an integer e: 2^e plus
#     _EXP2_ULPS[e + 110] float32 ulps (e in [-110, 128]; exact for e in
#     [-13, 13]).
# Both tables were read off XLA's compiled CPU programs; tests compare them
# with the JAX package at every entry, so a scale here is the reference's,
# bit for bit, on any device (the lookups are comparisons and an index).
_LOG_STEP_ULPS = (
    7, -11, -35, 35, 23, 11, -3, -27, 39, 27, 15, 3, -19, 43, 31, 19, 7, -10,
    31, 19, 7, 27, 15, 3, 23, 11, 31, 19, 7, 27, 15, 3, 23, 11, 31, 19, 7, 27,
    15, 3, 23, 11, 31, 19, 7, 27, 15, 3, -17, 12, -1, 20, 8, -9, 16, 4, -17,
    12, -1, 20, 8, -9, 16, 4, 16, 4, 8, 12, 16, 4, 8, 12, 16, 4, 8, 12, 16, 4,
    8, -8, 0, 4, 8, -8, 0, 4, 8, 8, 4, 8, 4, 8, 4, 8, 4, 0, 4, 0, 4, 2, 2, 2,
    2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3, 3, 3, 5, 1, 5, 1, 5,
    9, 5, 9, 5, 9, 5, 9, 9, 13, 1, 5, 9, 13, 1, 5, 9, 13, 17, 21, 9, 13, 17,
    21, 9, 13, 17, 21, 9, 13, 17, 29, 17, 5, 25, 13, 1, 21, 9, 29, 17, 5, 25,
    13, 1, 21, 9, 30, 18, 38, 26, 14, 34, 22, 42, 30, 18, 38, 26, 14, 34, 22,
    42, 30, 18, 38, 26, 14, 34, 22, 42, 30, 18, 38, 26, 14, 34, 6, 58, 46, 34,
    22, 10, 62, 50, 38, 26, 14, 2, 54, 42, 30, 18, 6, 58, 46, 34, 22, 10, 62,
    50, 38, 26, 14, 2, 54, 42, 30, 18, 6, 59, 47)
_EXP2_ULPS = (
    -52, 26, 14, 2, -19, -43, -67, 18, 6, -11, -35, -59, 22, 10, -3, -27, -51,
    27, 15, 3, -19, 11, -3, -27, 7, -11, -35, 3, -19, 11, -3, -27, 7, -10, 15,
    3, -18, 11, -2, -26, 7, -10, -34, 3, -18, 11, -2, -26, 7, -10, 15, 3, -18,
    11, -2, -26, 7, -10, -34, 3, -18, 11, -2, -26, 7, -9, -1, 3, -17, -9, -1,
    3, 7, -9, -1, 3, -17, -9, -1, 4, 8, -9, -1, 4, -17, -9, -1, 4, -1, -9, -1,
    4, -1, -9, -1, 4, 0, -8, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 4, 0, -8, 0, 4, 0, -7, 0, 4, 0, -7, 0, 4, 8,
    -7, 0, 4, -15, -7, 1, 5, 9, -7, 1, 5, -15, -7, 1, 5, 9, -7, 1, 5, -15, 13,
    1, -22, 9, -6, 17, 5, -14, 13, 1, -22, 9, -6, -30, 5, -14, 13, 1, -22, 9,
    -6, 17, 5, -14, 13, 1, -22, 9, -6, -30, 5, -14, 13, 1, -21, 9, -5, 17, 5,
    -13, 13, 1, -21, 9, -5, -29, -53, 26, 14, 2, -21, -45, 30, 18, 6, -13, -37,
    34, 22, 10, -5, -29, -53, 26, 14, 2, -20, -44, 30, 18, 6, -12, -36, -60,
    22, 10, -4, -28, -52, 26, 14, 0)
_E_MIN = -110
_SCALE_TABLES = {}


def _scale_tables(device):
    """(ceil step points as float32, scale per exponent) on ``device``,
    built once per device from the two tables above."""
    key = str(device)
    if key not in _SCALE_TABLES:
        ks = torch.arange(_E_MIN, _E_MIN + len(_LOG_STEP_ULPS),
                          dtype=torch.int32)
        steps = ((ks + 127) * (1 << 23)
                 + torch.tensor(_LOG_STEP_ULPS, dtype=torch.int32))
        es = torch.arange(_E_MIN, _E_MIN + len(_EXP2_ULPS), dtype=torch.int64)
        exact = torch.ldexp(torch.ones(len(es), dtype=torch.float64), es).to(
            torch.float32)
        vals = (exact.view(torch.int32)
                + torch.tensor(_EXP2_ULPS, dtype=torch.int32)).view(
            torch.float32)
        _SCALE_TABLES[key] = (steps.view(torch.float32).to(device),
                              vals.to(device))
    return _SCALE_TABLES[key]


def kv_pow2_scale(amax: torch.Tensor, kv_dtype: str) -> torch.Tensor:
    """The page scale for a page whose largest |value| is ``amax``: nominally
    the smallest power of two s with ``amax / s <= qmax``, and exactly the
    float32 the JAX package's compiled programs compute for it (see the
    tables above: near a power of two and below 2^-13 or above 2^13 it is
    not a power of two there).  ``amax`` float32 of any shape."""
    steps, vals = _scale_tables(amax.device)
    r = torch.clamp_min(amax.to(torch.float32), 1e-30) * (
        1.0 / KV_QMAX[kv_dtype])
    # r is a positive float32; its exponent is E_MIN + the count of steps <= r
    e = torch.bucketize(r, steps, right=True)
    return vals[e]


def kv_quantize(x: torch.Tensor, scale: torch.Tensor,
                kv_dtype: str) -> torch.Tensor:
    """Encode float32 values into page codes under a (broadcastable) scale:
    ``round(x / scale)`` (half to even) clipped to +-127 for int8, a
    round-to-nearest-even cast to float8_e4m3fn for fp8."""
    y = x.to(torch.float32) / scale
    if kv_dtype == "int8":
        return torch.clamp(torch.round(y), -127, 127).to(torch.int8)
    return y.to(KV_DTYPES[kv_dtype])


def kv_dequantize(codes: torch.Tensor, scale: torch.Tensor,
                  out_dtype=torch.float32) -> torch.Tensor:
    """codes x scale in float32, then ``out_dtype``."""
    return (codes.to(torch.float32) * scale).to(out_dtype)


def byte_view(codes: torch.Tensor) -> torch.Tensor:
    """fp8 codes as uint8 (the same bytes), so that indexed reads and writes
    need no fp8 kernel on any device; other dtypes as they are."""
    return (codes.view(torch.uint8) if codes.dtype == torch.float8_e4m3fn
            else codes)


def quant_page_append(codes: torch.Tensor, scales: torch.Tensor,
                      tok: torch.Tensor, page: torch.Tensor, off: torch.Tensor,
                      kv_dtype: str) -> None:
    """The quantize-on-write page append, IN PLACE.

    codes: (N, ps, *rest) pool codes with the page axes leading (a view is
    fine); scales: (N, *rest[:-1]) the matching per-page scales; tok:
    (B, *rest) the new token; page / off: (B,) int64 write coordinates
    (:func:`page_offsets`).  The incoming token can exceed a page's range,
    so each touched page is dequantized, the token inserted at ``off`` and
    the whole page re-encoded under ``max(old_scale, needed)``:

      * ``off == 0`` is a fresh (or recycled) page: its stale scale counts
        as zero and its positions past ``off`` are masked out, so a reused
        page never leaks a stale amax into the new sequence's scale;
      * the scale never shrinks within a page's lifetime.

    Duplicate ``page`` entries occur only on the scratch page (inactive
    slots), whose content is garbage by contract: a live append page is
    private to its slot (copy-on-write), so no live page is written twice.
    """
    nd = codes.ndim
    ps = codes.shape[1]
    B = tok.shape[0]
    f32 = torch.float32

    def _x(s):   # (B, *rest[:-1]) -> broadcast over (B, ps, *rest)
        return s.reshape((B, 1) + tuple(s.shape[1:]) + (1,))

    cb = byte_view(codes)
    cp = cb[page].view(codes.dtype).to(f32)               # (B, ps, *rest)
    sp = scales[page]                                     # (B, *rest[:-1])
    fresh = (off > 0).reshape((B,) + (1,) * (sp.ndim - 1))
    sp_eff = torch.where(fresh, sp, torch.zeros((), dtype=f32,
                                                device=sp.device))
    old = cp * _x(sp_eff)
    idx = torch.arange(ps, device=codes.device)[None, :]
    shape = (B, ps) + (1,) * (nd - 2)
    keep = (idx < off[:, None]).reshape(shape)
    ins = (idx == off[:, None]).reshape(shape)
    merged = torch.where(keep, old, torch.zeros((), dtype=f32,
                                                device=old.device))
    merged = torch.where(ins, tok[:, None].to(f32), merged)
    amax = merged.abs().amax(dim=(1, nd - 1))             # (B, *rest[:-1])
    new_sc = torch.maximum(sp_eff, kv_pow2_scale(amax, kv_dtype))
    q = kv_quantize(merged, _x(new_sc), kv_dtype)
    cb[page] = byte_view(q)
    scales[page] = new_sc


def fake_quant_pages(leaf: torch.Tensor, s_ax: int, n_tokens: int,
                     page_size: int, kv_dtype: str) -> torch.Tensor:
    """Round-trip the COMPLETED pages of a dense request-cache leaf through
    the page quantizer (quantize, then dequantize, dense dtype kept), IN
    PLACE, and return ``leaf``.

    Pages wholly below ``n_tokens`` are frozen at quantized precision the
    moment they complete, so a chunk stream attends to exactly the values a
    later reader dequantizes out of the pool (prefix sharing on or off
    gives the same tokens); the partial tail page stays dense until
    insertion.  Per-page scales reduce over the within-page axis and the
    trailing head_dim axis, as the pool's per-page x per-KV-head scales do.
    Every completed page is re-encoded on every call, as in the JAX
    package."""
    done = int(n_tokens) // page_size
    if done == 0:
        return leaf
    x = torch.movedim(leaf, s_ax, 0)[:done * page_size]   # (done*ps, *rest)
    xp = x.reshape((done, page_size) + tuple(x.shape[1:])).to(torch.float32)
    amax = xp.abs().amax(dim=(1, xp.ndim - 1), keepdim=True)
    sc = kv_pow2_scale(amax, kv_dtype)
    rt = kv_dequantize(kv_quantize(xp, sc, kv_dtype), sc)
    x.copy_(rt.reshape(x.shape).to(leaf.dtype))
    return leaf


def store_rows(dst: torch.Tensor, new: torch.Tensor,
               write: Optional[torch.Tensor]) -> None:
    """dst <- new IN PLACE, on the rows (leading axis) where ``write`` (B,)
    bool is True (every row when it is None): the recurrent families'
    frozen-slot state update."""
    if write is not None:
        new = torch.where(write.reshape((-1,) + (1,) * (new.dim() - 1)),
                          new, dst)
    dst.copy_(new)


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


# ----------------------------------------------------------------------------
# A dense cache cut on its sequence (parallel.decode_attn="shard_map" under
# tensor parallelism): rank r of the group holds the positions [r S, (r + 1)
# S) of every KV head, S its local length
# ----------------------------------------------------------------------------
def seq_cache_write(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
                    tp, write: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Write one token's K or V, ``new`` (B, Hkv, 1, D) every head, at the
    global positions ``pos`` (B,) of a cache cut on its sequence, IN PLACE:
    the rank that holds a row's position writes it, every other rank's
    write is masked (it writes back the entry it holds; ``cache_write``'s
    ragged form, one entry per row, no host sync).  Returns ``cache``."""
    S = cache.shape[2]
    local = pos.to(torch.int64) - tp.rank * S
    own = (local >= 0) & (local < S)
    if write is not None:
        own &= write
    return cache_write(cache, new, torch.clamp(local, 0, S - 1),
                       aligned=False, write=own)


def seq_cache_fill(cache: torch.Tensor, new: torch.Tensor, tp) -> None:
    """A block prefill's K or V, ``new`` (B, Hkv, T, D) every head at the
    positions 0..T-1, into a fresh cache cut on its sequence, IN PLACE: the
    rank's own positions among them."""
    S, T = cache.shape[2], new.shape[2]
    start = tp.rank * S
    n = min(max(T - start, 0), S)
    if n:
        cache[:, :, :n] = new[:, :, start:start + n].to(cache.dtype)


def seq_cache_put(cache: torch.Tensor, new: torch.Tensor, start: torch.Tensor,
                  tp) -> None:
    """A prefill chunk's K or V, ``new`` (B, Hkv, W, D) every head at the
    positions ``start[b] .. start[b] + W - 1``, into a cache cut on its
    sequence, IN PLACE: each of the rank's positions that the chunk covers
    takes its entry (a select over the rank's whole block, so no two writes
    meet at one entry)."""
    B, _, S, _ = cache.shape
    W = new.shape[2]
    g = tp.rank * S + torch.arange(S, device=cache.device)
    j = g[None, :] - start.to(torch.int64)[:, None]              # (B, S)
    mask = (j >= 0) & (j < W)
    idx = torch.clamp(j, 0, W - 1)[:, None, :, None].expand(
        B, new.shape[1], S, new.shape[3])
    val = torch.gather(new.to(cache.dtype), 2, idx)
    cache.copy_(torch.where(mask[:, None, :, None], val, cache))
