"""Decoder-only Llama-family LM: the lm family's dense, windowed (gemma2),
MoE and cross-attention (VLM) members.

Params are plain dicts of tensors with the JAX package's layout: every
per-layer array has leading dims ``(n_groups, group_size, ...)`` from
:func:`group_layout`, and a VLM's cross-attention blocks ``params["cross"]``
lead with ``n_groups`` (one block after each group of ``cross_attn_every``
layers), so a params tree converted from the JAX package
(``models/api.py::params_from_numpy``) and one made here have the same
structure.  The whole-sequence ``forward`` and the float serve path are
here: ``init_cache`` (with a VLM's ``frontend``, the cross K/V projected
once per request), the block ``prefill`` (flash attention over the
prompt), the chunked prefill's block path ``prefill_chunk``, the dense
``decode_step`` and the ``paged_decode_step`` through the page pool (a
windowed layer's ring buffer, gemma2's local layers, stays dense beside the
paged global layers), all updating the cache IN PLACE where the JAX package
returned a new one.  Numerics follow the JAX package's compiled programs
(XLA's excess precision, its tanh and its dot order; see ``_block_tail``,
``_norm_input``, ``_cross_apply`` and ``_logits_head``): logits are
bit-identical on the CPU.  A config with ``moe`` takes the MoE FFN
(``models/moe.py``) in place of the dense one in every block.  A
cross-attention config runs through ``forward``, the block ``prefill`` and
the dense ``decode_step`` only (the JAX package serves it through
``generate()`` alone); the split-brain slice's token loop lives in
``serve/splitbrain_engine.py``.

On a training grid (``forward(layout=)``, ``distributed/sharding.py::
Layout``) the params are a rank's blocks: each layer gathers its FSDP
blocks over "data" inside the remat'd group (``Layout.gather_fsdp``), and
over "model" every config runs Megatron's cuts (``layers.tp_attn_apply``,
a VLM's cross blocks through it with the frontend as the K/V source,
``layers.tp_swiglu``, the vocabulary-parallel ``layers.vocab_embed`` and
head) and a MoE config expert parallelism (``moe.moe_apply(model=)``);
the residual stream is whole on every model rank and the logits come out
cut on the vocabulary.  Under data parallelism a MoE FFN routes the whole
batch's rows (all-gathered), so its capacity, drops and ``aux`` are the
one-device program's.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import copy_to, gather_sum
from repro_torch.distributed.sharding import (gather, gather_heads, head_cut,
                                              lse_decode, seq_group,
                                              seq_to_heads)
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod


def group_layout(cfg: ModelConfig) -> Tuple[int, int]:
    P = len(cfg.layer_pattern)
    group_size = cfg.cross_attn_every if cfg.cross_attn_every else P
    assert cfg.num_layers % group_size == 0, (cfg.num_layers, group_size)
    assert group_size % P == 0, (group_size, P)
    return cfg.num_layers // group_size, group_size


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda", dtype=torch.float32) -> Dict[str, Any]:
    """Random params drawn from ``generator`` on ``device``: normal(0, 0.02)
    float32 embeddings, zero float32 norm scales and uniform ``dense_init``
    projections stored in ``dtype``, as in the JAX package (whose random
    bits differ; tests convert the JAX package's params instead).

    Each projection is drawn one (layer, matrix) slice at a time in float32
    and rounded into its leaf, so no more than one matrix's float32 draw
    exists at once: with ``dtype=torch.bfloat16`` full-width gemma2-27b
    takes 52 GB of projections where a float32 tree would take 104 GB.
    With ``cfg.moe`` a block holds ``moe`` (router and expert stacks,
    ``moe.moe_init``, drawn the same way) instead of ``mlp``.  With
    ``cfg.cross_attn_every`` the tree holds ``cross``: per group a norm
    scale ``ln``, the projections ``attn`` and a scalar ``gate``, zero as
    in the JAX package (which makes a fresh model's cross blocks add
    nothing: ``tanh(0) = 0``)."""
    if cfg.family != "lm":
        raise NotImplementedError(f"{cfg.name}: not an lm-family config")
    n_groups, group_size = group_layout(cfg)
    hd = cfg.resolved_head_dim
    d, f = cfg.d_model, cfg.d_ff
    f32 = torch.float32

    def dense(in_dim, out_dim, lead=(n_groups, group_size)):
        w = torch.empty(lead + (in_dim, out_dim), dtype=dtype, device=device)
        for i in range(math.prod(lead)):
            w.view((-1, in_dim, out_dim))[i] = L.dense_init(
                in_dim, out_dim, generator, device=device)
        return w

    def attn(lead=(n_groups, group_size)):
        return {"wq": dense(d, cfg.num_heads * hd, lead),
                "wk": dense(d, cfg.num_kv_heads * hd, lead),
                "wv": dense(d, cfg.num_kv_heads * hd, lead),
                "wo": dense(cfg.num_heads * hd, d, lead)}

    def zeros(*shape):
        return torch.zeros(shape, dtype=f32, device=device)

    embed = torch.empty((cfg.vocab_size, d), dtype=f32, device=device)
    embed.normal_(0.0, 1.0, generator=generator).mul_(0.02)
    params: Dict[str, Any] = {
        "embed": embed,
        "blocks": {
            "ln_attn": zeros(n_groups, group_size, d),
            "ln_mlp": zeros(n_groups, group_size, d),
            "attn": attn(),
        },
        "ln_final": zeros(d),
    }
    if cfg.moe:
        params["blocks"]["moe"] = moe_mod.moe_init(
            d, f, cfg.moe, generator, lead=(n_groups, group_size),
            device=device, dtype=dtype)
    else:
        params["blocks"]["mlp"] = {"w1": dense(d, f), "w3": dense(d, f),
                                   "w2": dense(f, d)}
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(d, cfg.vocab_size, generator,
                                         device=device).to(dtype)
    if cfg.cross_attn_every:
        params["cross"] = {"ln": zeros(n_groups, d),
                           "attn": attn((n_groups,)),
                           "gate": zeros(n_groups)}
    return params


# ----------------------------------------------------------------------------
# KV cache, prefill and decode (lm block path)
# ----------------------------------------------------------------------------
# Batch axis of each serve-cache entry (the K/V lists share theirs): leaves
# (n_groups, gs // P, B, Hkv, S, hd), len (B,), a VLM's cross K/V
# (n_groups, B, Hkv, Tx, hd).  Which leaves page is found by the engine from
# two cache builds (``serve/pages.py::seq_axes``): every K/V leaf but a
# windowed ring (gemma2's local layers).
BATCH_AXES = {"k": 2, "v": 2, "len": 0, "cross_k": 1, "cross_v": 1}


def serve_params(params, cfg: ModelConfig, device) -> Dict[str, Any]:
    """The serving engine's copy of the float params on ``device``: the
    attention projections and the FFN's (the MLP's, or the MoE router and
    expert stacks; the reference reads the router in the compute dtype too)
    cast once to the compute dtype, embedding and norm scales kept float32
    (a tensor already in place is not copied).
    The LM head -- an untied ``lm_head``, or the embedding of a tied one --
    is rounded once to the compute dtype and held in float32, the operand
    of :func:`_logits_head`'s float32 product, so no step copies or casts
    it; rounding is idempotent, so the embedding's gather-then-cast gives
    the same bits as from the unrounded table.  A VLM's cross blocks get
    the same treatment: projections cast, norm scales and gates kept."""
    dtype = getattr(torch, cfg.dtype)
    blocks = params["blocks"]

    def cast(tree):
        return {k: w.to(device=device, dtype=dtype) for k, w in tree.items()}

    embed = params["embed"].to(device)
    if cfg.tie_embeddings:
        embed = embed.to(dtype).to(torch.float32)
    ffn = "moe" if cfg.moe else "mlp"
    out = {"embed": embed,
           "ln_final": params["ln_final"].to(device),
           "blocks": {"ln_attn": blocks["ln_attn"].to(device),
                      "ln_mlp": blocks["ln_mlp"].to(device),
                      "attn": cast(blocks["attn"]),
                      ffn: cast(blocks[ffn])}}
    if "lm_head" in params:
        out["lm_head"] = params["lm_head"].to(device=device, dtype=dtype).to(
            torch.float32)
    if cfg.cross_attn_every:
        cross = params["cross"]
        out["cross"] = {"ln": cross["ln"].to(device),
                        "attn": cast(cross["attn"]),
                        "gate": cross["gate"].to(device)}
    return out


def prefill_fits(cache, prompt_len: int, cfg: ModelConfig, tp=None) -> bool:
    """True when every KV leaf can hold the whole prompt, so that the block
    :func:`prefill` can take it in one pass (a leaf cut on its sequence
    holds ``tp`` times its local length)."""
    n = 1 if seq_group(cfg, tp) is None else tp.size
    return all(a.shape[4] * n >= prompt_len for a in cache["k"])


# the cache leaves that the sequence-cut dense decode cuts on their sequence
# (``sharding.seq_group``): every self-attention K/V leaf; a VLM's cross K/V
# are attended by the flash kernel and keep the head cut
SEQ_CUT = ("k", "v")


def _check_block_path(cfg: ModelConfig, cross_ok: bool = False) -> None:
    """The lm family only; a cross-attention config only where ``cross_ok``
    (``init_cache``, the block ``prefill`` and the dense ``decode_step``,
    the JAX package's ``generate()`` path): the chunked prefill and the
    paged step have no cross block, and the slot cache that would reach
    them is refused, as in the reference."""
    if cfg.family != "lm":
        raise NotImplementedError(f"{cfg.name}: not an lm-family config")
    if cfg.cross_attn_every and not cross_ok:
        raise ValueError(
            f"{cfg.name}: continuous batching covers the text-only families "
            "(frontend_tokens / cross-attention configs are not "
            "slot-servable)")


def _layers(params, cfg: ModelConfig):
    """Per-layer views in the JAX package's scan order: yields
    ``(spec, slot, (g, j // P), params of layer (g, j))`` where ``slot`` is
    the layer-pattern slot whose cache leaf holds the layer at index
    ``(g, j // P)``."""
    for g in range(group_layout(cfg)[0]):
        yield from _group_layers(params, cfg, g)


def _group_layers(params, cfg: ModelConfig, g: int, at=None):
    """:func:`_layers`' views of group ``g``'s layers; ``at(g, j)`` gives
    layer (g, j)'s params (``layers.layer_views``), else they are indexed."""
    group_size = group_layout(cfg)[1]
    P = len(cfg.layer_pattern)

    def pick(node, j):
        if isinstance(node, dict):
            return {k: pick(v, j) for k, v in node.items()}
        return node[g, j]

    for j in range(group_size):
        yield (cfg.layer_pattern[j % P], j % P, (g, j // P),
               at(g, j) if at else pick(params["blocks"], j))


def _head_cut(cfg: ModelConfig, tp) -> bool:
    """Whether the ranks of ``tp`` hold blocks of heads: both head counts
    divide by its size.  Otherwise the KV heads replicate (the JAX package's
    rules cut an Hkv only where it divides), and every rank runs every
    head's attention over them: a rank's own query heads alone would change
    the GQA group of each call, and the sum shapes and bits with it."""
    return head_cut(tp, cfg.num_heads, cfg.num_kv_heads)


def _norm_input(x, h, at, slot):
    """What a layer's pre-attention norm reads: the residual stream ``x``
    at the first layer of a group, else the previous layer's output sum
    ``h`` before its rounding.  The JAX package's compiled programs scan
    over groups, and inside one group's body XLA's excess-precision rule
    drops the round trip between that bf16 add and the next norm's float32
    convert (gemma2's local/global pairs); the group's output is the scan
    carry and is rounded."""
    return x if at[1] == 0 and slot == 0 else h


def _block_qkv(pj, x, positions, cfg: ModelConfig, tp=None):
    """Shared block head for prefill/decode: pre-norm, QKV projection, rope.
    ``x`` is the norm's input (:func:`_norm_input`), in the compute dtype
    or float32.  Under tensor parallelism the heads are the rank's block
    where both head counts divide (:func:`_head_cut`), else every head."""
    xn = L.rmsnorm(x, pj["ln_attn"], cfg.norm_eps).to(getattr(torch,
                                                              cfg.dtype))
    q, k, v = L.qkv_project(pj["attn"], xn, cfg.num_heads, cfg.num_kv_heads,
                            cfg.resolved_head_dim, tp=tp)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    return q, k, v


def _block_tail(pj, x, o, cfg: ModelConfig, tp=None):
    """Shared block tail for prefill/decode: attention-output projection,
    the FFN (dense, or MoE over every row of the call, its ``aux``
    discarded as in the reference), both residual adds.  o: (B, H, T, hd).

    The FFN's pre-norm reads the attention residual sum before it is
    rounded to the compute dtype, as the JAX package's compiled programs
    do: XLA's excess-precision rule drops the round trip between that
    bf16 add and the norm's float32 convert.  The residual stream itself
    is rounded.  Returns the new residual stream and its float32 sum
    before rounding (the next layer's norm input inside a group).  Under
    tensor parallelism a rank's block of heads is gathered before ``wo``
    (``pin_tp_exact``), whole on every rank, as is ``w2``."""
    B, T = x.shape[:2]
    width = cfg.num_heads * cfg.resolved_head_dim
    o = gather(o.transpose(1, 2).reshape(B, T, -1), tp, width)
    x, h, _ = _residual_ffn(pj, x, L.linear(o, pj["attn"]["wo"]), cfg, tp=tp)
    return x, h


def _residual_ffn(pj, x, a, cfg: ModelConfig, need_aux: bool = False,
                  tp=None, grid=None):
    """The attention residual add of ``a`` (the attention block's output,
    after ``wo``), the FFN's pre-norm on the unrounded float32 sum
    (:func:`_block_tail`), the FFN and its residual add: (x, its float32
    sum before rounding, the MoE ``aux`` or None).  ``grid`` (training):
    the dense FFN over its "model" group; a MoE FFN over the "data"
    group's rows (gathered, so every data rank routes the whole batch)
    with its experts cut over "model" (``moe.moe_apply(model=)``)."""
    s = x.to(torch.float32) + a.to(torch.float32)
    x = s.to(x.dtype)
    y = L.rmsnorm(s, pj["ln_mlp"], cfg.norm_eps).to(x.dtype)
    aux = None
    if cfg.moe and grid is not None:
        B = y.shape[0]
        ffn, aux = moe_mod.moe_apply(pj["moe"], gather_sum(y, grid.data, 0),
                                     cfg.moe, need_aux=need_aux,
                                     model=grid.model)
        ffn = ffn.narrow(0, grid.data.rank * B, B)
    elif cfg.moe:
        ffn, aux = moe_mod.moe_apply(pj["moe"], y, cfg.moe,
                                     need_aux=need_aux)
    elif grid is not None:
        ffn = L.tp_swiglu(y, pj["mlp"]["w1"], pj["mlp"]["w3"],
                          pj["mlp"]["w2"], grid.model, cfg.d_ff)
    else:
        ffn = L.swiglu(y, pj["mlp"]["w1"], pj["mlp"]["w3"], pj["mlp"]["w2"],
                       tp=tp)
    h = x.to(torch.float32) + ffn.to(torch.float32)
    return h.to(x.dtype), h, aux


def _group_end(cfg: ModelConfig, at, slot) -> bool:
    """True after the last layer of a group: where a VLM's cross block
    runs."""
    P = len(cfg.layer_pattern)
    return bool(cfg.cross_attn_every) and (
        at[1] * P + slot == group_layout(cfg)[1] - 1)


def _cross_kv(p, frontend: torch.Tensor, cfg: ModelConfig, tp=None,
              reciprocal_scale: bool = True):
    """Project stub modality embeddings (B, Tx, d) to one cross block's K and
    V, each (B, Hkv, Tx, hd) in the compute dtype (a device-phase op).
    Under tensor parallelism the rank's column blocks of ``wk`` / ``wv``
    give its own KV heads where the heads are cut (:func:`_head_cut`),
    else they are gathered into every head.
    ``reciprocal_scale``: as :func:`layers.linear`'s (False where the JAX
    package projects with eager ops: its cache's cross K/V)."""
    x = frontend.to(getattr(torch, cfg.dtype))
    cut = _head_cut(cfg, tp)
    return tuple(L.project_heads(x, p["attn"][w], cfg.num_kv_heads,
                                 cfg.resolved_head_dim, tp, cut,
                                 reciprocal_scale)
                 for w in ("wk", "wv"))


def _cross_apply(p, x, h, cross_kv, cfg: ModelConfig, tp=None, model=None,
                 source=None):
    """The gated cross-attention block after a group: x (B, T, d) is the
    residual stream and ``h`` its float32 sum before rounding (the group's
    last layer's, :func:`_block_tail`), which the block's norm reads as the
    JAX package's compiled programs do; attention over ``cross_kv`` through
    ``layers.attn_apply(kv=)`` (no rope, not causal: the flash kernel on the
    card, also at T = 1 in a decode step), then ``x + tanh(gate) * out``
    with XLA's tanh of the float32 gate cast to the compute dtype.
    Returns the new residual stream (the group's output, rounded).  Under
    tensor parallelism the rank attends its own heads over its cross K/V
    and the heads are gathered before the whole ``wo``, so the gated
    residual runs on whole tensors.

    On a training grid (``model``, its group; ``cross_kv`` None) the
    block is ``layers.tp_attn_apply`` with ``source``, the frontend in the
    compute dtype: each rank projects its own query heads and its KV heads
    of the frontend, and ``wo``'s row block sums the heads' output, so the
    gated residual again runs on whole tensors, with both of its
    roundings."""
    dtype = x.dtype
    xn = L.rmsnorm(h, p["ln"], cfg.norm_eps).to(dtype)
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
              head_dim=cfg.resolved_head_dim, positions=None,
              rope_theta=cfg.rope_theta)
    if model is not None:
        out = L.tp_attn_apply(p["attn"], xn, model, source=source, **kw)
    else:
        out = L.attn_apply(p["attn"], xn, kv=cross_kv, tp=tp, **kw)
    return x + ref.tanh(p["gate"]).to(dtype) * out


def _cross_params(params, g):
    """Group ``g``'s cross block params."""
    c = params["cross"]
    return {"ln": c["ln"][g], "gate": c["gate"][g],
            "attn": {k: w[g] for k, w in c["attn"].items()}}


def _cross_at(params, cache, g):
    """Group ``g``'s cross block params and its cached (K, V)."""
    if "cross_k" not in cache:
        raise ValueError(
            "a cross-attention config's cache holds the frontend's cross "
            "K/V: build it with init_cache(..., frontend=, params=)")
    return _cross_params(params, g), (cache["cross_k"][g],
                                      cache["cross_v"][g])


def _embed(params, tokens: torch.Tensor, cfg: ModelConfig,
           model=None) -> torch.Tensor:
    """Gather float32 embedding rows, then the compute dtype; ``model`` (a
    training grid's group): the table may be the rank's vocabulary block
    (``layers.vocab_embed``)."""
    if model is not None:
        x = L.vocab_embed(params["embed"], tokens, model, cfg.vocab_size)
        x = x.to(getattr(torch, cfg.dtype))
    else:
        x = params["embed"][tokens.to(torch.int64)].to(
            getattr(torch, cfg.dtype))
    if cfg.tie_embeddings:
        x = x * math.sqrt(cfg.d_model)
    return x


def _embed_decode(params, tokens: torch.Tensor, cfg: ModelConfig):
    """Shared decode preamble: embed one token per row -> (B, 1, d)."""
    return _embed(params, tokens, cfg)[:, None, :]


def _logits_head(params, x: torch.Tensor, cfg: ModelConfig,
                 rounded: bool = False, model=None) -> torch.Tensor:
    """Shared logits tail: final norm, (tied) LM head, final softcap; float32
    logits.

    The head takes the compute-dtype activations and weights into a float32
    product that is NOT rounded to the compute dtype first: the JAX
    package's compiled programs fold that rounding into the float32
    convert, and a bf16 rounding here would make argmax ties the reference
    does not see.  The head -- ``lm_head``, or the embedding's transpose
    when tied -- must already hold compute-dtype values in float32, as the
    serving engine's copy does (:func:`serve_params`), so no step copies
    it.  The tied product is taken as ``(embed @ x^T)^T``: it reads the
    (V, d) table where it lies and sums each logit in the order of the
    reference's dot (``x @ embed^T`` on a transposed view sums in another
    order on the CPU, a float32 ulp off on many of the logits).

    ``rounded`` (the whole-sequence ``forward``): the compiled forward
    rounds the head product to the compute dtype before the float32
    convert, and the head may be any params tree's (float32 draws,
    compute-dtype leaves or the engine's copy), so it is rounded to the
    compute dtype here first (idempotent on the engine's copy).

    Under tensor parallelism an untied head is the rank's vocabulary block
    and the logits are gathered; a tied head (the embedding) is whole.  On
    a training grid (``model``, its group) the head, tied or not, may be
    the rank's vocabulary block: its input then passes ``copy_to`` and the
    logits stay cut on the vocabulary."""
    dtype = getattr(torch, cfg.dtype)
    x = L.rmsnorm(x, params["ln_final"], cfg.norm_eps).to(torch.float32)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    if rounded:
        head = head.to(dtype).to(torch.float32)
    if model is not None and head.shape[
            0 if cfg.tie_embeddings else -1] != cfg.vocab_size:
        x = copy_to(x, model)
    if cfg.tie_embeddings:
        logits = (head @ x.reshape(-1, x.shape[-1]).T).T.reshape(
            x.shape[:-1] + (head.shape[0],))
    else:
        logits = gather(L.head_logits(x, head, dtype), params.get("tp"),
                        cfg.vocab_size)
    if rounded:
        logits = logits.to(dtype).to(torch.float32)
    if cfg.final_softcap:
        # the compiled programs multiply by the cap's reciprocal (XLA
        # rewrites the division by a constant), then take XLA's tanh
        logits = cfg.final_softcap * ref.tanh(
            logits * (1.0 / cfg.final_softcap))
    return logits


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda", frontend: Optional[torch.Tensor] = None,
               params=None) -> Dict[str, Any]:
    """Zeroed dense KV cache: per layer-pattern slot a K and a V leaf of
    shape ``(n_groups, group_size // P, batch, Hkv, S, hd)`` in the compute
    dtype (S = max_len, or the window for a windowed slot), and ``len``
    (batch,) int32.  A cross-attention config given ``frontend`` (batch, Tx,
    d) and ``params`` also holds ``cross_k`` / ``cross_v``
    (:func:`cross_cache`)."""
    _check_block_path(cfg, cross_ok=True)
    n_groups, group_size = group_layout(cfg)
    P = len(cfg.layer_pattern)
    hd = cfg.resolved_head_dim
    dtype = getattr(torch, cfg.dtype)
    sizes = [min(max_len, s.window) if s.window else max_len
             for s in cfg.layer_pattern]

    def leaf(S):
        return torch.zeros((n_groups, group_size // P, batch,
                            cfg.num_kv_heads, S, hd), dtype=dtype,
                           device=device)

    cache = {"k": [leaf(S) for S in sizes], "v": [leaf(S) for S in sizes],
             "len": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if cfg.cross_attn_every and frontend is not None and params is not None:
        cache.update(cross_cache(params, frontend, cfg))
    return cache


def cross_cache(params, frontend: torch.Tensor, cfg: ModelConfig
                ) -> Dict[str, torch.Tensor]:
    """A VLM's ``cross_k`` / ``cross_v`` (n_groups, batch, Hkv, Tx, hd):
    each group's cross projections of ``frontend`` (:func:`_cross_kv`),
    made once per request, group by group into the leaves, so each group's
    slice is contiguous for the flash kernel.  On a tensor-parallel rank
    (``params["tp"]``) the rank's blocks project its own KV heads."""
    tp = params.get("tp")
    out = {}
    for g in range(group_layout(cfg)[0]):
        for name, t in zip(("cross_k", "cross_v"), _cross_kv(
                _cross_params(params, g), frontend, cfg, tp,
                reciprocal_scale=False)):
            if name not in out:
                out[name] = torch.empty((group_layout(cfg)[0],) + t.shape,
                                        dtype=t.dtype, device=t.device)
            out[name][g] = t
    return out


def prefill(params, cache, tokens: torch.Tensor, cfg: ModelConfig,
            true_len: Optional[int] = None):
    """Fill a FRESH KV cache with a whole prompt in one pass over the layers.

    tokens (B, T) -> (logits at position ``true_len - 1`` (B, V) float32,
    the cache with ``len += true_len``; ``true_len`` defaults to T).  Each
    layer writes its K/V into positions ``0..T-1`` of its cache leaf IN
    PLACE (one slice assignment) and runs causal self-attention over the
    prompt through ``ops.attention`` -- the flash kernel on the card.  A
    VLM runs its cross block after each group (:func:`_cross_apply`,
    another flash launch over the cached cross K/V).  Under the
    sequence-cut dense decode (``sharding.seq_group``) the rank still
    attends its own heads, and its cache takes every head's K/V (gathered)
    of its own positions.
    Requires every cache leaf to hold T positions and an empty cache
    (``api.prefill`` checks both)."""
    _check_block_path(cfg, cross_ok=True)
    B, T = tokens.shape
    tp = params.get("tp")
    seq = seq_group(cfg, tp)
    x = _embed(params, tokens, cfg)
    positions = torch.arange(T, device=x.device)
    h = None
    for spec, slot, at, pj in _layers(params, cfg):
        q, k, v = _block_qkv(pj, _norm_input(x, h, at, slot), positions,
                             cfg, tp)
        if seq is None:
            cache["k"][slot][at][:, :, :T] = k
            cache["v"][slot][at][:, :, :T] = v
        else:
            # the rank attends its heads; its cache keeps every head of its
            # own positions
            kf, vf = gather_heads(tp, k, v, widths=(cfg.num_kv_heads,) * 2)
            L.seq_cache_fill(cache["k"][slot][at], kf, seq)
            L.seq_cache_fill(cache["v"][slot][at], vf, seq)
        o = ops.attention(q, k, v, causal=True, window=spec.window,
                          softcap=cfg.softcap)
        x, h = _block_tail(pj, x, o, cfg, tp)
        if _group_end(cfg, at, slot):
            cp, kv = _cross_at(params, cache, at[0])
            x = _cross_apply(cp, x, h, kv, cfg, tp)
    n = T if true_len is None else int(true_len)
    logits = _logits_head(params, x[:, n - 1], cfg)
    cache["len"] += n
    return logits, cache


def decode_step(params, cache, tokens: torch.Tensor, cfg: ModelConfig, *,
                write: Optional[torch.Tensor] = None):
    """One decode step on the dense cache, updated IN PLACE.

    tokens (B,) -> (logits (B, V) float32, cache).  Each row writes its
    token at ``min(len, S - 1)`` (``len % S`` in a windowed ring slot) and
    attends to its first ``len + 1`` positions.  ``cfg.parallel.
    aligned_decode`` picks the lockstep write (every row at ``len[0]``,
    ``generate()``) or the ragged one (slot positions); ``write`` (B,) bool
    freezes the rows where it is False: their K/V and ``len`` keep their
    values and their logits are garbage to be ignored.  A VLM runs its
    cross block after each group, the flash kernel at one query row.

    ``parallel.decode_attn="shard_map"`` (``sharding.lse_decode``): a layer
    without a window -- a linear cache, or a ring, which the JAX package
    attends with no window over its effective length -- takes the
    log-sum-exp body, as the reference's step does; a windowed layer whose
    window exceeds its cache stays plain.  Under tensor parallelism the caches are then cut on
    the sequence (``sharding.seq_group``): each rank gathers the step's
    query and new K/V over heads (they arrive cut on heads, exact), the
    rank that holds ``pos`` writes it, and the partials of every rank's
    positions combine by log-sum-exp into every head's output, whole on
    every rank; the plain windowed layer gathers its cache's positions."""
    _check_block_path(cfg, cross_ok=True)
    tp = params.get("tp")
    seq = seq_group(cfg, tp)
    lse = lse_decode(cfg)
    n = 1 if seq is None else seq.size
    x = _embed_decode(params, tokens, cfg)
    pos = cache["len"]
    positions = pos[:, None]
    aligned = cfg.parallel.aligned_decode
    h = None
    for spec, slot, at, pj in _layers(params, cfg):
        kc, vc = cache["k"][slot][at], cache["v"][slot][at]
        q, k, v = _block_qkv(pj, _norm_input(x, h, at, slot), positions,
                             cfg, tp)
        S = kc.shape[2] * n
        ring = bool(spec.window) and spec.window <= S
        idx = pos % S if ring else torch.clamp(pos, max=S - 1)
        if seq is None:
            L.cache_write(kc, k, idx, aligned, write)
            L.cache_write(vc, v, idx, aligned, write)
        else:
            q, k, v = gather_heads(tp, q, k, v, widths=(
                cfg.num_heads, cfg.num_kv_heads, cfg.num_kv_heads))
            L.seq_cache_write(kc, k, idx, seq, write)
            L.seq_cache_write(vc, v, idx, seq, write)
        if ring:
            o = ops.decode_attention(q, kc, vc, torch.clamp(pos + 1, max=S),
                                     softcap=cfg.softcap, lse=lse, seq=seq)
        elif seq is None or spec.window is None:
            o = ops.decode_attention(q, kc, vc, pos + 1, window=spec.window,
                                     softcap=cfg.softcap, lse=lse, seq=seq)
        else:
            o = ops.decode_attention(q, seq_to_heads(kc, seq, False),
                                     seq_to_heads(vc, seq, False), pos + 1,
                                     window=spec.window, softcap=cfg.softcap)
        x, h = _block_tail(pj, x, o, cfg, tp)
        if _group_end(cfg, at, slot):
            cp, kv = _cross_at(params, cache, at[0])
            x = _cross_apply(cp, x, h, kv, cfg, tp)
    logits = _logits_head(params, x[:, 0], cfg)
    cache["len"] += 1 if write is None else write.to(torch.int32)
    return logits, cache


def prefill_chunk(params, cache, tokens: torch.Tensor, true_len: int,
                  cfg: ModelConfig):
    """Advance a (possibly non-empty) dense KV cache by one right-padded
    prompt chunk, IN PLACE: the chunked-prefill block path.

    tokens (B, W): the next ``true_len`` prompt positions, padded to W.  Each
    layer writes the chunk's K/V at positions ``len .. len + W - 1`` of its
    cache leaf and attends with ``ops.chunk_attention`` -- causal over
    absolute positions, so a cached prefix (a prefix-seeded request cache
    starts at ``len = cached``) is seen and the padding rows' K/V, which
    the next chunk overwrites or which lie past ``len``, are never read by
    a real row.  No logits: the last prompt token goes through the decode
    step.  Returns the cache with ``len += true_len``.

    Precondition (the caller's): every cache leaf is a linear buffer of the
    full ``max_len`` (a windowed ring takes ``api.prefill_chunk``'s
    per-token path), ``len`` is a multiple of W and W divides ``max_len``:
    chunks arrive full width and back to back, only the last one padded.

    Under the sequence-cut dense decode (``sharding.seq_group``) the chunk's
    K/V (gathered over heads) go to the ranks that hold their positions,
    and each rank attends its own heads over the whole cache, gathered from
    every rank's positions for the chunk (``sharding.seq_to_heads``: the
    same values as the head-cut cache, O(cache) moved per layer)."""
    _check_block_path(cfg)
    B, W = tokens.shape
    tp = params.get("tp")
    seq = seq_group(cfg, tp)
    x = _embed(params, tokens, cfg)
    start = cache["len"]                                       # (B,)
    positions = start.to(torch.int64)[:, None] + torch.arange(
        W, device=x.device)[None, :]                           # (B, W)
    rows = torch.arange(B, device=x.device)[:, None]
    h = None
    for spec, slot, at, pj in _layers(params, cfg):
        kc, vc = cache["k"][slot][at], cache["v"][slot][at]   # (B, Hkv, S, hd)
        q, k, v = _block_qkv(pj, _norm_input(x, h, at, slot), positions,
                             cfg, tp)
        if seq is None:
            kc[rows, :, positions] = k.transpose(1, 2).to(kc.dtype)
            vc[rows, :, positions] = v.transpose(1, 2).to(vc.dtype)
        else:
            # the chunk's positions on the ranks that hold them, then the
            # rank's heads over the whole cache for the chunk's attention
            kf, vf = gather_heads(tp, k, v, widths=(cfg.num_kv_heads,) * 2)
            L.seq_cache_put(kc, kf, start, seq)
            L.seq_cache_put(vc, vf, start, seq)
            cut = _head_cut(cfg, tp)
            kc, vc = seq_to_heads(kc, seq, cut), seq_to_heads(vc, seq, cut)
        o = ops.chunk_attention(q, kc, vc, positions, window=spec.window,
                                softcap=cfg.softcap)
        x, h = _block_tail(pj, x, o, cfg, tp)
    cache["len"] += int(true_len)
    return cache


def paged_decode_step(params, cache, table: torch.Tensor,
                      tokens: torch.Tensor, cfg: ModelConfig, *,
                      write: Optional[torch.Tensor] = None, seq_axes=None):
    """One decode step straight through the page pool, updated IN PLACE.

    cache: the paged slot cache.  A pattern slot whose ``seq_axes["k"]``
    entry is >= 0 holds pool leaves ``(n_groups, group_size // P,
    num_pages, page_size, Hkv, hd)`` (``QuantizedLeaf`` s of such codes and
    their scales in an int8 / fp8 pool): each layer appends its token to
    its page (``layers.paged_append``: one indexed write of B token rows,
    or the quantize-on-write page append) and attends through the table
    with ``ops.paged_decode_attention`` -- the paged kernel on the card,
    which dequantizes a quantized pool at the page fetch.  A
    slot whose entry is < 0 is a windowed ring buffer that stays dense and
    slot-private, ``(n_groups, group_size // P, n_slots, Hkv, S, hd)``:
    the token goes to ``pos % S`` and attention is ``ops.decode_attention``
    over the first ``min(pos + 1, S)`` entries, as in ``decode_step``
    (gemma2's local layers).  ``seq_axes`` None pages every K/V leaf.
    table: (B, P) int32 physical page ids; tokens (B,); write: (B,) bool,
    where a False row appends to the scratch page, keeps its ring entries
    and its ``len``, and gives logits to be ignored.  Under tensor
    parallelism the paged attention takes the JAX package's TP dispatch
    (``ops.paged_decode_attention(tp=)``): the kernel on the rank's block
    of heads of a head-cut pool, else over every head of the whole pool."""
    _check_block_path(cfg)
    tp = params.get("tp")
    cut = _head_cut(cfg, tp)
    B = tokens.shape[0]
    if write is None:
        write = torch.ones((B,), dtype=torch.bool, device=tokens.device)
    paged = ([True] * len(cfg.layer_pattern) if seq_axes is None
             else [ax >= 0 for ax in seq_axes["k"]])
    x = _embed_decode(params, tokens, cfg)
    pos = cache["len"]
    positions = pos[:, None]
    page, off = L.page_offsets(table, pos, write,
                               cache["k"][paged.index(True)].shape[3])
    cache_len = (pos + 1).to(torch.int32)
    h = None
    for spec, slot, at, pj in _layers(params, cfg):
        kc, vc = cache["k"][slot][at], cache["v"][slot][at]
        q, k, v = _block_qkv(pj, _norm_input(x, h, at, slot), positions,
                             cfg, tp)
        if paged[slot]:
            L.paged_append(kc, k[:, :, 0, :], page, off)
            L.paged_append(vc, v[:, :, 0, :], page, off)
            o = ops.paged_decode_attention(q, kc, vc, table, cache_len,
                                           window=spec.window,
                                           softcap=cfg.softcap, tp=tp,
                                           head_cut=cut)
        else:
            S = kc.shape[2]
            L.cache_write(kc, k, pos % S, aligned=False, write=write)
            L.cache_write(vc, v, pos % S, aligned=False, write=write)
            o = ops.decode_attention(q, kc, vc, torch.clamp(pos + 1, max=S),
                                     softcap=cfg.softcap)
        x, h = _block_tail(pj, x, o, cfg, tp)
    logits = _logits_head(params, x[:, 0], cfg)
    cache["len"] += write.to(torch.int32)
    return logits, cache


# ----------------------------------------------------------------------------
# Forward: the whole sequence
# ----------------------------------------------------------------------------
def forward(params, tokens: torch.Tensor, cfg: ModelConfig,
            frontend: Optional[torch.Tensor] = None, layout=None):
    """Whole-sequence logits: tokens (B, T) -> (logits (B, T, V) float32,
    aux).  Every layer is ``layers.attn_apply`` (causal, the config's window
    and softcap: one flash launch per layer on the card) and the FFN, with
    the JAX package's compiled numerics (:func:`_norm_input`,
    :func:`_residual_ffn`); a MoE config's ``aux`` is summed over the
    layers (0.0 otherwise); a VLM runs its cross block after each group
    over its frontend's cross K/V, projected here (:func:`_cross_kv`);
    the head product is rounded, as the compiled forward rounds it.  Each
    layer group runs under the config's ``parallel.remat``
    (``layers.remat``, the reference's ``_maybe_remat``), which changes no
    value or gradient.

    ``layout`` (a training grid's ``sharding.Layout``): ``params`` are this
    rank's blocks and ``tokens`` its rows; each layer's FSDP blocks are
    gathered inside the remat'd group (the reference's
    ``gather_fsdp_weights``), the embedding and head before the first;
    the projections and an untied head travel in the compute dtype (each
    is cast to it at its use: the same values, half the bytes at bf16),
    the embedding in float32; the logits (B, T, V / tp) are this rank's
    vocabulary block where the head is cut (module docstring)."""
    _check_block_path(cfg, cross_ok=True)
    if cfg.cross_attn_every and frontend is None:
        raise ValueError(f"{cfg.name}: forward needs the frontend")
    T = tokens.shape[1]
    dtype = getattr(torch, cfg.dtype)
    positions = torch.arange(T, device=tokens.device)
    grid = None if layout is None else layout.grid
    model = None if grid is None or grid.model.size == 1 else grid.model

    def attention(pa, xn, spec):
        kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                  head_dim=cfg.resolved_head_dim, positions=positions,
                  rope_theta=cfg.rope_theta, window=spec.window,
                  softcap=cfg.softcap)
        if model is not None:
            return L.tp_attn_apply(pa, xn, model, **kw)
        return L.attn_apply(pa, xn, **kw)

    def group(x, layers, cp):
        aux, h = 0.0, None
        for spec, slot, at, pj in layers:
            if layout is not None:
                pj = layout.gather_fsdp(pj, layout.cuts["blocks"], lead=2,
                                        dtype=dtype)
            xn = L.rmsnorm(_norm_input(x, h, at, slot), pj["ln_attn"],
                           cfg.norm_eps).to(dtype)
            a = attention(pj["attn"], xn, spec)
            x, h, layer_aux = _residual_ffn(pj, x, a, cfg, need_aux=True,
                                            grid=grid)
            if cfg.moe:
                aux = aux + layer_aux
        if cp is not None:
            if layout is not None:
                cp = layout.gather_fsdp(cp, layout.cuts["cross"], lead=1,
                                        dtype=dtype)
            if model is not None:
                x = _cross_apply(cp, x, h, None, cfg, model=model,
                                 source=frontend.to(dtype))
            else:
                x = _cross_apply(cp, x, h, _cross_kv(cp, frontend, cfg), cfg)
        return x, aux

    group = L.remat(group, cfg.parallel.remat)
    at = L.layer_views(params["blocks"], lead=2)
    top = params
    if layout is not None:
        # the embedding's lookup accumulates its gradient rows in the
        # table's dtype: it stays float32
        top = dict(layout.gather_fsdp(
            {"embed": params["embed"]}, {"embed": layout.cuts["embed"]}),
            ln_final=params["ln_final"])
        if "lm_head" in params:
            top.update(layout.gather_fsdp(
                {"lm_head": params["lm_head"]},
                {"lm_head": layout.cuts["lm_head"]}, dtype=dtype))
    x = _embed(top, tokens, cfg, model)
    aux = 0.0
    for g in range(group_layout(cfg)[0]):
        x, group_aux = group(
            x, list(_group_layers(params, cfg, g, at)),
            _cross_params(params, g) if cfg.cross_attn_every else None)
        aux = aux + group_aux
    return _logits_head(top, x, cfg, rounded=True, model=model), aux
