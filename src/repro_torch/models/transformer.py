"""Decoder-only Llama-family LM params (the lm family's dense FFN members).

Params are plain dicts of tensors with the JAX package's layout: every
per-layer array has leading dims ``(n_groups, group_size, ...)`` from
:func:`group_layout`, so a params tree converted from the JAX package
(``models/api.py::params_from_numpy``) and one made here have the same
structure.  The float serve path is here: ``init_cache``, the block
``prefill`` (flash attention over the prompt), the dense ``decode_step``
and the ``paged_decode_step`` through the page pool, all updating the
cache IN PLACE where the JAX package returned a new one.  The split-brain
slice's token loop lives in ``serve/splitbrain_engine.py``; the
full-sequence ``forward``, MoE, cross attention and the other families come
with their slices.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L


def group_layout(cfg: ModelConfig) -> Tuple[int, int]:
    P = len(cfg.layer_pattern)
    group_size = cfg.cross_attn_every if cfg.cross_attn_every else P
    assert cfg.num_layers % group_size == 0, (cfg.num_layers, group_size)
    assert group_size % P == 0, (group_size, P)
    return cfg.num_layers // group_size, group_size


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Dict[str, Any]:
    """Random float32 params drawn from ``generator`` on ``device``:
    normal(0, 0.02) embeddings, zero norm scales and uniform
    ``dense_init`` projections, as in the JAX package (whose random bits
    differ; tests convert the JAX package's params instead)."""
    if cfg.family != "lm" or cfg.moe or cfg.cross_attn_every:
        raise NotImplementedError(
            f"{cfg.name}: only the dense lm family is ported so far")
    n_groups, group_size = group_layout(cfg)
    lead = (n_groups, group_size)
    hd = cfg.resolved_head_dim
    d, f = cfg.d_model, cfg.d_ff
    kw = dict(lead=lead, device=device)
    f32 = torch.float32
    embed = torch.empty((cfg.vocab_size, d), dtype=f32, device=device)
    embed.normal_(0.0, 1.0, generator=generator).mul_(0.02)
    params: Dict[str, Any] = {
        "embed": embed,
        "blocks": {
            "ln_attn": torch.zeros(lead + (d,), dtype=f32, device=device),
            "ln_mlp": torch.zeros(lead + (d,), dtype=f32, device=device),
            "attn": L.attn_init(d, cfg.num_heads, cfg.num_kv_heads, hd,
                                generator, **kw),
            "mlp": {
                "w1": L.dense_init(d, f, generator, **kw),
                "w3": L.dense_init(d, f, generator, **kw),
                "w2": L.dense_init(f, d, generator, **kw),
            },
        },
        "ln_final": torch.zeros((d,), dtype=f32, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(d, cfg.vocab_size, generator,
                                         device=device)
    return params


# ----------------------------------------------------------------------------
# KV cache, prefill and decode (lm block path)
# ----------------------------------------------------------------------------
# Batch and sequence axis of each serve-cache entry (the K/V lists share
# theirs): leaves (n_groups, gs // P, B, Hkv, S, hd), len (B,)
CACHE_AXES = ({"k": 2, "v": 2, "len": 0}, {"k": 4, "v": 4, "len": -1})


def serve_params(params, cfg: ModelConfig, device) -> Dict[str, Any]:
    """The serving engine's copy of the float params on ``device``:
    attention and MLP projections cast once to the compute dtype, embedding
    and norm scales kept float32 (a tensor already in place is not copied).
    An untied LM head is rounded once to the compute dtype and held in
    float32, the operand of :func:`_logits_head`'s float32 product."""
    dtype = getattr(torch, cfg.dtype)
    blocks = params["blocks"]

    def cast(tree):
        return {k: w.to(device=device, dtype=dtype) for k, w in tree.items()}

    out = {"embed": params["embed"].to(device),
           "ln_final": params["ln_final"].to(device),
           "blocks": {"ln_attn": blocks["ln_attn"].to(device),
                      "ln_mlp": blocks["ln_mlp"].to(device),
                      "attn": cast(blocks["attn"]),
                      "mlp": cast(blocks["mlp"])}}
    if "lm_head" in params:
        out["lm_head"] = params["lm_head"].to(device=device, dtype=dtype).to(
            torch.float32)
    return out


def prefill_fits(cache, prompt_len: int) -> bool:
    """True when every KV leaf can hold the whole prompt, so that the block
    :func:`prefill` can take it in one pass."""
    return all(a.shape[4] >= prompt_len for a in cache["k"])


def _check_block_path(cfg: ModelConfig) -> None:
    if cfg.family != "lm" or cfg.moe or cfg.cross_attn_every:
        raise NotImplementedError(
            f"{cfg.name}: the lm block path covers dense decoder-only "
            f"configs (MoE and cross-attention are not ported yet)")


def _layers(params, cfg: ModelConfig):
    """Per-layer views in the JAX package's scan order: yields
    ``(spec, slot, (g, j // P), params of layer (g, j))`` where ``slot`` is
    the layer-pattern slot whose cache leaf holds the layer at index
    ``(g, j // P)``."""
    n_groups, group_size = group_layout(cfg)
    P = len(cfg.layer_pattern)

    def pick(node, g, j):
        if isinstance(node, dict):
            return {k: pick(v, g, j) for k, v in node.items()}
        return node[g, j]

    for g in range(n_groups):
        for j in range(group_size):
            yield (cfg.layer_pattern[j % P], j % P, (g, j // P),
                   pick(params["blocks"], g, j))


def _block_qkv(pj, x, positions, cfg: ModelConfig):
    """Shared block head for prefill/decode: pre-norm, QKV projection, rope."""
    xn = L.rmsnorm(x, pj["ln_attn"], cfg.norm_eps)
    q, k, v = L.qkv_project(pj["attn"], xn, cfg.num_heads, cfg.num_kv_heads,
                            cfg.resolved_head_dim)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    return q, k, v


def _block_tail(pj, x, o, cfg: ModelConfig):
    """Shared block tail for prefill/decode: attention-output projection,
    the dense FFN, both residual adds.  o: (B, H, T, hd).

    The FFN's pre-norm reads the attention residual sum before it is
    rounded to the compute dtype, as the JAX package's compiled programs
    do: XLA's excess-precision rule drops the round trip between that
    bf16 add and the norm's float32 convert.  The residual stream itself
    is rounded."""
    B, T = x.shape[:2]
    o = o.transpose(1, 2).reshape(B, T, cfg.num_heads * cfg.resolved_head_dim)
    s = x.to(torch.float32) + L.linear(o, pj["attn"]["wo"]).to(torch.float32)
    x = s.to(x.dtype)
    y = L.rmsnorm(s, pj["ln_mlp"], cfg.norm_eps).to(x.dtype)
    return x + L.swiglu(y, pj["mlp"]["w1"], pj["mlp"]["w3"], pj["mlp"]["w2"])


def _embed(params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Gather float32 embedding rows, then the compute dtype."""
    x = params["embed"][tokens.to(torch.int64)].to(getattr(torch, cfg.dtype))
    if cfg.tie_embeddings:
        x = x * math.sqrt(cfg.d_model)
    return x


def _embed_decode(params, tokens: torch.Tensor, cfg: ModelConfig):
    """Shared decode preamble: embed one token per row -> (B, 1, d)."""
    return _embed(params, tokens, cfg)[:, None, :]


def _logits_head(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Shared logits tail: final norm, (tied) LM head, final softcap; float32
    logits.

    The head takes the compute-dtype activations and weights into a float32
    product that is NOT rounded to the compute dtype first: the JAX
    package's compiled programs fold that rounding into the float32
    convert, and a bf16 rounding here would make argmax ties the reference
    does not see.  An untied ``lm_head`` must already hold compute-dtype
    values, as the serving engine's copy does (rounded once, kept float32,
    so no step copies it); a tied embedding is rounded here."""
    x = L.rmsnorm(x, params["ln_final"], cfg.norm_eps)
    head = (params["embed"].T.to(x.dtype) if cfg.tie_embeddings
            else params["lm_head"])
    logits = x.to(torch.float32) @ head.to(torch.float32)
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> Dict[str, Any]:
    """Zeroed dense KV cache: per layer-pattern slot a K and a V leaf of
    shape ``(n_groups, group_size // P, batch, Hkv, S, hd)`` in the compute
    dtype (S = max_len, or the window for a windowed slot), and ``len``
    (batch,) int32."""
    _check_block_path(cfg)
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

    return {"k": [leaf(S) for S in sizes], "v": [leaf(S) for S in sizes],
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def prefill(params, cache, tokens: torch.Tensor, cfg: ModelConfig,
            true_len: Optional[int] = None):
    """Fill a FRESH KV cache with a whole prompt in one pass over the layers.

    tokens (B, T) -> (logits at position ``true_len - 1`` (B, V) float32,
    the cache with ``len += true_len``; ``true_len`` defaults to T).  Each
    layer writes its K/V into positions ``0..T-1`` of its cache leaf IN
    PLACE (one slice assignment) and runs causal self-attention over the
    prompt through ``ops.attention`` -- the flash kernel on the card.
    Requires every cache leaf to hold T positions and an empty cache
    (``api.prefill`` checks both)."""
    _check_block_path(cfg)
    B, T = tokens.shape
    x = _embed(params, tokens, cfg)
    positions = torch.arange(T, device=x.device)
    for spec, slot, at, pj in _layers(params, cfg):
        q, k, v = _block_qkv(pj, x, positions, cfg)
        cache["k"][slot][at][:, :, :T] = k
        cache["v"][slot][at][:, :, :T] = v
        o = ops.attention(q, k, v, causal=True, window=spec.window,
                          softcap=cfg.softcap)
        x = _block_tail(pj, x, o, cfg)
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
    values and their logits are garbage to be ignored."""
    _check_block_path(cfg)
    x = _embed_decode(params, tokens, cfg)
    pos = cache["len"]
    positions = pos[:, None]
    aligned = cfg.parallel.aligned_decode
    for spec, slot, at, pj in _layers(params, cfg):
        kc, vc = cache["k"][slot][at], cache["v"][slot][at]
        q, k, v = _block_qkv(pj, x, positions, cfg)
        S = kc.shape[2]
        ring = bool(spec.window) and spec.window <= S
        idx = pos % S if ring else torch.clamp(pos, max=S - 1)
        L.cache_write(kc, k, idx, aligned, write)
        L.cache_write(vc, v, idx, aligned, write)
        if ring:
            o = ops.decode_attention(q, kc, vc, torch.clamp(pos + 1, max=S),
                                     softcap=cfg.softcap)
        else:
            o = ops.decode_attention(q, kc, vc, pos + 1, window=spec.window,
                                     softcap=cfg.softcap)
        x = _block_tail(pj, x, o, cfg)
    logits = _logits_head(params, x[:, 0], cfg)
    cache["len"] += 1 if write is None else write.to(torch.int32)
    return logits, cache


def paged_decode_step(params, cache, table: torch.Tensor,
                      tokens: torch.Tensor, cfg: ModelConfig, *,
                      write: Optional[torch.Tensor] = None, seq_axes=None):
    """One decode step straight through the page pool, updated IN PLACE.

    cache: the paged slot cache, whose K/V leaves are pools
    ``(n_groups, group_size // P, num_pages, page_size, Hkv, hd)``; table:
    (B, P) int32 physical page ids; tokens (B,); write: (B,) bool, where a
    False row appends to the scratch page and keeps its ``len``.  Each layer
    appends its token to its page (one indexed write of B token rows) and
    attends through the table with ``ops.paged_decode_attention`` -- the
    paged kernel on the card.  ``seq_axes`` marks the leaves that page
    (>= 0); a windowed ring slot (< 0) is gemma2's and not ported yet."""
    _check_block_path(cfg)
    B = tokens.shape[0]
    if write is None:
        write = torch.ones((B,), dtype=torch.bool, device=tokens.device)
    if seq_axes is not None and min(seq_axes["k"]) < 0:
        raise NotImplementedError(
            "ring-buffer (windowed) slots in the paged decode step are not "
            "ported yet")
    x = _embed_decode(params, tokens, cfg)
    pos = cache["len"]
    positions = pos[:, None]
    page, off = L.page_offsets(table, pos, write, cache["k"][0].shape[3])
    cache_len = (pos + 1).to(torch.int32)
    for spec, slot, at, pj in _layers(params, cfg):
        kc, vc = cache["k"][slot][at], cache["v"][slot][at]
        q, k, v = _block_qkv(pj, x, positions, cfg)
        kc[page, off] = k[:, :, 0, :].to(kc.dtype)
        vc[page, off] = v[:, :, 0, :].to(vc.dtype)
        o = ops.paged_decode_attention(q, kc, vc, table, cache_len,
                                       window=spec.window,
                                       softcap=cfg.softcap)
        x = _block_tail(pj, x, o, cfg)
    logits = _logits_head(params, x[:, 0], cfg)
    cache["len"] += write.to(torch.int32)
    return logits, cache
