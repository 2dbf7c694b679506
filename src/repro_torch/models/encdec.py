"""Encoder-decoder backbone (seamless-m4t-medium) in torch: a bidirectional
encoder over stub modality embeddings (precomputed audio-frame vectors, the
``frontend``) and a causal decoder with cross-attention.

Params keep the JAX package's layout: ``enc_blocks`` and ``dec_blocks`` are
stacked by layer, ``(L, ...)``.  The encoder and the whole-sequence
``forward`` attend through ``ops.attention`` (the flash kernel on the card:
non-causal over the frontend in the encoder, causal self-attention and
non-causal cross-attention in the decoder).  Serving is the JAX package's:
``init_cache`` runs the encoder once per request batch and projects every
decoder layer's cross K/V; ``decode_step`` attends to its dense self cache
and to the cross K/V with ``ops.decode_attention``, plain on every device
as in the reference, so a decode step launches no kernel.  Caches are
updated IN PLACE.  Numerics follow the compiled reference: each layer is a
scan body, inside which the residual sums reach the next norm in float32
(:func:`_residual`); the decode head product stays float32, ``forward``'s
is rounded.

Tensor-parallel serving (a ``TPGroup`` in the serving params as ``"tp"``,
set by the engine): the params are the rank's shard under the serve rules
(column blocks of every ``wq`` / ``wk`` / ``wv`` / ``w1`` / ``w3`` and of
the head where the vocabulary divides; ``wo``, ``w2``, the embedding and
the norms whole).  Each rank runs the whole encoder with its own heads'
attention, the heads and the FFN's hidden units gathered before each
whole product (``sharding.gather``, the JAX package's ``pin_tp_exact``), so
the encoder output is whole on every rank; the cross K/V and the self
cache hold the rank's KV heads, and the logits are gathered over the
vocabulary.  No float sum crosses ranks, so the tokens are one device's.

Training on a grid (``forward(model=)``) takes Megatron's cuts instead:
head-cut attention everywhere (``layers.tp_attn_apply``), row-cut ``wo``
and ``w2`` summed over the group, the encoder output whole on every rank
and cut into each decoder layer's KV heads, the embedding and head
vocabulary-parallel.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import copy_to
from repro_torch.distributed.sharding import (gather, gather_heads, head_cut,
                                              lse_decode, seq_group, shard)
from repro_torch.kernels import ops
from repro_torch.models import layers as L

# Batch axis of each serve-cache entry: K/V (L, B, Hkv, S, hd), len (B,),
# cross K/V (L, B, Hkv, Tx, hd).
BATCH_AXES = {"k": 1, "v": 1, "len": 0, "cross_k": 1, "cross_v": 1}
# the leaves that the sequence-cut dense decode cuts on their sequence
# (``sharding.seq_group``): the self cache on positions, the cross K/V on
# frames
SEQ_CUT = ("k", "v", "cross_k", "cross_v")


def _dtype(cfg: ModelConfig):
    return getattr(torch, cfg.dtype)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda", dtype=torch.float32) -> Dict[str, Any]:
    """Random params drawn from ``generator`` on ``device`` in the JAX
    package's layout (its random bits differ; tests convert its params
    instead): normal(0, 0.02) float32 embeddings, zero float32 norm scales,
    uniform ``dense_init`` projections stored in ``dtype``, each drawn one
    (layer, matrix) slice at a time."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
    qd, kvd = cfg.num_heads * hd, cfg.num_kv_heads * hd

    def dense(n, in_dim, out_dim):
        w = torch.empty((n, in_dim, out_dim), dtype=dtype, device=device)
        for i in range(n):
            w[i] = L.dense_init(in_dim, out_dim, generator, device=device)
        return w

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    def attn(n):
        return {"wq": dense(n, d, qd), "wk": dense(n, d, kvd),
                "wv": dense(n, d, kvd), "wo": dense(n, qd, d)}

    def mlp(n):
        return {"w1": dense(n, d, f), "w3": dense(n, d, f),
                "w2": dense(n, f, d)}

    Le, Ld = cfg.num_encoder_layers, cfg.num_layers
    embed = torch.empty((cfg.vocab_size, d), dtype=torch.float32,
                        device=device)
    embed.normal_(0.0, 1.0, generator=generator).mul_(0.02)
    return {
        "embed": embed,
        "enc_blocks": {"ln_attn": zeros(Le, d), "ln_mlp": zeros(Le, d),
                       "attn": attn(Le), "mlp": mlp(Le)},
        "dec_blocks": {"ln_self": zeros(Ld, d), "ln_cross": zeros(Ld, d),
                       "ln_mlp": zeros(Ld, d), "self": attn(Ld),
                       "cross": attn(Ld), "mlp": mlp(Ld)},
        "ln_enc": zeros(d),
        "ln_final": zeros(d),
        "lm_head": L.dense_init(d, cfg.vocab_size, generator,
                                device=device).to(dtype),
    }


def serve_params(params, cfg: ModelConfig, device) -> Dict[str, Any]:
    """The serving engine's copy on ``device``: projections cast once to the
    compute dtype, embedding and norm scales float32, and the LM head
    rounded to the compute dtype and held in float32 (the operand of the
    decode step's float32 head product; rounding is idempotent)."""
    dtype = _dtype(cfg)

    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if key.startswith("ln_"):
            return node.to(device)
        return node.to(device=device, dtype=dtype)

    return {"embed": params["embed"].to(device),
            "enc_blocks": walk(params["enc_blocks"]),
            "dec_blocks": walk(params["dec_blocks"]),
            "ln_enc": params["ln_enc"].to(device),
            "ln_final": params["ln_final"].to(device),
            "lm_head": params["lm_head"].to(device=device, dtype=dtype).to(
                torch.float32)}


def _layer(blocks, i):
    """Layer ``i``'s params of a stacked block tree."""
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in blocks.items()}


def _residual(x, a):
    """``x + a`` as the compiled layer body computes it: (the residual
    stream rounded to x's dtype, its float32 sum), the sum being what the
    next norm inside the body reads (XLA's excess precision drops that
    round trip)."""
    s = x.to(torch.float32) + a.to(torch.float32)
    return s.to(x.dtype), s


def _norm(x, gamma, cfg: ModelConfig):
    return L.rmsnorm(x, gamma, cfg.norm_eps).to(_dtype(cfg))


def _attn(p, xn, cfg: ModelConfig, positions, model=None, source=None,
          **kw):
    """One attention block: ``layers.attn_apply`` (``kw``: ``causal``,
    ``kv``, a serving ``tp``), or on a training grid's group (``model``)
    ``layers.tp_attn_apply``, cross-attention there taking its K/V from
    ``source``."""
    dims = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.resolved_head_dim, positions=positions,
                rope_theta=cfg.rope_theta)
    if model is not None:
        return L.tp_attn_apply(p, xn, model, source=source, **dims, **kw)
    return L.attn_apply(p, xn, **dims, **kw)


def _mlp_tail(p, x, s, cfg: ModelConfig, tp=None, model=None):
    """The FFN's pre-norm of the float32 sum ``s``, SwiGLU, residual add:
    the layer's output (rounded: the scan carry).  ``model``: the FFN's
    Megatron cut on a training grid (``layers.tp_swiglu``)."""
    y = _norm(s, p["ln_mlp"], cfg)
    mlp = p["mlp"]
    if model is not None:
        out = L.tp_swiglu(y, mlp["w1"], mlp["w3"], mlp["w2"], model,
                          cfg.d_ff)
    else:
        out = L.swiglu(y, mlp["w1"], mlp["w3"], mlp["w2"], tp=tp)
    return _residual(x, out)[0]


def encode(params, frontend: torch.Tensor, cfg: ModelConfig,
           model=None) -> torch.Tensor:
    """frontend (B, Tx, d) stub audio embeddings -> (B, Tx, d): each layer
    non-causal self-attention with rope (one flash launch on the card, on
    a tensor-parallel rank's own heads) and the FFN, then ``ln_enc``.
    ``model`` (a training grid's group): Megatron's cuts, the output whole
    on every rank."""
    tp = params.get("tp")
    x = frontend.to(_dtype(cfg))
    positions = torch.arange(x.shape[1], device=x.device)

    def layer(x, p):
        h = _attn(p["attn"], _norm(x, p["ln_attn"], cfg), cfg, positions,
                  model=model, causal=False,
                  **({} if model is not None else {"tp": tp}))
        x, s = _residual(x, h)
        return _mlp_tail(p, x, s, cfg, tp, model)

    layer = L.remat(layer, cfg.parallel.remat, policy=False)
    at = L.layer_views(params["enc_blocks"])
    for i in range(cfg.num_encoder_layers):
        x = layer(x, at(i))
    return _norm(x, params["ln_enc"], cfg)


def _cut(cfg: ModelConfig, tp) -> bool:
    """Whether the ranks of ``tp`` hold blocks of heads (both counts
    divide; else every rank runs every head)."""
    return head_cut(tp, cfg.num_heads, cfg.num_kv_heads)


def _cross_kv(p, enc: torch.Tensor, cfg: ModelConfig, tp=None,
              reciprocal_scale: bool = True):
    """One decoder layer's cross K and V of the encoder output, each (B,
    Hkv, Tx, hd): on a tensor-parallel rank its own KV heads, projected by
    its column blocks.
    ``reciprocal_scale``: as :func:`layers.linear`'s (False where the JAX
    package projects with eager ops: its cache's cross K/V)."""
    return tuple(L.project_heads(enc, p["cross"][w], cfg.num_kv_heads,
                                 cfg.resolved_head_dim, tp, _cut(cfg, tp),
                                 reciprocal_scale)
                 for w in ("wk", "wv"))


def _logits(params, x, cfg: ModelConfig, rounded: bool, model=None):
    """Final norm and the LM head as a float32 product of compute-dtype
    values.  The decode step's head must already hold compute-dtype values
    in float32 (:func:`serve_params`), so no step copies it; ``rounded``
    (``forward``, on any params tree) rounds the head here first and the
    product to the compute dtype after, as the compiled forward does.
    ``model`` (a training grid's group): a head cut on the vocabulary
    takes its input through ``copy_to`` and the logits stay the rank's
    block."""
    head = params["lm_head"]
    if rounded:
        head = head.to(_dtype(cfg)).to(torch.float32)
    xn = _norm(x, params["ln_final"], cfg).to(torch.float32)
    if model is not None and head.shape[-1] != cfg.vocab_size:
        logits = copy_to(xn, model) @ head
    else:
        logits = gather(L.head_logits(xn, head, _dtype(cfg)),
                        params.get("tp"), cfg.vocab_size)
    return logits.to(_dtype(cfg)).to(torch.float32) if rounded else logits


def forward(params, tokens: torch.Tensor, cfg: ModelConfig,
            frontend: Optional[torch.Tensor] = None, model=None):
    """Teacher-forced decode over the whole target sequence: tokens (B, T)
    and frontend (B, Tx, d) -> (logits (B, T, V) float32, 0.0).  The
    encoder, then per decoder layer causal self-attention with rope and
    non-causal cross-attention over that layer's projection of the encoder
    output (three flash launches per layer pair on the card).  Each
    encoder and decoder layer runs under the config's ``parallel.remat``
    (``layers.remat``; "dots" is "full" here, as in the reference), which
    changes no value or gradient; the reference's FSDP gathers are left
    out (a distributed matter).

    ``model`` (a training grid's "model" group of more than one rank;
    ``params`` the rank's blocks, whole on "data"): every attention is
    head-cut (``layers.tp_attn_apply``: the encoder's non-causal, the
    decoder's causal self-attention, and its cross-attention with the
    rank's KV heads of the encoder output, which passes ``copy_to`` at each
    use, so its gradient is every layer's and every rank's sum), every FFN
    Megatron's, the embedding and head vocabulary-parallel where the rules
    cut them; the residual sums keep their roundings, and the logits are
    the rank's vocabulary block."""
    if frontend is None:
        raise ValueError(f"{cfg.name}: forward needs the frontend")
    if model is not None and model.size == 1:
        model = None
    enc = encode(params, frontend, cfg, model)
    if model is not None:
        x = L.vocab_embed(params["embed"], tokens, model,
                          cfg.vocab_size).to(_dtype(cfg))
    else:
        x = params["embed"][tokens.to(torch.int64)].to(_dtype(cfg))
    positions = torch.arange(tokens.shape[1], device=x.device)

    def layer(x, p, enc):
        h = _attn(p["self"], _norm(x, p["ln_self"], cfg), cfg, positions,
                  model=model)
        x, s = _residual(x, h)
        cross = ({"source": enc} if model is not None
                 else {"kv": _cross_kv(p, enc, cfg)})
        h = _attn(p["cross"], _norm(s, p["ln_cross"], cfg), cfg, positions,
                  model=model, **cross)
        x, s = _residual(x, h)
        return _mlp_tail(p, x, s, cfg, model=model)

    layer = L.remat(layer, cfg.parallel.remat, policy=False)
    at = L.layer_views(params["dec_blocks"])
    for i in range(cfg.num_layers):
        x = layer(x, at(i), enc)
    return _logits(params, x, cfg, rounded=True, model=model), 0.0


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda",
               frontend: Optional[torch.Tensor] = None,
               params=None) -> Dict[str, Any]:
    """Zeroed dense self-attention cache ``k`` / ``v`` (L, batch, Hkv,
    max_len, hd) in the compute dtype and ``len`` (batch,) int32; given
    ``frontend`` and ``params``, the encoder runs once (:func:`encode`) and
    each decoder layer's cross K/V go into ``cross_k`` / ``cross_v`` (L,
    batch, Hkv, Tx, hd)."""
    hd, Ld = cfg.resolved_head_dim, cfg.num_layers
    dtype = _dtype(cfg)
    shape = (Ld, batch, cfg.num_kv_heads, max_len, hd)
    cache: Dict[str, Any] = {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if frontend is not None and params is not None:
        cache.update(cross_cache(params, frontend, cfg))
    return cache


def cross_cache(params, frontend: torch.Tensor, cfg: ModelConfig
                ) -> Dict[str, torch.Tensor]:
    """The encoder run once (:func:`encode`) and each decoder layer's cross
    K/V of its output, ``cross_k`` / ``cross_v`` (L, batch, Hkv, Tx, hd);
    on a tensor-parallel rank (``params["tp"]``) its own KV heads, or under
    the sequence-cut dense decode (``sharding.seq_group``) every head of its
    block of frames."""
    enc = encode(params, frontend, cfg)
    tp = params.get("tp")
    seq = seq_group(cfg, tp)
    out = {}
    for i in range(cfg.num_layers):
        for name, t in zip(("cross_k", "cross_v"), _cross_kv(
                _layer(params["dec_blocks"], i), enc, cfg, tp,
                reciprocal_scale=False)):
            if seq is not None:
                # every KV head of the rank's block of frames
                t = shard(gather(t, tp, cfg.num_kv_heads, dim=1), 2, seq)
            if name not in out:
                out[name] = torch.empty((cfg.num_layers,) + t.shape,
                                        dtype=t.dtype, device=t.device)
            out[name][i] = t
    return out


def decode_step(params, cache, tokens: torch.Tensor, cfg: ModelConfig, *,
                write: Optional[torch.Tensor] = None):
    """One decode step on the dense cache, updated IN PLACE: tokens (B,) ->
    (logits (B, V) float32, cache).  Per decoder layer the token's K/V go
    to position ``len`` (``cfg.parallel.aligned_decode`` picks the lockstep
    or the ragged write; ``write`` (B,) bool freezes rows where it is
    False), self-attention over ``len + 1`` positions and cross-attention
    over every cached cross position, both through the plain
    ``ops.decode_attention`` (the reference's choice too).

    ``parallel.decode_attn="shard_map"``: both attentions take the
    log-sum-exp body (``ops.decode_attention(lse=True)``), as the
    reference's step does.  Under tensor parallelism the self cache and the
    cross K/V are then cut on the sequence (``sharding.seq_group``): the
    query and the new K/V are gathered over heads, the rank that holds
    ``len`` writes it, and every head's output comes out whole on every
    rank."""
    if "cross_k" not in cache:
        raise ValueError(
            f"{cfg.name}: the cache holds the encoder's cross K/V: build it "
            "with init_cache(..., frontend=, params=)")
    B = tokens.shape[0]
    hd, Hq, Hkv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    tp = params.get("tp")
    cut = _cut(cfg, tp)
    seq = seq_group(cfg, tp)
    n = 1 if seq is None else seq.size
    lse = lse_decode(cfg)
    x = params["embed"][tokens.to(torch.int64)][:, None, :].to(_dtype(cfg))
    pos = cache["len"]
    positions = pos[:, None]
    aligned = cfg.parallel.aligned_decode
    Tx = cache["cross_k"].shape[3] * n
    cross_len = torch.full((B,), Tx, dtype=torch.int32, device=x.device)

    def heads_out(o, w):
        # a rank's heads gathered before the whole output projection
        return L.linear(gather(o.transpose(1, 2).reshape(B, 1, -1), tp,
                               Hq * hd), w)

    for i in range(cfg.num_layers):
        p = _layer(params["dec_blocks"], i)
        q, k, v = L.qkv_project(p["self"], _norm(x, p["ln_self"], cfg), Hq,
                                Hkv, hd, tp=tp)
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
        kc, vc = cache["k"][i], cache["v"][i]
        if seq is None:
            L.cache_write(kc, k, pos, aligned, write)
            L.cache_write(vc, v, pos, aligned, write)
        else:
            q, k, v = gather_heads(tp, q, k, v, widths=(Hq, Hkv, Hkv))
            L.seq_cache_write(kc, k, pos, seq, write)
            L.seq_cache_write(vc, v, pos, seq, write)
        o = ops.decode_attention(q, kc, vc, pos + 1, lse=lse, seq=seq)
        x, s = _residual(x, heads_out(o, p["self"]["wo"]))
        qx = L.project_heads(_norm(s, p["ln_cross"], cfg), p["cross"]["wq"],
                             Hq, hd, tp, cut and seq is None)
        o = ops.decode_attention(qx, cache["cross_k"][i],
                                 cache["cross_v"][i], cross_len, lse=lse,
                                 seq=seq)
        x, s = _residual(x, heads_out(o, p["cross"]["wo"]))
        x = _mlp_tail(p, x, s, cfg, tp)
    logits = _logits(params, x[:, 0], cfg, rounded=False)
    cache["len"] += 1 if write is None else write.to(torch.int32)
    return logits, cache
