"""Hymba (arXiv:2411.13676) in torch: the hybrid-head LM whose every layer
runs attention heads and Mamba-style SSM heads in parallel on the same
input and fuses the two branches.

The block, as in the JAX package: a GQA sliding-window attention branch and
a selective-scan SSM branch on the pre-normed input, each branch's output
RMS-normed, the two averaged into the residual stream, then a SwiGLU FFN.
(The paper's meta tokens and cross-layer KV sharing are left out, as in the
JAX package.)  The SSM branch carries O(1) decode state; attention keeps a
bounded window.

Params are plain dicts of float32 tensors with the JAX package's layout:
every per-layer array has a leading layer axis.  ``forward`` runs whole
sequences, its attention through ``ops.attention`` (the flash kernel on
the card, one launch per layer, with the window).  The serve path:
``init_cache`` (K/V a ring of ``min(window, max_len)`` positions, the SSM
state (L, B, d, N) float32, ``len``), ``decode_step`` on that dense cache
and ``paged_decode_step`` through the page pool (the paged kernel on the
card, with the window) where the window covers the cache so that K/V page;
both update the cache IN PLACE where the JAX package returned a new one,
and both freeze the rows where ``write`` is False.  The prompt goes through
the decode step one token at a time (``api.prefill_bucketed``), so the SSM
state never sees padding, as in the JAX package.  The selective scan is
``ops.selective_scan``, plain PyTorch on every device (the JAX package has
no kernel for it).

Numerics follow the JAX package's compiled programs (``jax.jit`` on the
CPU), which differ from its source where XLA's excess-precision rule drops
a bfloat16 round trip before a float32 consumer, and where XLA's CPU
``exp`` and fused multiply-adds are not PyTorch's (``kernels/ref.py::exp``,
``ref.selective_scan``); see ``_ssm_branch`` and ``_fuse``.

Under tensor parallelism (a ``TPGroup`` in the params as ``"tp"``, from
the serving engine) the attention is the lm family's (the rank's block of
heads where both head counts divide, else every head over replicated
K/V); the SSM's ``w_in`` / ``w_delta`` / ``w_B`` / ``w_C``, ``w1`` / ``w3``
and the head are the rank's column blocks and ``w_delta_up`` / ``w_out`` /
``wo`` / ``w2`` whole (``distributed/sharding.py``).  The JAX package's
``_pin`` hook becomes a gather (``sharding.gather``): of the low-rank
delta and of B and C before the products over their width, of the scan's
output before ``w_out``.  The selective scan runs on the rank's block of
channels, whose SSM state the ``ssm`` leaf holds (cut on channels where the
group's size divides ``d_model``, as the JAX package's rules cut it).

On a training grid (``forward(model=)``, the grid's "model" group; the
params a rank's blocks under the training rules, which cut ``A_log`` on
its channels and ``w_delta_up`` / ``w_out`` on their rows besides the
serve cut's columns) the attention is ``layers.tp_attn_apply`` (at
hymba-1.5b's 25/5 heads every head on every rank), the SSM branch runs
the rank's ``d / tp`` channels (:func:`_tp_ssm_branch`), the FFN is
Megatron's and the two branch norms and their average run on whole
tensors.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.core.quant import QuantizedLinear
from repro_torch.distributed.collectives import copy_to, gather_from, gather_sum
from repro_torch.distributed.sharding import gather, head_cut
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Dict[str, Any]:
    """Random float32 params drawn from ``generator`` on ``device``, with the
    JAX package's distributions (whose random bits differ; tests convert
    the JAX package's params instead): ``dense_init`` projections, zero
    norm scales, ``A_log = log(1..N)`` per channel, ``D`` ones, embeddings
    N(0, 1) * 0.02.  Each projection is drawn one layer at a time."""
    d, Ln = cfg.d_model, cfg.num_layers
    ssm = cfg.ssm or SSMConfig()
    N, R = ssm.state_dim, ssm.dt_rank
    hd = cfg.resolved_head_dim
    f32 = torch.float32

    def dense(i, o):
        w = torch.empty((Ln, i, o), dtype=f32, device=device)
        for layer in range(Ln):
            w[layer] = L.dense_init(i, o, generator, device=device)
        return w

    def zeros(*shape):
        return torch.zeros(shape, dtype=f32, device=device)

    a_log = torch.log(torch.arange(1, N + 1, dtype=f32, device=device))
    embed = torch.empty((cfg.vocab_size, d), dtype=f32, device=device)
    embed.normal_(0.0, 1.0, generator=generator).mul_(0.02)
    return {
        "embed": embed,
        "blocks": {
            "ln_in": zeros(Ln, d), "ln_mlp": zeros(Ln, d),
            "ln_attn_out": zeros(Ln, d), "ln_ssm_out": zeros(Ln, d),
            "attn": {"wq": dense(d, cfg.num_heads * hd),
                     "wk": dense(d, cfg.num_kv_heads * hd),
                     "wv": dense(d, cfg.num_kv_heads * hd),
                     "wo": dense(cfg.num_heads * hd, d)},
            "ssm": {"w_in": dense(d, d), "w_delta": dense(d, R),
                    "w_delta_up": dense(R, d),
                    "A_log": a_log.expand(Ln, d, N).clone(),
                    "w_B": dense(d, N), "w_C": dense(d, N),
                    "D": torch.ones((Ln, d), dtype=f32, device=device),
                    "w_out": dense(d, d)},
            "mlp": {"w1": dense(d, cfg.d_ff), "w3": dense(d, cfg.d_ff),
                    "w2": dense(cfg.d_ff, d)},
        },
        "ln_final": zeros(d),
        "lm_head": L.dense_init(d, cfg.vocab_size, generator, device=device),
    }


# Batch axis of each serve-cache entry: k and v (L, B, Hkv, S, hd), ssm
# (L, B, d, N), len (B,).  K/V page when the window covers the cache (the
# engine's seq-axis diff sees them grow with max_len); the SSM state never
# does
BATCH_AXES = {"k": 1, "v": 1, "ssm": 1, "len": 0}
_SERVE_CAST = {"attn": ("wq", "wk", "wv", "wo"),
               "ssm": ("w_in", "w_delta", "w_delta_up", "w_B", "w_C",
                       "w_out"),
               "mlp": ("w1", "w3", "w2")}


def serve_params(params, cfg: ModelConfig, device) -> Dict[str, Any]:
    """The serving engine's copy of the float params on ``device``: the
    projections cast once to the compute dtype (the values every use casts
    them to), ``A_log``, ``D``, the norm scales and the embedding float32,
    the SSM's state matrix ``A = -exp(A_log)`` computed once (the values
    every step computes), the LM head rounded once to the compute dtype
    and held in float32 as ``lm_head_f32`` (the operand of
    :func:`_logits_head`)."""
    dtype = getattr(torch, cfg.dtype)
    blocks = params["blocks"]
    out = {k: w.to(device) for k, w in blocks.items()
           if not isinstance(w, dict)}
    for group, names in _SERVE_CAST.items():
        out[group] = {k: (w.to(device=device, dtype=dtype) if k in names
                          else w.to(device))
                      for k, w in blocks[group].items()}
    out["ssm"]["A"] = _state_matrix(out["ssm"]["A_log"])
    return {"embed": params["embed"].to(device),
            "ln_final": params["ln_final"].to(device),
            "blocks": out,
            "lm_head_f32": params["lm_head"].to(device=device, dtype=dtype)
                                            .to(torch.float32)}


def _layers(params):
    """Per-layer views of the stacked block params, in layer order."""
    blocks = params["blocks"]
    n = blocks["ln_in"].shape[0]

    def pick(node, i):
        if isinstance(node, dict):
            return {k: pick(v, i) for k, v in node.items()}
        return node[i]

    for i in range(n):
        yield i, pick(blocks, i)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``jax.nn.softplus`` (``logaddexp(x, 0)``) compiles on
    the CPU for a bfloat16 x: ``max(x, 0) + log1p(exp(-|x|))`` with each
    op rounded to bfloat16, the exp XLA's (``ref.exp``) and the log1p
    taken in float64 (the same bits as XLA's for every bfloat16 input, on
    any device)."""
    e = ref.exp(-x.to(torch.float32).abs()).to(x.dtype)
    lp = torch.log1p(e.to(torch.float64)).to(torch.float32).to(x.dtype)
    return torch.clamp_min(x, 0) + lp


def _state_matrix(a_log: torch.Tensor) -> torch.Tensor:
    """A = -exp(A_log) in float32, with XLA's exp (``ref.exp``)."""
    return -ref.exp(a_log.to(torch.float32))


def _ssm_branch(p, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[torch.Tensor] = None, tp=None):
    """x (B, T, d) -> (out (B, T, d), new state (B, d, N) float32); under
    tensor parallelism the state and the scan hold the rank's channels."""
    sp = p["ssm"]
    d = x.shape[-1]
    N = sp["A_log"].shape[-1]
    h = L.silu(L.linear(x, sp["w_in"]))
    delta = _softplus(L.linear(
        gather(L.linear(x, sp["w_delta"]), tp, L.in_width(sp["w_delta_up"])),
        sp["w_delta_up"])).to(torch.float32)
    A = sp["A"] if "A" in sp else _state_matrix(sp["A_log"])
    D = sp["D"]
    if h.shape[-1] != d:
        # the rank's channels of the whole-width delta, A and D
        lo = tp.rank * h.shape[-1]
        sl = slice(lo, lo + h.shape[-1])
        delta, A, D = delta[..., sl], A[sl], D[sl]
    Bm = gather(L.linear(x, sp["w_B"]), tp, N).to(torch.float32)
    Cm = gather(L.linear(x, sp["w_C"]), tp, N).to(torch.float32)
    y, new_state = ops.selective_scan(h, delta, A, Bm, Cm, state,
                                      algorithm=cfg.ssm_scan)
    y = y + h * D.to(h.dtype)
    return L.linear(gather(y, tp, d), sp["w_out"]), new_state


def _tp_ssm_branch(p, x: torch.Tensor, cfg: ModelConfig, model):
    """:func:`_ssm_branch` of a whole sequence from a zero state on a
    training grid's "model" group, the rank holding ``d / tp`` channels:
    ``w_in``'s column block gives its channels of h and ``A_log``'s row
    block their state matrix; the low-rank ``delta`` pair is gathered
    whole (``layers.whole_weight``), so ``delta`` is one device's, of which
    the rank keeps its channels (and of ``D``, ``layers.own_slice``);
    ``w_B`` / ``w_C``, cut on the state dim N, give (B, T, N / tp) blocks
    that are gathered to every N in float32 (``gather_sum``: every
    channel's scan reads all of them, so the gradient is the ranks' sum,
    rounded once); the scan runs on the rank's channels; ``w_out``'s row
    block sums their output (``layers.row_linear``).  The input passes
    ``copy_to``.  A group whose size does not divide ``d`` runs the whole
    branch on every rank."""
    sp = p["ssm"]
    d = x.shape[-1]
    ssm = cfg.ssm or SSMConfig()
    N, R = ssm.state_dim, ssm.dt_rank
    if sp["w_in"].shape[-1] == d:
        whole = dict(sp)
        for k, dim, n in (("w_delta", -1, R), ("w_delta_up", -2, R),
                          ("w_B", -1, N), ("w_C", -1, N)):
            if sp[k].shape[dim] != n:
                whole[k] = gather_from(sp[k], model, dim)
        return _ssm_branch(dict(p, ssm=whole), x, cfg)[0]
    width = sp["w_in"].shape[-1]
    xc = copy_to(x, model)
    h = L.silu(L.linear(xc, sp["w_in"]))
    w_delta = L.whole_weight(sp["w_delta"], model, -1, R)
    w_delta_up = L.whole_weight(sp["w_delta_up"], model, -2, R)
    delta = _softplus(L.linear(L.linear(xc, w_delta), w_delta_up).narrow(
        -1, model.rank * width, width)).to(torch.float32)
    A = _state_matrix(sp["A_log"])
    D = L.own_slice(sp["D"], model, width)

    def state_proj(w):
        # the blocks travel in float32, so the ranks' gradients of them are
        # summed before their one rounding to the compute dtype
        if w.shape[-1] == N:
            return L.linear(xc, copy_to(w, model)).to(torch.float32)
        return gather_sum(L.linear(xc, w), model, -1, torch.float32)

    y, _ = ops.selective_scan(h, delta, A, state_proj(sp["w_B"]),
                              state_proj(sp["w_C"]), None,
                              algorithm=cfg.ssm_scan)
    y = y + h * D.to(h.dtype)
    return L.row_linear(y, sp["w_out"], model)


def _fuse(p, x: torch.Tensor, attn_out: torch.Tensor,
          ssm_out: torch.Tensor, cfg: ModelConfig, tp=None,
          model=None) -> torch.Tensor:
    """The hybrid-head tail shared by every path: per-branch norms, their
    average into the residual stream, the SwiGLU FFN.  The FFN's pre-norm
    reads the residual sum ``x + fused`` before it is rounded to the
    compute dtype, as the JAX package's compiled programs do (XLA drops
    that bfloat16 round trip before the norm's float32 convert); the
    residual stream itself is rounded.  ``model`` (a training grid's
    group): the FFN is ``layers.tp_swiglu``; the norms run on the whole
    branch outputs, as on one device."""
    eps = cfg.norm_eps
    fused = 0.5 * (L.rmsnorm(attn_out, p["ln_attn_out"], eps)
                   + L.rmsnorm(ssm_out, p["ln_ssm_out"], eps))
    s = x.to(torch.float32) + fused.to(torch.float32)
    x = s.to(x.dtype)
    y = L.rmsnorm(s, p["ln_mlp"], eps).to(x.dtype)
    mlp = p["mlp"]
    if model is not None:
        return x + L.tp_swiglu(y, mlp["w1"], mlp["w3"], mlp["w2"], model,
                               cfg.d_ff)
    return x + L.swiglu(y, mlp["w1"], mlp["w3"], mlp["w2"], tp=tp)


def _fuse_tail(p, x, xn, o, sstate, cfg: ModelConfig, tp=None):
    """The decode tail of both cache layouts: attention-out projection, SSM
    branch from ``sstate``, :func:`_fuse`.  o: (B, Hq, 1, hd) -> (new x,
    new SSM state); under tensor parallelism a rank's block of heads is
    gathered before ``wo``."""
    B = x.shape[0]
    o = gather(o.transpose(1, 2).reshape(B, 1, -1), tp,
               cfg.num_heads * cfg.resolved_head_dim)
    attn_out = L.linear(o, p["attn"]["wo"])
    ssm_out, new_state = _ssm_branch(p, xn, cfg, state=sstate, tp=tp)
    return _fuse(p, x, attn_out, ssm_out, cfg, tp), new_state


def _embed(params, tokens: torch.Tensor, cfg: ModelConfig,
           model=None) -> torch.Tensor:
    """Embedding rows in the compute dtype; ``model`` (a training grid's
    group): the table may be the rank's vocabulary block
    (``layers.vocab_embed``)."""
    if model is not None:
        x = L.vocab_embed(params["embed"], tokens, model, cfg.vocab_size)
        return x.to(getattr(torch, cfg.dtype))
    return params["embed"][tokens.to(torch.int64)].to(getattr(torch, cfg.dtype))


def _logits_head(params, x: torch.Tensor, cfg: ModelConfig,
                 rounded: bool = False, model=None) -> torch.Tensor:
    """Final norm and the LM head as a float32 product of compute-dtype
    values: float32 logits.  The decode steps' compiled programs keep that
    product unrounded; ``forward``'s round it to the compute dtype first
    (``rounded``).  The head is the serving engine's ``lm_head_f32`` where
    present, else ``lm_head`` rounded to the compute dtype here.
    ``model`` (a training grid's group): a head cut on the vocabulary takes
    its input through ``copy_to`` and the logits stay the rank's block."""
    x = L.rmsnorm(x, params["ln_final"], cfg.norm_eps)
    head = params.get("lm_head_f32")
    if head is None:
        head = params["lm_head"]
        if not isinstance(head, QuantizedLinear):
            head = head.to(x.dtype).to(torch.float32)
    x32 = x.to(torch.float32)
    if model is not None and head.shape[-1] != cfg.vocab_size:
        logits = copy_to(x32, model) @ head
    else:
        logits = gather(L.head_logits(x32, head, x.dtype), params.get("tp"),
                        cfg.vocab_size)
    return logits.to(x.dtype).to(torch.float32) if rounded else logits


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, model=None,
            **_):
    """Whole-sequence logits: tokens (B, T) -> (logits (B, T, V) float32,
    aux 0.0).  Each layer's attention is ``layers.attn_apply`` with the
    config's window (the flash kernel on the card) and its SSM branch scans
    from a zero state.  Each layer runs under the config's
    ``parallel.remat`` (``layers.remat``; "dots" is "full" here, as in the
    reference), which changes no value or gradient.

    ``model`` (a training grid's "model" group of more than one rank;
    ``params`` the rank's blocks, whole on "data"): the attention is
    ``layers.tp_attn_apply`` with the window (the rank's heads where both
    head counts divide, else every head on every rank: hymba-1.5b's 25/5),
    the SSM branch :func:`_tp_ssm_branch`, the FFN ``layers.tp_swiglu``,
    the embedding and head vocabulary-parallel where the rules cut them
    (not at a vocabulary of 32,001), and the logits the rank's block."""
    if model is not None and model.size == 1:
        model = None
    x = _embed(params, tokens, cfg, model)
    T = tokens.shape[1]
    positions = torch.arange(T, device=x.device)
    window = cfg.layer_pattern[0].window
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
              head_dim=cfg.resolved_head_dim, positions=positions,
              rope_theta=cfg.rope_theta, window=window)

    def layer(x, p):
        xn = L.rmsnorm(x, p["ln_in"], cfg.norm_eps)
        if model is None:
            attn_out = L.attn_apply(p["attn"], xn, **kw)
            ssm_out, _ = _ssm_branch(p, xn, cfg)
        else:
            attn_out = L.tp_attn_apply(p["attn"], xn, model, **kw)
            ssm_out = _tp_ssm_branch(p, xn, cfg, model)
        return _fuse(p, x, attn_out, ssm_out, cfg, model=model)

    layer = L.remat(layer, cfg.parallel.remat, policy=False)
    at = L.layer_views(params["blocks"])
    for i in range(params["blocks"]["ln_in"].shape[0]):
        x = layer(x, at(i))
    return _logits_head(params, x, cfg, rounded=True, model=model), 0.0


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> Dict[str, Any]:
    """Zeroed serve cache: K and V (L, batch, Hkv, S, hd) in the compute
    dtype with S = min(window, max_len) (a ring once the window binds), the
    SSM state (L, batch, d, N) float32 and ``len`` (batch,) int32."""
    ssm = cfg.ssm or SSMConfig()
    hd = cfg.resolved_head_dim
    window = cfg.layer_pattern[0].window or max_len
    S = min(window, max_len)
    Ln = cfg.num_layers
    dtype = getattr(torch, cfg.dtype)
    kv = (Ln, batch, cfg.num_kv_heads, S, hd)
    return {"k": torch.zeros(kv, dtype=dtype, device=device),
            "v": torch.zeros(kv, dtype=dtype, device=device),
            "ssm": torch.zeros((Ln, batch, cfg.d_model, ssm.state_dim),
                               dtype=torch.float32, device=device),
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def _decode_qkv(p, x, positions, cfg: ModelConfig, tp=None):
    xn = L.rmsnorm(x, p["ln_in"], cfg.norm_eps)
    q, k, v = L.qkv_project(p["attn"], xn, cfg.num_heads, cfg.num_kv_heads,
                            cfg.resolved_head_dim, tp=tp)
    return xn, L.rope(q, positions, cfg.rope_theta), \
        L.rope(k, positions, cfg.rope_theta), v


def decode_step(params, cache, tokens: torch.Tensor, cfg: ModelConfig, *,
                write: Optional[torch.Tensor] = None):
    """One token per row on the dense cache, updated IN PLACE: tokens (B,)
    -> (logits (B, V) float32, cache).  Each row writes its K/V at ``len %
    S`` of the ring and attends to its first ``min(len + 1, S)`` entries
    (``ops.decode_attention``, plain on every device, as in the JAX
    package).  ``cfg.parallel.aligned_decode`` picks the lockstep write
    (``generate()``) or the ragged one (slots); ``write`` (B,) bool freezes
    the rows where it is False: their K/V, SSM state and ``len`` keep their
    values and their logits are to be ignored."""
    tp = params.get("tp")
    x = _embed(params, tokens, cfg)[:, None, :]
    pos = cache["len"]
    positions = pos[:, None]
    aligned = cfg.parallel.aligned_decode
    for i, p in _layers(params):
        kc, vc = cache["k"][i], cache["v"][i]
        xn, q, k, v = _decode_qkv(p, x, positions, cfg, tp)
        S = kc.shape[2]
        idx = pos % S
        L.cache_write(kc, k, idx, aligned, write)
        L.cache_write(vc, v, idx, aligned, write)
        o = ops.decode_attention(q, kc, vc, torch.clamp(pos + 1, max=S))
        x, new_state = _fuse_tail(p, x, xn, o, cache["ssm"][i], cfg, tp)
        L.store_rows(cache["ssm"][i], new_state, write)
    logits = _logits_head(params, x[:, 0], cfg)
    cache["len"] += 1 if write is None else write.to(torch.int32)
    return logits, cache


def paged_decode_step(params, cache, table: torch.Tensor,
                      tokens: torch.Tensor, cfg: ModelConfig, *,
                      write: Optional[torch.Tensor] = None, seq_axes=None):
    """One decode step straight through the page pool, updated IN PLACE.

    Reached only where the window covers the whole cache, so that K/V page:
    ``cache["k"]`` / ``["v"]`` are pool leaves (L, num_pages, page_size,
    Hkv, hd) (``QuantizedLeaf`` s in an int8 / fp8 pool); each layer
    appends its token to its page (``layers.paged_append``) and attends
    through the table with ``ops.paged_decode_attention`` and the window
    (the paged kernel on the card).  The SSM state stays dense (L, n_slots,
    d, N) and, like ``len``, is frozen where ``write`` is False (a False
    row appends to the scratch page and gives logits to be ignored)."""
    del seq_axes        # hymba's K/V page whenever this entry point is used
    tp = params.get("tp")
    cut = head_cut(tp, cfg.num_heads, cfg.num_kv_heads)
    B = tokens.shape[0]
    if write is None:
        write = torch.ones((B,), dtype=torch.bool, device=tokens.device)
    x = _embed(params, tokens, cfg)[:, None, :]
    pos = cache["len"]
    positions = pos[:, None]
    page, off = L.page_offsets(table, pos, write, cache["k"].shape[2])
    cache_len = (pos + 1).to(torch.int32)
    window = cfg.layer_pattern[0].window
    for i, p in _layers(params):
        kc, vc = cache["k"][i], cache["v"][i]
        xn, q, k, v = _decode_qkv(p, x, positions, cfg, tp)
        L.paged_append(kc, k[:, :, 0, :], page, off)
        L.paged_append(vc, v[:, :, 0, :], page, off)
        o = ops.paged_decode_attention(q, kc, vc, table, cache_len,
                                       window=window, tp=tp, head_cut=cut)
        x, new_state = _fuse_tail(p, x, xn, o, cache["ssm"][i], cfg, tp)
        L.store_rows(cache["ssm"][i], new_state, write)
    logits = _logits_head(params, x[:, 0], cfg)
    cache["len"] += write.to(torch.int32)
    return logits, cache
