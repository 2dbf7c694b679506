"""RWKV6 "Finch" (arXiv:2404.05892) in torch: the attention-free LM with
data-dependent decay.

The block, as in the JAX package:
  time-mix: token-shift lerps with learned mixes; decay
      w_t = exp(-exp(w0 + lora_w(x_shift))) (data-dependent, per channel);
  wkv: S_t = diag(w_t) S_{t-1} + k_t v_t^T ; out = r_t (S + diag(u) k v^T);
  an RMS norm over the heads' output, a silu(g) gate, the output projection;
  channel-mix: a squared-relu MLP with token shift.

Params are plain dicts of tensors with the JAX package's layout: every
per-layer array has a leading layer axis.  ``forward`` runs whole sequences,
its WKV recurrence through ``ops.rwkv6`` with no carried state -- the CUDA
kernel on the card, one launch per layer.  ``decode_step`` carries the
recurrent state and the two token-shift carries per layer and updates the
cache IN PLACE where the JAX package returned a new one; its recurrence
takes the plain version on every device, as the JAX package's does.

Numerics follow the JAX package's COMPILED programs, which differ from its
source in two places (XLA's excess-precision rule drops a bfloat16 round
trip where a float32 consumer follows): the time-mix residual sum reaches
the channel-mix pre-norm in float32 (the residual stream itself is
rounded), and ``decode_step``'s LM head product is not rounded to bfloat16
before its float32 convert, while ``forward``'s is.

Under tensor parallelism (a ``TPGroup`` in the params as ``"tp"``, from
the serving engine) the projections ``wr`` / ``wk`` / ``wv`` / ``wg`` /
``w_lora_a`` / ``cm_k`` and the head are the rank's column blocks and
``wo`` / ``w_lora_b`` / ``cm_v`` are whole (``distributed/sharding.py``).
The JAX package's ``_pin`` hook becomes a gather (``sharding.gather``)
before each whole product and before the ``ln_x`` norm, whose mean runs
over every channel.  Where the group's size divides the head count, the
rank keeps its block of heads of r, k, v, the decay and the WKV state
(the engine's rank cache, ``sharding.rank_cache``, cuts the ``wkv`` leaf
so); else r, k and v are gathered and every rank carries every head.  The
token-shift carries ``x_tm`` / ``x_cm`` stay whole on every rank (the one
exception to the serve cache rules there): they are the pre-normed inputs,
which every rank holds whole, and a cut would only force a gather at the
next step.

On a training grid (``forward(model=)``, the grid's "model" group; the
params a rank's blocks under the training rules: ``wr`` / ``wk`` / ``wv``
/ ``wg`` / ``w_lora_a`` / ``cm_k`` column-cut, ``wo`` / ``w_lora_b`` /
``cm_v`` row-cut, the embedding and head on the vocabulary) each layer is
Megatron's (:func:`_tp_block`): the rank runs the scan on its ``H / tp``
heads (the kernel on the card, through ``RWKV6ScanFn``), gathers the
decay's LoRA pair whole so that ``dw`` keeps one device's sum order,
reduces ``ln_x``'s float32 sum of squares over the group, and sums ``wo``'s
and ``cm_v``'s row blocks; a group whose size does not divide the heads
runs the whole layer on every rank.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quant import QuantizedLinear
from repro_torch.distributed.collectives import copy_to, gather_from
from repro_torch.distributed.sharding import gather, head_cut, local_width
from repro_torch.kernels import ops
from repro_torch.models.layers import (cut_rmsnorm, dense_init, head_logits,
                                       in_width, layer_views, linear,
                                       own_slice, remat,
                                       rmsnorm, row_linear, silu, store_rows,
                                       vocab_embed, whole_weight)

HEAD_DIM = 64  # RWKV6 uses 64-wide heads
LORA_DIM = 64


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Dict[str, Any]:
    """Random float32 params drawn from ``generator`` on ``device``, with the
    JAX package's distributions (whose random bits differ; tests convert
    the JAX package's params instead): mixes U(0, 1), ``dense_init``
    projections, w0 U(-8, -5), ``w_lora_b`` scaled by 0.1, u N(0, 1) * 0.3,
    embeddings N(0, 1) * 0.02, norm scales 0."""
    assert cfg.d_model % HEAD_DIM == 0
    d, L = cfg.d_model, cfg.num_layers
    H = d // HEAD_DIM
    f32 = torch.float32
    kw = dict(lead=(L,), device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=f32, device=device)

    def uniform(shape, lo, hi):
        return torch.empty(shape, dtype=f32, device=device).uniform_(
            lo, hi, generator=generator)

    def normal(shape, scale):
        return torch.empty(shape, dtype=f32, device=device).normal_(
            0.0, 1.0, generator=generator).mul_(scale)

    blocks = {
        "ln_tm": zeros(L, d),
        "ln_cm": zeros(L, d),
        "mix": uniform((L, 5, d), 0.0, 1.0),        # r, k, v, g, w mixes
        "wr": dense_init(d, d, generator, **kw),
        "wk": dense_init(d, d, generator, **kw),
        "wv": dense_init(d, d, generator, **kw),
        "wg": dense_init(d, d, generator, **kw),
        "wo": dense_init(d, d, generator, **kw),
        "w0": uniform((L, d), -8.0, -5.0),
        "w_lora_a": dense_init(d, LORA_DIM, generator, **kw),
        "w_lora_b": dense_init(LORA_DIM, d, generator, **kw).mul_(0.1),
        "u": normal((L, H, HEAD_DIM), 0.3),
        "ln_x": zeros(L, d),
        "cm_k": dense_init(d, cfg.d_ff, generator, **kw),
        "cm_v": dense_init(cfg.d_ff, d, generator, **kw),
    }
    return {"embed": normal((cfg.vocab_size, d), 0.02),
            "blocks": blocks,
            "ln_final": zeros(d),
            "lm_head": dense_init(d, cfg.vocab_size, generator, device=device)}


def _layers(params):
    """Per-layer views of the stacked block params, in layer order (with
    the params' TP group, where they have one, as ``"tp"``)."""
    blocks = params["blocks"]
    extra = {"tp": params["tp"]} if "tp" in params else {}
    # a float leaf's leading axis (a LAQ-quantized leaf has no shape)
    depth = next(w for w in blocks.values() if torch.is_tensor(w)).shape[0]
    for i in range(depth):
        yield i, {**{k: w[i] for k, w in blocks.items()}, **extra}


def _token_shift(x: torch.Tensor, x_prev: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """shifted[t] = x[t-1]; position 0 takes ``x_prev`` (the decode carry)
    or zeros."""
    if x_prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([x_prev[:, None, :], x[:, :-1]], dim=1)


def _heads(a: torch.Tensor, B: int, T: int, H: int) -> torch.Tensor:
    return a.reshape(B, T, H, HEAD_DIM).transpose(1, 2)


def decay(w0: torch.Tensor, dw: torch.Tensor) -> torch.Tensor:
    """The data-dependent decay exp(-exp(w0 + dw)) in float32, each exp
    evaluated in float64 and rounded to float32: the correctly rounded
    float32 exp (bar a float64 result within 2^-29 of a float32 rounding
    boundary), so the CPU and the card give the same bits where their
    float32 exps differ in the last place."""
    a = w0.to(torch.float32) + dw.to(torch.float32)
    inner = torch.exp(a.to(torch.float64)).to(torch.float32)
    return torch.exp(-inner.to(torch.float64)).to(torch.float32)


def _time_mix(p, x, cfg: ModelConfig, state=None, x_prev=None):
    """x (B, T, d), the pre-normed input -> (output (B, T, d), new WKV state,
    x's last position: the next step's token-shift carry).  ``p["tp"]``,
    where present: the module docstring's tensor parallelism (the state of
    the rank's heads where the group's size divides them)."""
    tp = p.get("tp")
    B, T, d = x.shape
    H = d // HEAD_DIM
    cut = head_cut(tp, H)
    hl = local_width(H, tp)
    xs = _token_shift(x, x_prev)
    mix = p["mix"].to(x.dtype)
    xr, xk, xv, xg, xw = (x + mix[i] * (xs - x) for i in range(5))

    def heads(xi, w):
        y = linear(xi, w)
        return _heads(y if cut else gather(y, tp, d), B, T, hl)

    r, k, v = heads(xr, p["wr"]), heads(xk, p["wk"]), heads(xv, p["wv"])
    g = silu(gather(linear(xg, p["wg"]), tp, d))
    dw = linear(gather(torch.tanh(linear(xw, p["w_lora_a"])), tp, LORA_DIM),
                p["w_lora_b"])
    w0, u = p["w0"], p["u"]
    if cut:
        # the rank's channels of the decay (elementwise) and its heads' u
        lo = tp.rank * hl
        w0 = w0[lo * HEAD_DIM:(lo + hl) * HEAD_DIM]
        dw = dw[..., lo * HEAD_DIM:(lo + hl) * HEAD_DIM]
        u = u[lo:lo + hl]
    w = _heads(decay(w0, dw), B, T, hl).to(r.dtype)
    out, new_state = _wkv(r, k, v, w, u, cfg, state)
    out = gather(out.transpose(1, 2).reshape(B, T, -1), tp, d)
    out = rmsnorm(out, p["ln_x"], cfg.norm_eps) * g
    return linear(out, p["wo"]), new_state, x[:, -1]


def _wkv(r, k, v, w, u, cfg: ModelConfig, state=None):
    """The WKV recurrence of (B, H, T, 64) heads: the chunked form where the
    config asks for it, else ``ops.rwkv6`` (the scan kernel on the card
    from a zero state)."""
    u = u.to(torch.float32)
    if cfg.rwkv_chunk and r.shape[2] > 1:
        return ops.rwkv6_chunked(r, k, v, w, u, state, chunk=cfg.rwkv_chunk)
    return ops.rwkv6(r, k, v, w, u, state)


def _tp_time_mix(p, x, cfg: ModelConfig, model):
    """:func:`_time_mix` of a whole sequence on a training grid's "model"
    group, the rank holding ``H / tp`` heads: its column blocks of ``wr`` /
    ``wk`` / ``wv`` / ``wg`` give its heads' r, k, v and its channels of g
    (each mixed input through ``copy_to``); the decay's LoRA pair is
    gathered whole (``layers.whole_weight``) so that ``dw`` is one
    device's, with its sum order (a changed rounding there flips decays
    near 1), and the rank keeps its channels of it, of ``w0``, of ``u``'s
    heads and of ``ln_x`` (``layers.own_slice``); the scan runs on the
    rank's heads (``ops.rwkv6``: the kernel on the card); ``ln_x``, a norm
    over all d channels, sums the ranks' float32 squares
    (``layers.cut_rmsnorm``); ``wo``'s row block sums the heads' output
    (``layers.row_linear``)."""
    B, T, d = x.shape
    hl = d // HEAD_DIM // model.size
    width = hl * HEAD_DIM
    xs = _token_shift(x)
    mix = p["mix"].to(x.dtype)
    xr, xk, xv, xg, xw = (copy_to(x + mix[i] * (xs - x), model)
                          for i in range(5))
    r = _heads(linear(xr, p["wr"]), B, T, hl)
    k = _heads(linear(xk, p["wk"]), B, T, hl)
    v = _heads(linear(xv, p["wv"]), B, T, hl)
    g = silu(linear(xg, p["wg"]))
    lora_a = whole_weight(p["w_lora_a"], model, -1, LORA_DIM)
    lora_b = whole_weight(p["w_lora_b"], model, -2, LORA_DIM)
    dw = linear(torch.tanh(linear(xw, lora_a)), lora_b)
    dw = dw.narrow(-1, model.rank * width, width)
    w = _heads(decay(own_slice(p["w0"], model, width), dw), B, T,
               hl).to(r.dtype)
    out, _ = _wkv(r, k, v, w, own_slice(p["u"], model, hl, 0), cfg)
    out = cut_rmsnorm(out.transpose(1, 2).reshape(B, T, width),
                      own_slice(p["ln_x"], model, width), d, model,
                      cfg.norm_eps) * g
    return row_linear(out, p["wo"], model)


def _tp_channel_mix(p, x, model):
    """:func:`_channel_mix` on a training grid's "model" group: ``cm_k``'s
    column block and ``cm_v``'s row block (Megatron's MLP)."""
    xs = _token_shift(x)
    xk = copy_to(x + p["mix"].to(x.dtype)[1] * (xs - x), model)
    h = torch.square(torch.relu(linear(xk, p["cm_k"])))
    return row_linear(h, p["cm_v"], model)


# a rank's leaves cut on their last dim / on the one before, by the
# training rules
_COL_KEYS = ("wr", "wk", "wv", "wg", "w_lora_a", "cm_k")
_ROW_KEYS = ("wo", "w_lora_b", "cm_v")


def _whole_layer(p, cfg: ModelConfig, model):
    """A layer's params whole on every rank (``gather_from``: the one-device
    block runs alike on every rank), for a group whose size does not
    divide the heads."""
    width = {"wr": cfg.d_model, "wk": cfg.d_model, "wv": cfg.d_model,
             "wg": cfg.d_model, "w_lora_a": LORA_DIM, "cm_k": cfg.d_ff,
             "wo": cfg.d_model, "w_lora_b": LORA_DIM, "cm_v": cfg.d_ff}
    out = dict(p)
    for key in _COL_KEYS + _ROW_KEYS:
        dim = -1 if key in _COL_KEYS else -2
        if p[key].shape[dim] != width[key]:
            out[key] = gather_from(p[key], model, dim)
    return out


def _tp_block(p, x, cfg: ModelConfig, model):
    """:func:`_block` of a whole sequence on a training grid's "model"
    group (module docstring): Megatron's cuts where the group's size
    divides the heads (the channel mix where it divides ``d_ff``), else
    every rank runs the whole layer."""
    if not head_cut(model, cfg.d_model // HEAD_DIM) or \
            p["cm_k"].shape[-1] == cfg.d_ff:
        return _block(_whole_layer(p, cfg, model), x, cfg)[0]
    h = _tp_time_mix(p, rmsnorm(x, p["ln_tm"], cfg.norm_eps), cfg, model)
    s = x.to(torch.float32) + h.to(torch.float32)
    x = s.to(x.dtype)
    return x + _tp_channel_mix(
        p, rmsnorm(s, p["ln_cm"], cfg.norm_eps).to(x.dtype), model)


def _channel_mix(p, x, x_prev=None):
    """x (B, T, d), the pre-normed input -> (output, x's last position)."""
    tp = p.get("tp")
    xs = _token_shift(x, x_prev)
    mix = p["mix"].to(x.dtype)
    xk = x + mix[1] * (xs - x)
    h = torch.square(torch.relu(linear(xk, p["cm_k"])))
    return linear(gather(h, tp, in_width(p["cm_v"])), p["cm_v"]), x[:, -1]


def _block(p, x, cfg: ModelConfig, state=None, x_tm=None, x_cm=None):
    """One layer on the residual stream x (B, T, d) in the compute dtype:
    (new x, new WKV state, time-mix carry, channel-mix carry).  The time-mix
    residual sum feeds the channel-mix pre-norm unrounded (module docstring)."""
    h, new_state, last_tm = _time_mix(
        p, rmsnorm(x, p["ln_tm"], cfg.norm_eps), cfg, state=state, x_prev=x_tm)
    s = x.to(torch.float32) + h.to(torch.float32)
    x = s.to(x.dtype)
    h, last_cm = _channel_mix(
        p, rmsnorm(s, p["ln_cm"], cfg.norm_eps).to(x.dtype), x_prev=x_cm)
    return x + h, new_state, last_tm, last_cm


def _embed(params, tokens: torch.Tensor, cfg: ModelConfig,
           model=None) -> torch.Tensor:
    """Embedding rows in the compute dtype; ``model`` (a training grid's
    group): the table may be the rank's vocabulary block
    (``layers.vocab_embed``)."""
    if model is not None:
        x = vocab_embed(params["embed"], tokens, model, cfg.vocab_size)
        return x.to(getattr(torch, cfg.dtype))
    return params["embed"][tokens.to(torch.int64)].to(getattr(torch, cfg.dtype))


def _head(params, x: torch.Tensor, cfg: ModelConfig,
          model=None) -> torch.Tensor:
    """Final norm and the LM head as a float32 product of compute-dtype
    values: float32 logits.  The head is rounded to the compute dtype here,
    unless the params hold it so already as ``lm_head_f32`` (the serving
    engine's copy, so that no step casts it).  ``model`` (a training
    grid's group): a head cut on the vocabulary takes its input through
    ``copy_to`` and the logits stay the rank's vocabulary block."""
    x = rmsnorm(x, params["ln_final"], cfg.norm_eps)
    head = params.get("lm_head_f32")
    dtype = x.dtype
    if head is None:
        head = params["lm_head"]
        if not isinstance(head, QuantizedLinear):
            head = head.to(dtype).to(torch.float32)
    x = x.to(torch.float32)
    if model is not None and head.shape[-1] != cfg.vocab_size:
        return copy_to(x, model) @ head
    return gather(head_logits(x, head, dtype), params.get("tp"),
                  cfg.vocab_size)


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, model=None,
            **_):
    """Whole-sequence logits: tokens (B, T) -> (logits (B, T, V) float32,
    aux 0.0).  Each layer's WKV recurrence is ``ops.rwkv6`` from a zero
    state (the CUDA kernel on the card).  The logits are rounded to the
    compute dtype before their float32 convert, as the JAX package's
    compiled forward does.  Each layer runs under the config's
    ``parallel.remat`` (``layers.remat``; "dots" is "full" here, as in the
    reference), which changes no value or gradient.

    ``model`` (a training grid's "model" group of more than one rank;
    ``params`` the rank's blocks, whole on "data"): each layer is
    :func:`_tp_block`, the embedding and the head vocabulary-parallel where
    the rules cut them, and the logits the rank's vocabulary block."""
    if model is not None and model.size == 1:
        model = None
    x = _embed(params, tokens, cfg, model)
    if model is None:
        body = lambda x, p: _block(p, x, cfg)[0]      # noqa: E731
    else:
        body = lambda x, p: _tp_block(p, x, cfg, model)  # noqa: E731
    layer = remat(body, cfg.parallel.remat, policy=False)
    at = layer_views(params["blocks"])
    for i in range(params["blocks"]["ln_tm"].shape[0]):
        x = layer(x, at(i))
    logits = (_head(params, x, cfg) if model is None
              else _head(params, x, cfg, model))
    return logits.to(x.dtype).to(torch.float32), 0.0


def init_cache(cfg: ModelConfig, batch: int, max_len: int = 0,
               device="cuda") -> Dict[str, Any]:
    """Recurrent state, O(1) in the sequence length: per layer the (H, 64,
    64) float32 WKV state and the two token-shift carries in the compute
    dtype, and ``len`` (batch,) int32.  ``max_len`` is unused."""
    H = cfg.d_model // HEAD_DIM
    L = cfg.num_layers
    dtype = getattr(torch, cfg.dtype)
    return {
        "wkv": torch.zeros((L, batch, H, HEAD_DIM, HEAD_DIM),
                           dtype=torch.float32, device=device),
        "x_tm": torch.zeros((L, batch, cfg.d_model), dtype=dtype,
                            device=device),
        "x_cm": torch.zeros((L, batch, cfg.d_model), dtype=dtype,
                            device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


# Batch axis of each serve-cache entry: wkv (L, B, H, 64, 64), x_tm and x_cm
# (L, B, d), len (B,); no entry grows with the sequence, so the serving
# engine finds no leaf that pages and keeps the dense slot layout
BATCH_AXES = {"wkv": 1, "x_tm": 1, "x_cm": 1, "len": 0}
# block params cast once to the compute dtype for serving; the decay base
# w0, the bonus u and the norm scales stay float32
_SERVE_CAST = ("mix", "wr", "wk", "wv", "wg", "wo", "w_lora_a", "w_lora_b",
               "cm_k", "cm_v")


def serve_params(params, cfg: ModelConfig, device) -> Dict[str, Any]:
    """The serving engine's copy of the float params on ``device``: the
    projections and mixes cast once to the compute dtype (the values every
    use casts them to), the rest float32 (a tensor already in place is not
    copied); the LM head rounded once to the compute dtype and held in
    float32 as ``lm_head_f32``, the operand of :func:`_head`."""
    dtype = getattr(torch, cfg.dtype)
    return {"embed": params["embed"].to(device),
            "ln_final": params["ln_final"].to(device),
            "blocks": {k: w.to(device=device, dtype=dtype)
                       if k in _SERVE_CAST else w.to(device)
                       for k, w in params["blocks"].items()},
            "lm_head_f32": params["lm_head"].to(device=device, dtype=dtype)
                                            .to(torch.float32)}


def decode_step(params, cache, tokens: torch.Tensor, cfg: ModelConfig, *,
                write: Optional[torch.Tensor] = None):
    """One token per row, the cache updated IN PLACE: tokens (B,) ->
    (logits (B, V) float32, cache).  ``write`` (B,) bool freezes the rows
    where it is False: their state, carries and ``len`` keep their values
    and their logits are to be ignored."""
    x = _embed(params, tokens, cfg)[:, None, :]
    for i, p in _layers(params):
        x, wkv, last_tm, last_cm = _block(
            p, x, cfg, state=cache["wkv"][i], x_tm=cache["x_tm"][i],
            x_cm=cache["x_cm"][i])
        store_rows(cache["wkv"][i], wkv, write)
        store_rows(cache["x_tm"][i], last_tm, write)
        store_rows(cache["x_cm"][i], last_cm, write)
    logits = _head(params, x[:, 0], cfg)
    cache["len"] += 1 if write is None else write.to(torch.int32)
    return logits, cache
