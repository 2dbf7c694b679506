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
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import gather, head_cut, local_width
from repro_torch.kernels import ops
from repro_torch.models.layers import (dense_init, in_width, layer_views,
                                       linear, remat, rmsnorm, silu,
                                       store_rows)

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
    for i in range(next(iter(blocks.values())).shape[0]):
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
    u = u.to(torch.float32)
    if cfg.rwkv_chunk and T > 1:
        out, new_state = ops.rwkv6_chunked(r, k, v, w, u, state,
                                           chunk=cfg.rwkv_chunk)
    else:
        out, new_state = ops.rwkv6(r, k, v, w, u, state)
    out = gather(out.transpose(1, 2).reshape(B, T, -1), tp, d)
    out = rmsnorm(out, p["ln_x"], cfg.norm_eps) * g
    return linear(out, p["wo"]), new_state, x[:, -1]


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


def _embed(params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"][tokens.to(torch.int64)].to(getattr(torch, cfg.dtype))


def _head(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Final norm and the LM head as a float32 product of compute-dtype
    values: float32 logits.  The head is rounded to the compute dtype here,
    unless the params hold it so already as ``lm_head_f32`` (the serving
    engine's copy, so that no step casts it)."""
    x = rmsnorm(x, params["ln_final"], cfg.norm_eps)
    head = params.get("lm_head_f32")
    if head is None:
        head = params["lm_head"].to(x.dtype).to(torch.float32)
    return gather(x.to(torch.float32) @ head, params.get("tp"),
                  cfg.vocab_size)


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, **_):
    """Whole-sequence logits: tokens (B, T) -> (logits (B, T, V) float32,
    aux 0.0).  Each layer's WKV recurrence is ``ops.rwkv6`` from a zero
    state (the CUDA kernel on the card).  The logits are rounded to the
    compute dtype before their float32 convert, as the JAX package's
    compiled forward does.  Each layer runs under the config's
    ``parallel.remat`` (``layers.remat``; "dots" is "full" here, as in the
    reference), which changes no value or gradient."""
    x = _embed(params, tokens, cfg)
    layer = remat(lambda x, p: _block(p, x, cfg)[0], cfg.parallel.remat,
                  policy=False)
    at = layer_views(params["blocks"])
    for i in range(params["blocks"]["ln_tm"].shape[0]):
        x = layer(x, at(i))
    logits = _head(params, x, cfg)
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
