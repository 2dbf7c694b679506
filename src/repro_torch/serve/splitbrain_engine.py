"""Split-Brain serving engine — the paper's §IV-B protocol, in torch.

Decoding is partitioned into:

  device_phase  — the ITA ASIC: stateless, LAQ-quantized linear projections
                  (QKV, wo, SwiGLU w1/w3/w2, LM head) through the W4A8 op.
  host_phase    — KV-cache append, attention (the dynamic-state op), residual
                  adds, norm statistics, sampling.

As in the JAX package, both phases run in one program on one device (here
the GPU): the labels survive as the TrafficMeter's accounting of every
tensor that crosses the boundary, replayed per token so the measured
interface bytes equal the analytical TrafficModel (eq. 7-10) to the byte.

The port is eager PyTorch: a Python loop over the layers, tensors updated
IN PLACE where the JAX package returned new arrays (K/V append into
``pool[l]`` / ``cache[l]``; prefill loops over the true prompt length only),
so no step copies a cache.  With ``page_size`` set, the slot cache is a page
pool behind a host-owned page table and decode attends through the table
with the paged flash-decode op (``paged_attn="inplace"``) or through the
gathered dense view (``"gather"``); without it, the dense (L, n_slots, Hkv,
max_len, hd) cache.  The scheduler's chunked prefill runs the token step
from whatever state a B=1 request cache holds, a prefix hit seeds that
cache from the pool's shared pages (``prefix_cache="on"``, copy-on-write
before a shared page is written), and an int8 / fp8 pool (``kv_dtype``)
quantizes pages on write, the request cache's completed pages
fake-quantized after each prefill so that it attends to what the pool
stores.

``generate()`` is the paper's own entry point: prompt forcing plus greedy
decode through the same per-token step on a dense cache.  The JAX package
runs it as one jitted ``lax.scan`` (``jit=True``) or as its eager
reference loop (``jit=False``); the port compiles nothing, and ``fused``
picks between the same two behaviours: one Python loop with a single host
sync and the meter replayed per active token, or the stepwise loop that
syncs every token and meters every executed step for the whole batch.
The scheduler's steps (``prefill_slot``, ``decode_slots``) always follow
the numerics of the reference's compiled programs, which the JAX package
jits whatever ``jit`` says; ``decode_token`` is always the eager loop.

Tensor-parallel serving (``tp=``, a ``TPGroup``): every rank quantizes the
whole model (LAQ's per-channel codes and scales do not depend on the cut),
keeps its column blocks of ``wq`` / ``wk`` / ``wv`` / ``w1`` / ``w3`` and of
the head, each packed once for the W4A8 kernel at ``(K, N / tp)``, and
holds ``wo`` / ``w2`` whole (the serve rules' column-only cut; the JAX
package gives this engine the Megatron row cuts, whose exact cross-rank
sum would need the kernel's int32 partial sums).  A column block of the
kernel's output is bit-identical to the full product's columns, and the
activations are gathered before each whole product and the logits after
the head, so every rank's tokens are one device's.  The KV state is cut on
heads where both head counts divide; the meter logs each crossing once per
shard at ``width / tp`` (``traffic_shards``), so the bytes per token are
one device's.  Under TP the engine serves through the slot protocol and
``generate()`` (fused and eager), every rank called with the same
arguments, with the same launches per token step as one device.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.quant import QuantizedLinear
from repro_torch.core.splitbrain import TrafficMeter, TrafficModel
from repro_torch.distributed import sharding
from repro_torch.kernels import ops
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.serve import pages as pages_mod
from repro_torch.serve import slots as slots_mod
from repro_torch.serve.engine import check_tp


def traffic_model_for(cfg: ModelConfig) -> TrafficModel:
    return TrafficModel.for_config(cfg)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, QuantizedLinear):
        return tree.to(device)
    if torch.is_tensor(tree):
        return tree.to(device)
    return tree


def _stack_layers(tree, num_layers: int):
    """Collapse the (n_groups, group_size, ...) leading dims to (L, ...)."""
    if isinstance(tree, dict):
        return {k: _stack_layers(v, num_layers) for k, v in tree.items()}
    if isinstance(tree, QuantizedLinear):
        return QuantizedLinear(*(
            None if t is None else t.reshape((num_layers,) + t.shape[2:])
            for t in (tree.codes, tree.scales, tree.packed)))
    return tree.reshape((num_layers,) + tree.shape[2:])


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _float_weights(tree, dtype):
    """Float (quantize=False) device weights, cast once to the compute
    dtype (the JAX package casts at every use; the values are the same)."""
    if isinstance(tree, dict):
        return {k: _float_weights(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


class SplitBrainEngine(pages_mod.PagedEngineMixin):
    """Greedy decoding with an explicit host/device boundary."""

    _SLOT_AXES = {"k": 1, "v": 1, "len": 0}
    _SEQ_AXES = {"k": 3, "v": 3, "len": -1}

    def __init__(self, cfg: ModelConfig, params, max_len: int = 256,
                 quantize: bool = True, page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 paged_attn: str = "inplace", prefix_cache: str = "off",
                 kv_dtype: str = "bf16", fused: bool = True, device="cuda",
                 tp=None):
        if cfg.family != "lm" or len(cfg.layer_pattern) != 1:
            raise ValueError(
                "split-brain engine covers the paper's LM configs")
        if cfg.moe:
            raise ValueError("split-brain engine covers dense FFNs")
        self.device = resolve_device(device)
        # one rank is the one-device engine, exactly
        self.tp = tp if tp is not None and tp.size > 1 else None
        if self.tp is not None:
            check_tp(cfg, self.tp, self.device)
        self._cut = sharding.head_cut(self.tp, cfg.num_heads,
                                      cfg.num_kv_heads)
        self.cfg = cfg
        self.meter = TrafficMeter()
        self.max_len = max_len
        self.fused = fused
        self._hd = cfg.resolved_head_dim
        self._dtype = getattr(torch, cfg.dtype)
        self._n_layers = cfg.num_layers
        params = _to(params, self.device)
        # The "synthesis" step: weights become immutable INT4 codes.
        blocks = params["blocks"]
        dev = {"attn": blocks["attn"], "mlp": blocks["mlp"]}
        head = params.get("lm_head")
        if quantize:
            dev = api.quantize_model(dev, cfg)
            head = api.quantize_model({"lm_head": head}, cfg)["lm_head"]
        else:
            dev = _float_weights(dev, self._dtype)
            head = head.to(self._dtype)
        stacked = _stack_layers(
            {**dev, "ln_attn": blocks["ln_attn"], "ln_mlp": blocks["ln_mlp"]},
            cfg.num_layers)
        # the rank's column blocks (the whole tree on one device), packed
        shard = sharding.shard_params({"layers": stacked, "head": head},
                                      self.tp)
        stacked, head = (api.pack_model(shard["layers"]),
                         api.pack_model(shard["head"]))
        # per-layer views, built once: the hot loop only indexes a list
        self._layers = [_layer(stacked, i) for i in range(cfg.num_layers)]
        self._embed = params["embed"]         # host-side float table
        self._ln_final = params["ln_final"]
        self._head = head
        # the paging options; int8 / fp8 pages quantize on write and are
        # dequantized at the paged kernel's page fetch
        self._set_paging(page_size, num_pages, paged_attn, prefix_cache,
                         kv_dtype)

    # ------------------------------------------------------------ accounting
    @property
    def traffic_shards(self) -> int:
        """How many ways the boundary-traffic accounting splits per token:
        the TP degree when every counted width (d_model, Hkv, Hq, vocab)
        divides by it, else 1."""
        cfg, tp = self.cfg, sharding.size_of(self.tp)
        if (tp > 1 and cfg.d_model % tp == 0 and cfg.num_kv_heads % tp == 0
                and cfg.num_heads % tp == 0 and cfg.vocab_size % tp == 0):
            return tp
        return 1

    def _meter_token(self, batch: int) -> None:
        """Replay one token's boundary crossings on the meter: per layer the
        QKV input (h2d), K and V out (d2h) and the attention output in
        (h2d); then the logits out (d2h), each once per model shard at
        ``width / traffic_shards``.  Names, order and sizes are those of
        the JAX package's meter, so its totals are eq. 7-10's."""
        cfg = self.cfg
        s = self.traffic_shards
        for _ in range(self._n_layers):
            for _ in range(s):
                self.meter.h2d("x_qkv_in", (batch, 1, cfg.d_model // s))
                self.meter.d2h("kv_out", (2, batch, cfg.num_kv_heads // s,
                                          1, self._hd))
                self.meter.h2d("attn_in", (batch, 1,
                                           cfg.num_heads * self._hd // s))
        for _ in range(s):
            self.meter.d2h("logits", (batch, 1, cfg.vocab_size // s))

    def meter_tokens(self, n: int) -> None:
        """Replay ``n`` active tokens' boundary crossings (scheduler hook)."""
        if int(n) > 0:
            self._meter_token(int(n))

    def measured_bytes_per_token(self, batch: int = 1,
                                 count_q: bool = False) -> Dict[str, int]:
        """Per-token boundary bytes from the meter (per sequence);
        ``count_q=False`` is the paper's accounting."""
        tot = self.meter.measured_bytes(count_q)
        return {k: v // batch for k, v in tot.items()}

    # --------------------------------------------------------------- hot path
    def _layer_sweep(self, pos: torch.Tensor, token: torch.Tensor,
                     kv_attend, compiled: bool = False) -> torch.Tensor:
        """The shared per-token body: embed, then per layer pre-norm ->
        DEVICE QKV -> rope -> ``kv_attend`` (cache append + attention, the
        ONLY point the dense and paged disciplines differ) -> DEVICE wo ->
        residual -> norm -> DEVICE FFN -> residual; final norm, DEVICE head.
        Returns the logits (B, V).

        ``compiled=True`` follows the JAX package's jitted programs (the
        generate scan, the scheduler's prefill and decode steps) rather
        than its eager loop: XLA's excess-precision rule keeps the
        attention residual sum in float32 into the FFN's pre-norm (the
        residual stream itself is rounded), as in the ServeEngine's
        ``transformer._block_tail``, and the activation quantizer's scale
        is ``amax`` times the reciprocal of 127."""
        cfg = self.cfg
        B = token.shape[0]
        hd = self._hd
        # HOST: embedding lookup in float32, then the compute dtype
        x = self._embed[token.to(torch.int64)][:, None, :].to(self._dtype)
        positions = pos[:, None]
        for i, p in enumerate(self._layers):
            xn = L.rmsnorm(x, p["ln_attn"], cfg.norm_eps)
            q, k, v = L.qkv_project(p["attn"], xn, cfg.num_heads,
                                    cfg.num_kv_heads, hd, compiled, self.tp)
            q = L.rope(q, positions, cfg.rope_theta)
            k = L.rope(k, positions, cfg.rope_theta)
            attn = kv_attend(i, q, k, v)
            attn = sharding.gather(attn.transpose(1, 2).reshape(B, 1, -1),
                                   self.tp, cfg.num_heads * hd)
            o = L.linear(attn, p["attn"]["wo"], compiled)
            if compiled:
                s = x.to(torch.float32) + o.to(torch.float32)
                x = s.to(x.dtype)
                y = L.rmsnorm(s, p["ln_mlp"], cfg.norm_eps).to(x.dtype)
            else:
                x = x + o
                y = L.rmsnorm(x, p["ln_mlp"], cfg.norm_eps)
            x = x + L.swiglu(y, p["mlp"]["w1"], p["mlp"]["w3"], p["mlp"]["w2"],
                             compiled, self.tp)
        x = L.rmsnorm(x, self._ln_final, cfg.norm_eps)
        return sharding.gather(L.linear(x, self._head, compiled)[:, 0],
                               self.tp, cfg.vocab_size)

    def _token_step(self, k_cache, v_cache, length, token,
                    compiled: bool = False,
                    write: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One token against the dense cache (L, B, Hkv, S, hd), appended in
        place at ``length`` (clamped to the last position, where the JAX
        package's slice update clamps too).  ``write`` (B,) bool keeps the
        rows where it is False as they were.  Returns the logits; the
        caller advances ``len``.  ``compiled``: as in :meth:`_layer_sweep`."""
        pos = length
        cache_len = pos + 1
        idx = torch.clamp(pos, max=k_cache.shape[3] - 1)

        def kv_attend(i, q, k, v):
            kc, vc = k_cache[i], v_cache[i]
            L.cache_write(kc, k, idx, aligned=False, write=write)
            L.cache_write(vc, v, idx, aligned=False, write=write)
            return ops.decode_attention(q, kc, vc, cache_len,
                                        softcap=self.cfg.softcap)

        return self._layer_sweep(pos, token, kv_attend, compiled)

    def _paged_token_step(self, k_pool, v_pool, table, length, token,
                          write: torch.Tensor) -> torch.Tensor:
        """One token computed THROUGH the page pool
        (L, num_pages, page_size, Hkv, hd): each active slot's K/V is
        appended in place to its page (inactive slots land on scratch), and
        attention walks the page table with the paged flash-decode op.
        Returns the logits; the caller advances ``len``."""
        pos = length
        cache_len = (pos + 1).to(torch.int32)

        def kv_attend(i, q, k, v):
            kc, vc = k_pool[i], v_pool[i]
            L.paged_cache_write(kc, k, table, pos, write)
            L.paged_cache_write(vc, v, table, pos, write)
            return ops.paged_decode_attention(q, kc, vc, table, cache_len,
                                              softcap=self.cfg.softcap,
                                              tp=self.tp, head_cut=self._cut)

        return self._layer_sweep(pos, token, kv_attend, compiled=True)

    def _tokens(self, token) -> torch.Tensor:
        """``token`` as an int32 tensor on the engine's device: a tensor
        (``decode_token``'s own ``next_tok``, on any device) is moved, not
        read through numpy."""
        if torch.is_tensor(token):
            return token.to(device=self.device, dtype=torch.int32)
        return torch.as_tensor(np.asarray(token, np.int32), device=self.device)

    # --------------------------------------------------------------- decoding
    def init_cache(self, batch: int) -> Dict[str, torch.Tensor]:
        """Dense KV cache: (L, B, Hkv, S, hd) K and V, (B,) int32 lengths;
        under tensor parallelism the rank's cut of it
        (``sharding.rank_cache``)."""
        return sharding.rank_cache(self._cache_like(batch), self.tp,
                                   self.device)

    def decode_token_eager(self, cache: Dict[str, torch.Tensor], token):
        """One token through the split-brain loop on the dense cache, which
        is updated in place: the per-layer loop with the meter logging
        every boundary crossing.  token: (B,).  Returns
        (next_tok, logits, cache)."""
        token = self._tokens(token)
        self._meter_token(token.shape[0])
        logits = self._token_step(cache["k"], cache["v"], cache["len"], token)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        cache["len"] = cache["len"] + 1
        return next_tok, logits, cache

    # ``decode_token_eager`` is the JAX package's name for this step;
    # ``decode_token`` is the port's name for it since the first slice,
    # which its callers and tests use.  The JAX package's ``decode_token``
    # with ``jit=True`` is the same step compiled; the port compiles
    # nothing, so both names hold the eager step.
    decode_token = decode_token_eager

    def generate(self, prompts, max_new: int = 16,
                 eos_id: Optional[int] = None) -> Dict[str, Any]:
        """Greedy-decode a batch. prompts: (B, T0) int32.

        The prompt is teacher-forced through the per-token step (filling
        the dense cache), then ``max_new`` tokens free-run, in one Python
        loop with one host sync at its end, with the numerics of the JAX
        package's jitted scan (``_layer_sweep(compiled=True)``);
        ``fused=False`` runs :meth:`_generate_stepwise`, its eager loop.
        ``eos_id`` enables per-request stop
        tokens: rows pad with ``eos_id`` past each stop, ``gen_len``
        reports exact generated lengths, and the meter replays boundary
        bytes per ACTIVE token only (every prompt-forcing step for the
        whole batch).  ``decode_s`` / ``tokens_per_s`` cover prompt and
        decode, as in the JAX package."""
        prompts = np.asarray(prompts, np.int32)
        B, T0 = prompts.shape
        if T0 - 1 + max_new > self.max_len:
            raise ValueError(
                f"request does not fit the cache: prompt_len={T0} + "
                f"max_new={max_new} needs {T0 - 1 + max_new} positions but "
                f"max_len={self.max_len}")
        if not self.fused:
            return self._generate_stepwise(prompts, max_new, eos_id)
        cache = self.init_cache(B)
        toks = self._tokens(prompts)
        tok = toks[:, 0]
        alive = torch.ones((B,), dtype=torch.bool, device=self.device)
        n = torch.zeros((B,), dtype=torch.int32, device=self.device)
        out = []
        t0 = time.perf_counter()
        for t in range(T0 - 1 + max_new):
            logits = self._token_step(cache["k"], cache["v"], cache["len"],
                                      tok, compiled=True)
            cache["len"] += 1
            if t + 1 < T0:               # teacher-force the prompt
                tok = toks[:, t + 1]
                continue
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            n += alive.to(torch.int32)
            if eos_id is None:
                tok = nxt
            else:
                tok = torch.where(alive, nxt, torch.full_like(nxt, eos_id))
                alive &= tok != eos_id
            out.append(tok)
        tokens = (torch.stack(out, dim=1).cpu().numpy() if out
                  else np.zeros((B, 0), np.int32))
        dt = time.perf_counter() - t0
        gen_len = np.minimum(n.cpu().numpy(), max_new)
        for _ in range(T0 - 1):
            self._meter_token(B)
        for t in range(max_new):
            a = int((gen_len > t).sum())
            if a:
                self._meter_token(a)
        return {"tokens": tokens, "gen_len": gen_len, "cache": cache,
                "tokens_per_s": int(gen_len.sum()) / dt if dt else 0.0,
                "decode_s": dt}

    def _generate_stepwise(self, prompts: np.ndarray, max_new: int,
                           eos_id: Optional[int] = None) -> Dict[str, Any]:
        """Token-at-a-time reference generation: :meth:`decode_token_eager`
        per token with a host sync per generated token.  Finished rows emit
        and are fed ``eos_id``; the loop breaks once every row has stopped
        and pads the rest.  The meter logs every executed step for the
        whole batch, as the JAX package's eager loop does."""
        B, T0 = prompts.shape
        cache = self.init_cache(B)
        tok = prompts[:, 0]
        outs = []
        alive = np.ones((B,), bool)
        gen_len = np.zeros((B,), np.int32)
        t0 = time.perf_counter()
        for t in range(1, T0):
            _, _, cache = self.decode_token_eager(cache, tok)
            tok = prompts[:, t]
        for _ in range(max_new):
            nxt, _, cache = self.decode_token_eager(cache, tok)
            emitted = nxt.cpu().numpy()
            gen_len += alive
            if eos_id is not None:
                emitted = np.where(alive, emitted, eos_id).astype(np.int32)
                alive &= emitted != eos_id
            tok = emitted
            outs.append(emitted)
            if eos_id is not None and not alive.any():
                break
        dt = time.perf_counter() - t0
        while len(outs) < max_new:
            outs.append(np.full((B,), eos_id, np.int32))
        tokens = np.stack(outs, 1) if outs else np.zeros((B, 0), np.int32)
        return {"tokens": tokens, "cache": cache, "gen_len": gen_len,
                "tokens_per_s": int(gen_len.sum()) / dt if dt else 0.0,
                "decode_s": dt}

    def _cache_like(self, batch: int) -> Dict[str, torch.Tensor]:
        """Shapes and dtypes of the whole model's dense (L, B, Hkv, S, hd)
        cache, as meta tensors (no allocation)."""
        cfg = self.cfg
        shape = (cfg.num_layers, batch, cfg.num_kv_heads, self.max_len,
                 self._hd)
        meta = torch.device("meta")
        return {"k": torch.empty(shape, dtype=self._dtype, device=meta),
                "v": torch.empty(shape, dtype=self._dtype, device=meta),
                "len": torch.empty((batch,), dtype=torch.int32, device=meta)}

    # ---------------------------------------------------------- slot protocol
    # Consumed by serve/scheduler.py: slot i is row i of the slot cache, at
    # its own ragged position.  With ``page_size`` its K/V live in a shared
    # page pool behind a host-owned page table; without it the slot cache
    # is the dense (L, n_slots, Hkv, max_len, hd) cache.
    def init_slot_cache(self, n_slots: int) -> Dict[str, torch.Tensor]:
        like = self._cache_like(n_slots)
        ba, sa = self._SLOT_AXES, self._SEQ_AXES
        if not self._paging_active:
            self._note_slot_cache(n_slots, like, ba, sa)
            return self.init_cache(n_slots)
        pool = self._pager.reset(n_slots)
        pcache, kv_shards = pages_mod.make_rank_pool(
            like, ba, sa, pool.num_pages, self.page_size, self.device,
            self._kv_dtype, self.tp)
        self._note_slot_cache(n_slots, like, ba, sa, kv_shards)
        return pcache

    def _stats_seq_axes(self):
        return self._SEQ_AXES

    def rebuild(self, n_slots: int) -> Dict[str, torch.Tensor]:
        """Re-materialise the device-side KV state from host state after a
        device fault: a fresh slot cache and a reset host pager.  The
        weights are immutable and stay."""
        return self.init_slot_cache(n_slots)

    def _prefill_tokens(self, cache, tokens: np.ndarray) -> None:
        """Feed ``tokens`` through the token step from whatever state the
        B=1 cache holds (the compiled numerics), then, for a quantized pool,
        fake-quantize its completed pages so that what later tokens attend
        to is what the pool stores."""
        if len(tokens):
            body = self._tokens(tokens)
            for t in range(len(tokens)):
                self._token_step(cache["k"], cache["v"], cache["len"],
                                 body[t:t + 1], compiled=True)
                cache["len"] += 1
        if self._kv_dtype != "bf16":
            pages_mod.fake_quant_tree(cache, int(cache["len"][0]),
                                      self._SEQ_AXES, self.page_size,
                                      self._kv_dtype)

    def prefill_slot(self, prompt: np.ndarray):
        """Prefill ONE request into a fresh B=1 dense cache.

        prompt (T0,) -> (cache with len = T0-1, input token of the first
        decode step).  The loop runs over the true prompt length only, so
        nothing past it is computed or written."""
        prompt = np.asarray(prompt, np.int32)
        cache = self.init_cache(1)
        if prompt.shape[0] > 1:
            self._prefill_tokens(cache, prompt[:-1])
        return cache, int(prompt[-1])

    def new_request_cache(self) -> Dict[str, torch.Tensor]:
        """A fresh, empty B=1 cache for chunked prefill."""
        return self.init_cache(1)

    def seed_request_cache(self, cache, slot: int, cached_len: int):
        """The prefix-aware prefill entry: a B=1 request cache holding the
        slot's matched prefix pages gathered (dequantized) from the pool,
        ``len = cached_len``; the tail chunks continue from there."""
        like = sharding.rank_cache(self._cache_like(1), self.tp,
                                   torch.device("meta"))
        return self.paged_seed(cache, slot, cached_len, self._SLOT_AXES,
                               self._SEQ_AXES, like)

    def prefill_chunk_slot(self, cache: Dict[str, torch.Tensor],
                           chunk: np.ndarray, true_w: int):
        """Advance a B=1 request cache by one right-padded prompt chunk, in
        place: the token step over the chunk's ``true_w`` real tokens from
        whatever state the cache holds (the JAX package scans its prefill
        program over the padded width with the state frozen past
        ``true_w``), then the fake-quant of a quantized pool."""
        chunk = np.asarray(chunk, np.int32)
        pages_mod.check_chunk_width(chunk.shape[0], self.max_len)
        self._prefill_tokens(cache, chunk[:int(true_w)])
        return cache

    def insert_slot(self, batched_cache, slot_cache, slot: int):
        """Write a prefilled B=1 request cache into slot ``slot``, in place:
        on the paged layout the host allocates the slot's pages first and
        the K/V is scattered page block by page block; the dense layout
        copies it into the slot's row."""
        if not self._paging_active:
            return slots_mod.insert_slot(batched_cache, slot_cache, slot,
                                         self._SLOT_AXES)
        n_tok = int(slot_cache["len"][0])
        return self.paged_insert(batched_cache, slot_cache, slot,
                                 self._SLOT_AXES, self._SEQ_AXES, n_tok)

    def decode_slots(self, cache: Dict[str, torch.Tensor], tokens, active,
                     corrupt=None):
        """One masked batched split-brain token step: every slot computes,
        only ``active`` slots append K/V and advance ``len``.  Returns
        ``(next_tokens, ok, cache)`` as host arrays plus the cache (updated
        in place): ``ok`` is the per-slot finite-logits sentinel, and
        ``corrupt`` (optional ``(n,)`` bool) NaN-poisons the flagged slots'
        logits before the argmax (the fault-injection hook).  The tokens and
        the sentinel come back in ONE device-to-host copy, the step's only
        sync.

        Paged layout: the host copies any copy-on-write page and allocates
        the page each append lands in; ``paged_attn="inplace"`` appends and
        attends through the page table, ``"gather"`` runs the dense token
        step on the gathered view and scatters each active slot's new token
        back.  Dense layout: the token step on the slot cache itself."""
        n = int(np.asarray(tokens).shape[0])
        act = np.asarray(active, bool)
        bad = (np.zeros((n,), bool) if corrupt is None
               else np.asarray(corrupt, bool))
        tok_d = self._tokens(tokens)
        act_d = torch.as_tensor(act, device=self.device)
        ba, sa = self._SLOT_AXES, self._SEQ_AXES
        if not self._paging_active:
            self._meter_kv_read(act)
            logits = self._token_step(cache["k"], cache["v"], cache["len"],
                                      tok_d, compiled=True, write=act_d)
        else:
            cache = self.paged_pre_step(cache, act, ba, sa)
            table = self._pager.table()
            if self._paged_attn == "inplace":
                logits = self._paged_token_step(cache["k"], cache["v"], table,
                                                cache["len"], tok_d, act_d)
            else:
                view = pages_mod.gather_tree(cache, table, ba, sa)
                pos = cache["len"].clone()
                logits = self._token_step(view["k"], view["v"], pos, tok_d,
                                          compiled=True)
                pages_mod.scatter_token_tree(cache, view, table, pos, act_d,
                                             ba, sa)
            self._pager.post_decode(act)
        cache["len"] += act_d.to(torch.int32)
        logits = slots_mod.corrupt_logits(
            logits, torch.as_tensor(bad, device=self.device))
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        ok = slots_mod.finite_logits(logits).to(torch.int32)
        host = torch.stack([nxt, ok]).cpu().numpy()
        return host[0], host[1].astype(bool), cache
