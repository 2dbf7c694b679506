"""Production serving engine for the lm family (its dense, MoE and
cross-attention members, gemma2's windowed layers and softcaps included),
the rwkv family, the hymba family and the encoder-decoder family: float
weights, batched prefill and greedy decode, in torch.

The JAX package's ``ServeEngine`` compiles each request into two programs
(one bucketed block prefill, one scan-fused decode loop).  The port runs
the same math eagerly:

  generate()    one prefill of the whole prompt body through
                ``api.prefill_bucketed`` (for lm a block prefill whose
                attention is the flash kernel on the card, one launch per
                layer, and a VLM's cross blocks one more per group; for
                rwkv, hymba and encdec one ``decode_step`` per prompt
                token, as in the JAX package), then a Python loop of
                ``api.decode_step`` on the dense cache in lockstep
                (``fused=True``, one host sync at the end); ``fused=False``
                feeds the prompt one ``decode_step`` per token and syncs
                every token, as the reference's stepwise loop does.  A VLM
                or encoder-decoder config takes a ``frontend`` (stub
                modality embeddings), from which ``api.init_cache``
                projects the cross K/V once per call (encdec's encoder
                runs there); such configs are served through
                ``generate()`` only, as in the JAX package.

  slot protocol ``init_slot_cache`` / ``prefill_slot`` / ``insert_slot`` /
                ``decode_slots`` / ``rebuild`` for the continuous-batching
                scheduler: a B=1 prefill per admitted request, written into
                its slot, and ONE masked batched decode step per token.
                With ``page_size`` the lm slot cache is a page pool behind a
                host-owned page table and decode attends through the table
                with the paged kernel (``paged_attn="inplace"``); without
                it, and for rwkv, whose recurrent state has nothing that
                grows with the sequence, a dense ``(max_slots, ...)`` cache
                (the JAX package's dense fallback).  Which cache leaves
                page is found by diffing two ``max_len`` builds: a windowed
                layer's ring (gemma2's local layers, ``window < max_len``)
                stays dense and slot-private beside the paged global
                layers, and a prompt longer than the ring takes the
                per-token prefill.  Hymba's K/V page only where the window
                covers ``max_len`` plus a page (else they stay a dense
                ring); its SSM state is always a dense slot leaf, frozen
                where a slot does not write, so its prefix index is a
                no-op and ``rebuild()`` restores the state by re-prefill.

  features      the scheduler's chunked prefill (``new_request_cache`` /
                ``prefill_chunk_slot``: the lm block chunk path through
                ``ops.chunk_attention``, or per-token decode steps for a
                ring or rwkv), shared-prefix reuse (``prefix_cache="on"``:
                radix-matched pages mapped into the slot, the tail
                prefilled from ``seed_request_cache``, copy-on-write before
                a shared page is written), the ``"gather"`` decode
                discipline, and int8 / fp8 page pools (``kv_dtype``), whose
                pages are quantized on write and dequantized by the paged
                kernel; a request cache's completed pages are fake-quantized
                after each prefill so that what it attends to is what the
                pool stores.

Caches are updated IN PLACE where the JAX package returned new ones, and a
prefill runs over the true prompt length: eager PyTorch compiles nothing
per width, so nothing is padded to a power-of-two bucket (pool contents
past a slot's ``len`` then differ from the reference's garbage, and nothing
reads them).  The MoE configs are the exception: their FFN couples the
rows of a call (the capacity and its order of claim depend on every row),
so for them the engine feeds the reference's rows exactly -- the prompt
body zero-padded to its bucket in a ``max_len`` request cache, whose
padding K/V reach the pool's last page and the scratch page as there, and
``generate()``'s batch padded to its bucket with copies of row 0.  The
float weights are cast once to the compute dtype (the JAX package casts
them at every use; the values are the same); the embedding stays float32
and is gathered, then cast.  The TrafficMeter replays eq.
7-10 bytes per active token, as the reference does on one device.

  tp            tensor-parallel serving (``tp=``, a ``TPGroup`` of the
                ranks that run this engine, one process each): every rank
                builds the engine over its shard of the weights (the serve
                rules of ``distributed/sharding.py``: column blocks of the
                up-projections, of the head and of the recurrent inputs,
                the down-projections whole), its KV state cut on heads
                where both head counts divide (else whole), and runs the
                same scheduler on the same requests; the gathers of
                ``pin_tp_exact`` before every whole product, and of the
                logits, keep the ranks' tokens equal to one device's.  The
                meter logs each crossing once per shard at ``width / tp``
                (``traffic_shards``), so its totals do not change; the
                pool's ``kv_shards`` says whether its KV heads are cut.
                Every config serves under TP, through ``generate()`` (its
                cache, cross K/V included, from ``api.init_cache(tp=)``)
                and, where the reference allows it, the slot protocol.  A
                MoE config's experts and router stay whole on every rank
                (the column-only cut drops the expert cut), so each rank
                runs the whole ``moe_apply`` on the whole hidden, which the
                head-cut attention gathers before ``wo``: its padding and
                drops are the same on every rank.  A VLM's cross blocks and
                an encoder-decoder's attention are cut on heads like the
                self-attention.  A scheduler over a TP engine decides by
                one loop clock for the group, rank 0's (``TPGroup.clock``).
                Under ``parallel.decode_attn="shard_map"`` the dense K/V
                leaves (``SEQ_CUT`` of the family) are cut on the sequence
                instead (``sharding.seq_group``): a rank holds every KV
                head of its block of positions, and the dense decode
                combines the ranks' partials by log-sum-exp.  The page
                pool keeps its head cut, so the gather discipline moves its
                view to the sequence cut for the step and back, and a
                request cache to the pool's layout at its insert; in-place
                paging is refused under the knob, as in the reference.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import exact_matmuls, resolve_device
from repro_torch.core.splitbrain import TrafficMeter, TrafficModel
from repro_torch.distributed import sharding
from repro_torch.models import api
from repro_torch.serve import pages as pages_mod
from repro_torch.serve import slots as slots_mod
from repro_torch.serve.errors import InvalidRequestError


class ServeEngine(pages_mod.PagedEngineMixin):
    """Greedy serving of an lm-family (dense, MoE or cross-attention), an
    rwkv, a hymba or an encoder-decoder config with float weights."""

    def __init__(self, cfg: ModelConfig, params, max_len: int = 128,
                 fused: bool = True, page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 paged_attn: str = "inplace", prefix_cache: str = "off",
                 kv_dtype: str = "bf16", device="cuda", tp=None):
        family = api.family_module(cfg)     # raises for an unported family
        self.device = resolve_device(device)
        # one rank is the one-device engine, exactly
        self.tp = tp if tp is not None and tp.size > 1 else None
        if self.tp is not None:
            check_tp(cfg, self.tp, self.device)
        if self.device.type == "cuda":
            # the card's tokens equal the CPU's only under these settings
            exact_matmuls()
        self.cfg = cfg
        # slot decode runs requests at ragged positions: the lockstep cache
        # write of generate() is wrong there
        self._ragged_cfg = dataclasses.replace(
            cfg, parallel=dataclasses.replace(cfg.parallel,
                                              aligned_decode=False))
        # the rank's shard (the whole tree on one device), then the
        # serving copy of it
        self.params = family.serve_params(
            sharding.shard_params(params, self.tp), cfg, self.device)
        if self.tp is not None:
            self.params["tp"] = self.tp
        # the group over which the dense K/V caches are cut on their
        # sequence (parallel.decode_attn="shard_map" at tp > 1), the leaves
        # so cut, and whether the pool's layout cuts their KV heads
        self._seq_leaves = getattr(family, "SEQ_CUT", ())
        self._seq = (sharding.seq_group(cfg, self.tp) if self._seq_leaves
                     else None)
        self._kv_cut = (self.tp is not None
                        and cfg.num_kv_heads % self.tp.size == 0)
        self.max_len = max_len
        self.fused = fused
        # the MoE FFN couples a call's rows: feed the reference's padding
        self._pad_rows = bool(cfg.moe)
        self.meter = TrafficMeter()
        self._traffic = TrafficModel.for_config(cfg)
        self._ba = family.BATCH_AXES
        self._sa = self._slot_seq_axes(page_size or 8)
        # the paging options; int8 / fp8 pages quantize on write and are
        # dequantized at the paged kernel's page fetch
        self._set_paging(page_size, num_pages, paged_attn, prefix_cache,
                         kv_dtype)
        # the lm block chunk path needs every cache slot linear (no ring)
        self._chunk_block_ok = (
            cfg.family == "lm" and not cfg.cross_attn_every
            and all(sp.window is None or sp.window >= max_len
                    for sp in cfg.layer_pattern))

    def _slot_seq_axes(self, delta: int):
        """Per-leaf sequence axis (-1 = does not page), by diffing the
        shapes of two cache builds ``delta`` apart in ``max_len``: every
        K/V leaf of the lm family but a ring capped at its window (gemma2's
        local layers), no rwkv leaf."""
        meta = torch.device("meta")
        a = api.init_cache(self.cfg, 2, self.max_len, device=meta)
        b = api.init_cache(self.cfg, 2, self.max_len + delta, device=meta)
        return pages_mod.seq_axes(a, b, delta)

    # ----------------------------------------------------- traffic accounting
    @property
    def traffic_shards(self) -> int:
        """How many ways the boundary-traffic accounting splits per token:
        the TP degree when every counted width (d_model, kv_dim, vocab)
        divides by it, else 1 (an approximate split would break the
        exactness of the totals)."""
        tp, tm = sharding.size_of(self.tp), self._traffic
        if (tp > 1 and tm.d_model % tp == 0 and tm.kv_dim % tp == 0
                and tm.vocab_size % tp == 0):
            return tp
        return 1

    def meter_tokens(self, n: int) -> None:
        """Replay ``n`` active tokens' boundary crossings on the meter, in
        the reference's aggregate form (same names, same eq. 7-10 widths,
        bytes == n * TrafficModel.bytes_per_token()): one entry per model
        shard at ``width / traffic_shards``."""
        n = int(n)
        if n <= 0:
            return
        tm = self._traffic
        shards = self.traffic_shards
        for _ in range(shards):
            self.meter.h2d("x_qkv_in", (n, tm.num_layers,
                                        tm.d_model // shards))
            self.meter.d2h("kv_out", (n, tm.num_layers, 2,
                                      tm.kv_dim // shards))
            self.meter.h2d("attn_in", (n, tm.num_layers,
                                       tm.d_model // shards))
            self.meter.d2h("logits", (n, tm.vocab_size // shards))

    def measured_bytes(self, count_q: bool = False) -> Dict[str, int]:
        """Total metered boundary bytes (paper accounting: K/V + attention +
        logits; ``count_q=True`` adds the QKV input activations)."""
        return self.meter.measured_bytes(count_q)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(np.asarray(tokens, np.int32),
                               device=self.device)

    def _body(self, prompts: np.ndarray):
        """The prompt bodies ``prompts[:, :-1]`` as the prefill takes them:
        as they are, or for a row-coupled (MoE) config zero-padded to the
        reference's power-of-two bucket, whose padding rows then go
        through the same FFN calls as there."""
        body = prompts[:, :-1]
        if not self._pad_rows:
            return body
        width = slots_mod.bucket(body.shape[1])
        return np.pad(body, ((0, 0), (0, width - body.shape[1])))

    def _relayout(self, tree, fn):
        """``tree`` with its sequence-cut K/V leaves (``self._seq_leaves``)
        passed through ``fn`` (``sharding.seq_to_heads`` or
        ``heads_to_seq``): between the dense decode step's sequence layout
        and the head layout of the page pool and its request caches."""
        out = dict(tree)
        for name in self._seq_leaves:
            if name in tree:
                e = tree[name]
                conv = [fn(t, self._seq, self._kv_cut)
                        for t in pages_mod._leaves(e)]
                out[name] = conv if isinstance(e, list) else conv[0]
        return out

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # --------------------------------------------------------------- generate
    def generate(self, prompts: np.ndarray, max_new: int = 16,
                 frontend=None, fused: Optional[bool] = None,
                 eos_id: Optional[int] = None) -> Dict[str, Any]:
        """Greedy-decode a batch. prompts: (B, T0) int32.

        ``frontend``: (B, Tx, d) stub modality embeddings (array or
        tensor, taken as float32) of a VLM or encoder-decoder config, from
        which the cache's cross K/V are projected once.
        ``eos_id``: per-request stop token.  Output rows are padded with
        ``eos_id`` past each request's stop, and ``gen_len`` reports the
        exact generated length (EOS inclusive, capped at ``max_new``).
        On tensor-parallel ranks every rank calls it with the same
        arguments; the cache is the rank's (``api.init_cache(tp=)``).
        """
        if fused is None:
            fused = self.fused
        cfg = self.cfg
        prompts = np.asarray(prompts, np.int32)
        B, T0 = prompts.shape
        if frontend is not None:
            frontend = (frontend.to(self.device, torch.float32)
                        if torch.is_tensor(frontend) else torch.as_tensor(
                            np.asarray(frontend, np.float32),
                            device=self.device))
        if fused and self._pad_rows:
            # the reference pads the batch to its bucket with copies of
            # row 0; the MoE FFN sees those rows too
            Bb = slots_mod.bucket(B)
            prompts = np.concatenate(
                [prompts, np.broadcast_to(prompts[:1], (Bb - B, T0))])
        if T0 - 1 + max_new > self.max_len:
            raise ValueError(
                f"request does not fit the cache: prompt_len={T0} + "
                f"max_new={max_new} needs {T0 - 1 + max_new} positions but "
                f"max_len={self.max_len}")
        cache = api.init_cache(cfg, prompts.shape[0], self.max_len,
                               frontend=frontend, params=self.params,
                               device=self.device, tp=self.tp)
        if not fused:
            return self._generate_stepwise(cache, prompts, max_new, eos_id)
        toks = self._tokens(prompts)
        tp0 = time.perf_counter()
        if T0 > 1:
            # one prefill fills the cache with the whole prompt body
            _, cache = api.prefill_bucketed(self.params, cache,
                                            self._tokens(self._body(prompts)),
                                            T0 - 1, cfg)
        self._sync()
        prefill_s = time.perf_counter() - tp0
        tok = toks[:, -1]
        alive = torch.ones_like(tok, dtype=torch.bool)
        n = torch.zeros_like(tok)
        out = []
        t0 = time.perf_counter()
        for _ in range(max_new):
            logits, cache = api.decode_step(self.params, cache, tok, cfg)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            n += alive.to(torch.int32)
            if eos_id is None:
                tok = nxt
            else:
                tok = torch.where(alive, nxt, torch.full_like(nxt, eos_id))
                alive &= tok != eos_id
            out.append(tok)
        tokens = (torch.stack(out, dim=1).cpu().numpy()[:B] if out
                  else np.zeros((B, 0), np.int32))
        dt = time.perf_counter() - t0
        gen_len = np.minimum(n.cpu().numpy()[:B], max_new)
        self.meter_tokens(B * (T0 - 1) + int(gen_len.sum()))
        return {"tokens": tokens, "gen_len": gen_len,
                "tokens_per_s": int(gen_len.sum()) / dt if dt else 0.0,
                "decode_s": dt, "prefill_s": prefill_s}

    def _generate_stepwise(self, cache, prompts: np.ndarray, max_new: int,
                           eos_id: Optional[int] = None):
        """Reference loop: one decode step per token, prompt included, and a
        host sync per generated token.  Finished rows keep stepping in
        lockstep but emit (and are fed) ``eos_id``; the loop breaks once
        every row has stopped, padding the remainder."""
        cfg = self.cfg
        B, T0 = prompts.shape
        tp0 = time.perf_counter()
        for t in range(1, T0):
            _, cache = api.decode_step(self.params, cache,
                                       self._tokens(prompts[:, t - 1]), cfg)
        self._sync()
        prefill_s = time.perf_counter() - tp0
        tok = prompts[:, -1]
        out = []
        alive = np.ones((B,), bool)
        gen_len = np.zeros((B,), np.int32)
        t0 = time.perf_counter()
        for _ in range(max_new):
            logits, cache = api.decode_step(self.params, cache,
                                            self._tokens(tok), cfg)
            emitted = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
            gen_len += alive
            if eos_id is not None:
                emitted = np.where(alive, emitted, eos_id).astype(np.int32)
                alive &= emitted != eos_id
            tok = emitted
            out.append(emitted)
            if eos_id is not None and not alive.any():
                break
        dt = time.perf_counter() - t0
        while len(out) < max_new:
            out.append(np.full((B,), eos_id, np.int32))
        tokens = (np.stack(out, axis=1) if out
                  else np.zeros((B, 0), np.int32))
        self.meter_tokens(B * (T0 - 1) + int(gen_len.sum()))
        return {"tokens": tokens, "gen_len": gen_len,
                "tokens_per_s": int(gen_len.sum()) / dt if dt else 0.0,
                "decode_s": dt, "prefill_s": prefill_s}

    # ---------------------------------------------------------- slot protocol
    # Consumed by serve/scheduler.py: slot i is row i of the slot cache, at
    # its own ragged position.
    def init_slot_cache(self, n_slots: int) -> Dict[str, Any]:
        """A fresh slot cache for ``n_slots`` concurrent streams: a page pool
        (and a reset host pager) with ``page_size``, else the dense
        ``(n_slots, ...)`` cache.  A VLM or encoder-decoder config is
        refused, as the JAX package refuses it: its requests carry a
        frontend that the slot protocol has no place for.  So is in-place
        paging under ``parallel.decode_attn="shard_map"`` where paging
        engages (the reference's refusal and message); a family that never
        pages keeps its dense slot cache."""
        if self.cfg.frontend_tokens or self.cfg.cross_attn_every:
            raise ValueError(
                "continuous batching covers the text-only families "
                "(frontend_tokens / cross-attention configs are not "
                "slot-servable)")
        ba, sa = self._ba, self._sa
        like = api.init_cache(self.cfg, n_slots, self.max_len,
                              device=torch.device("meta"))
        if not self._paging_active:
            self._note_slot_cache(n_slots, like, ba, sa)
            if self._kv_dtype != "bf16":
                raise ValueError(
                    f"kv_dtype={self._kv_dtype!r} requires a paging family: "
                    f"no cache leaf of this config scales with max_len, so "
                    f"there is no page pool to quantize")
            return self._rank_cache(n_slots, self.max_len)
        if (self._paged_attn == "inplace"
                and self.cfg.parallel.decode_attn == "shard_map"):
            # the reference's refusal, where paging engages: the paged
            # decode has no sequence-cut variant
            raise ValueError(
                "paged_attn='inplace' does not support "
                "parallel.decode_attn='shard_map' (the page pool is not "
                "sequence-sharded); serve this config with "
                "paged_attn='gather' or the dense slot cache")
        pool = self._pager.reset(n_slots)
        pcache, kv_shards = pages_mod.make_rank_pool(
            like, ba, sa, pool.num_pages, self.page_size, self.device,
            self._kv_dtype, self.tp)
        self._note_slot_cache(n_slots, like, ba, sa, kv_shards)
        return pcache

    def _rank_cache(self, batch: int, max_len: int, device=None):
        """A zeroed dense cache of ``batch`` rows as this rank holds it
        (``api.init_cache(tp=)``)."""
        return api.init_cache(self.cfg, batch, max_len,
                              device=self.device if device is None else device,
                              tp=self.tp)

    def _stats_seq_axes(self):
        return self._sa

    def rebuild(self, n_slots: int) -> Dict[str, Any]:
        """Re-materialise the device-side KV state from host state after a
        device fault: a fresh slot cache and a reset host pager.  The
        weights are immutable and stay."""
        return self.init_slot_cache(n_slots)

    def prefill_slot(self, prompt: np.ndarray):
        """Prefill ONE request into a fresh B=1 dense cache.

        prompt (T0,) -> (cache with len = T0 - 1, input token of the first
        decode step): one prefill over the true prompt body.  On the
        paged layout the cache holds just the body's pages (the insert
        scatters those); the dense slot cache takes a ``max_len`` row.  A
        row-coupled (MoE) config prefills the body zero-padded to its
        bucket in a ``max_len`` cache on both layouts (:meth:`_body`): the
        block prefill when the bucket fits ``max_len``, else the per-token
        steps, as the reference chooses."""
        prompt = np.asarray(prompt, np.int32)
        T0 = prompt.shape[0]
        if T0 < 1:
            raise InvalidRequestError(
                "prefill_slot needs a non-empty prompt (the last token "
                "seeds decoding)")
        S = (pages_mod.round_len(T0 - 1, self.page_size)
             if self._paging_active and not self._pad_rows else self.max_len)
        cache = self._rank_cache(1, S)
        if T0 > 1:
            _, cache = api.prefill_bucketed(
                self.params, cache, self._tokens(self._body(prompt[None])),
                T0 - 1, self.cfg)
            self._fake_quant_b1(cache)
        return cache, int(prompt[-1])

    def _fake_quant_b1(self, cache):
        """Round-trip the completed pages of a B=1 request cache through the
        page quantizer, in place (``pages.fake_quant_tree``), when the pool
        is quantized: the prefill's values become exactly what the pool
        will store, so the tokens that follow do not depend on whether a
        page came from this prefill or from the prefix cache."""
        if self._kv_dtype != "bf16":
            if self._seq is None:
                pages_mod.fake_quant_tree(cache, int(cache["len"][0]),
                                          self._sa, self.page_size,
                                          self._kv_dtype)
                return cache
            # pages are quantized in the pool's head layout
            heads = self._relayout(cache, sharding.seq_to_heads)
            pages_mod.fake_quant_tree(heads, int(cache["len"][0]), self._sa,
                                      self.page_size, self._kv_dtype)
            back = self._relayout(heads, sharding.heads_to_seq)
            for name in self._seq_leaves:
                for t, b in zip(pages_mod._leaves(cache[name]),
                                pages_mod._leaves(back[name])):
                    t.copy_(b)
        return cache

    def new_request_cache(self):
        """A fresh, empty B=1 ``max_len`` cache for chunked prefill."""
        return self._rank_cache(1, self.max_len)

    def seed_request_cache(self, cache, slot: int, cached_len: int):
        """The prefix-aware prefill entry: a B=1 request cache holding the
        slot's matched prefix pages gathered (dequantized) from the pool,
        ``len = cached_len``; the tail chunks continue from there."""
        like = self._rank_cache(1, self.max_len, torch.device("meta"))
        seed = self.paged_seed(cache, slot, cached_len, self._ba, self._sa,
                               like)
        # the pool's head layout as the request cache's sequence layout
        return (seed if self._seq is None
                else self._relayout(seed, sharding.heads_to_seq))

    def prefill_chunk_slot(self, cache, chunk: np.ndarray, true_w: int):
        """Advance a B=1 request cache by one right-padded prompt chunk, in
        place: chunk (W,), of which the first ``true_w`` tokens are real.
        The lm family with linear caches takes the block chunk path, with
        ``ops.chunk_attention`` over absolute positions; a ring (gemma2's
        local layers) or rwkv's recurrent state takes the per-token decode
        steps.  A quantized pool's completed pages are then fake-quantized,
        as after ``prefill_slot``."""
        chunk = np.asarray(chunk, np.int32)
        pages_mod.check_chunk_width(chunk.shape[0], self.max_len)
        cache = api.prefill_chunk(self.params, cache,
                                  self._tokens(chunk[None, :]), int(true_w),
                                  self.cfg, block=self._chunk_block_ok)
        return self._fake_quant_b1(cache)

    def insert_slot(self, batched_cache, slot_cache, slot: int):
        """Write a prefilled B=1 request cache into slot ``slot``, in place:
        on the paged layout the host allocates the slot's pages first and
        the K/V is scattered page block by page block; the dense layout
        copies it into the slot's row."""
        if not self._paging_active:
            return slots_mod.insert_slot(batched_cache, slot_cache, slot,
                                         self._ba)
        n_tok = int(slot_cache["len"][0])
        if self._seq is not None:
            slot_cache = self._relayout(slot_cache, sharding.seq_to_heads)
        return self.paged_insert(batched_cache, slot_cache, slot,
                                 self._ba, self._sa, n_tok)

    def decode_slots(self, cache, tokens, active, corrupt=None):
        """One masked batched decode step: every slot computes, only
        ``active`` slots write K/V and advance ``len``.  Returns
        ``(next_tokens, ok, cache)`` as host arrays plus the cache (updated
        in place): ``ok`` is the per-slot finite-logits sentinel, and
        ``corrupt`` (optional ``(n,)`` bool) NaN-poisons the flagged slots'
        logits before the argmax (the fault-injection hook).  The tokens and
        the sentinel come back in ONE device-to-host copy.

        Paged layout: the host copies any copy-on-write page and allocates
        any page the step writes into; then ``paged_attn="inplace"``
        appends each active slot's token to its page and attends through
        the table (``api.paged_decode_step``), while ``"gather"`` runs the
        dense decode step on the gathered view and scatters the new token
        back."""
        n = int(np.asarray(tokens).shape[0])
        act = np.asarray(active, bool)
        bad = (np.zeros((n,), bool) if corrupt is None
               else np.asarray(corrupt, bool))
        tok_d = self._tokens(tokens)
        act_d = torch.as_tensor(act, device=self.device)
        if self._paging_active:
            cache = self.paged_pre_step(cache, act, self._ba, self._sa)
            table = self._pager.table()
            if self._paged_attn == "inplace":
                logits, cache = api.paged_decode_step(
                    self.params, cache, table, tok_d, self._ragged_cfg,
                    write=act_d, seq_axes=self._sa)
            else:
                # the gather discipline: the dense view through the table,
                # the family's dense decode step on it, then each active
                # slot's one new token scattered back into its page
                view = pages_mod.gather_tree(cache, table, self._ba, self._sa)
                pos = view["len"].clone()
                if self._seq is None:
                    logits, view = api.decode_step(
                        self.params, view, tok_d, self._ragged_cfg,
                        write=act_d)
                else:
                    # the step on the view in its sequence layout, then
                    # back: the rings are the pool's own leaves
                    seq_view = self._relayout(view, sharding.heads_to_seq)
                    logits, seq_view = api.decode_step(
                        self.params, seq_view, tok_d, self._ragged_cfg,
                        write=act_d)
                    back = self._relayout(seq_view, sharding.seq_to_heads)
                    for name in self._seq_leaves:
                        for t, b, s_ax in zip(
                                pages_mod._leaves(view[name]),
                                pages_mod._leaves(back[name]),
                                pages_mod._leaf_axes(self._sa[name],
                                                     view[name])):
                            if s_ax < 0:
                                t.copy_(b)
                    view = back
                pages_mod.scatter_token_tree(cache, view, table, pos, act_d,
                                             self._ba, self._sa)
            self._pager.post_decode(act)
        else:
            self._meter_kv_read(act)
            logits, cache = api.decode_step(self.params, cache, tok_d,
                                            self._ragged_cfg, write=act_d)
        logits = slots_mod.corrupt_logits(
            logits, torch.as_tensor(bad, device=self.device))
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        ok = slots_mod.finite_logits(logits).to(torch.int32)
        host = torch.stack([nxt, ok]).cpu().numpy()
        return host[0], host[1].astype(bool), cache


def check_tp(cfg: ModelConfig, tp, device) -> None:
    """Tensor-parallel serving covers every config of the registry on the
    rank's own device, the sequence-cut dense decode
    (``parallel.decode_attn="shard_map"``) included."""
    dev = torch.device(device)
    if dev.type != tp.device.type or dev.index not in (None,
                                                       tp.device.index):
        raise ValueError(f"engine device {device} is not the rank's "
                         f"device {tp.device}")
