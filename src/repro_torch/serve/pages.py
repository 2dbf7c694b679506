"""Paged KV-cache plumbing: a shared page pool behind the slot protocol.

The paper's Split-Brain protocol (§IV-B) makes the host the sole owner of
dynamic KV state; this module is the host's memory manager.  Instead of
pinning a full ``(max_slots, ..., max_len, ...)`` cache per slot, every
sequence-growing cache leaf is re-laid-out as a *page pool*

    dense leaf  (..., B, ..., S, ...)          S = max_len
    pool  leaf  (..., num_pages, page_size, ...)

plus one per-slot *page table* ``(max_slots, max_len // page_size)`` of
physical page ids, owned by :class:`PagePool` (plain numpy — no device sync
on the allocation path).  Pages are allocated as a sequence grows and
returned to the free list when its request finishes.

The pool layout keeps the layer axis leading and drops the
``(num_pages, page_size)`` axes exactly where the batch axis sat
(:func:`page_axis`), so the split-brain cache ``(L, B, Hkv, S, hd)`` pages
into ``(L, num_pages, page_size, Hkv, hd)`` and ``pool[l]`` is the
``(num_pages, page_size, Hkv, hd)`` operand the paged attention kernel
takes.  Physical page 0 is the scratch page: table entries past a slot's
allocation and the writes of inactive slots land there, and attention
never reads it for a valid position.

``PagePool`` and ``HostPager`` are a numpy copy of the JAX package's, radix
prefix index and copy-on-write included.  The device-side helpers work on
plain dicts of tensors, or of lists of tensors (the lm cache's
per-pattern-slot leaves ``(n_groups, gs // P, B, Hkv, S, hd)`` page into
``(n_groups, gs // P, num_pages, page_size, Hkv, hd)``), and write the pool
IN PLACE: the in-place append and the insert, the gather discipline's dense
view and one-token writeback, the prefix seed and the copy-on-write page
copy.  An int8 / fp8 pool holds a ``QuantizedLeaf`` (codes plus
per-(page, KV head) scales) for each paging leaf; pages are quantized on
write (``layers.quant_page_append``) and dequantized where they are read.
"""
from __future__ import annotations

import copy
import hashlib
import math
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.quant import KV_DTYPES, QuantizedLeaf
from repro_torch.distributed import sharding
from repro_torch.models.layers import (SCRATCH_PAGE, byte_view,
                                       fake_quant_pages, kv_pow2_scale,
                                       kv_quantize, page_offsets,
                                       quant_page_append)
from repro_torch.serve.errors import PageLifecycleError, ReservationError

__all__ = [
    "PagePool",
    "HostPager",
    "PagedEngineMixin",
    "QuantizedLeaf",
    "check_chunk_width",
    "check_kv_dtype",
    "round_len",
    "seq_axes",
    "page_axis",
    "pool_shape",
    "make_pool",
    "gather_view",
    "gather_tree",
    "scatter_token",
    "scatter_token_tree",
    "insert_tree",
    "fake_quant_tree",
    "pool_bytes",
    "page_token_bytes",
    "kv_token_bytes",
    "kv_token_bytes_quant",
    "SCRATCH_PAGE",
]


def round_len(n: int, *quanta: Optional[int]) -> int:
    """Round a cache length up so every given quantum (page size, prefill
    chunk width) tiles it exactly -- a common multiple of them all."""
    q = math.lcm(*(int(x) for x in quanta if x))
    return -(-int(n) // q) * q


# ----------------------------------------------------------------------------
# Host-side allocator (numpy only — the host owns the dynamic state)
# ----------------------------------------------------------------------------
class PagePool:
    """Ref-counted free-list page allocator with copy-on-write semantics and
    a radix-style token-block-hash prefix index.

    Lifecycle (DESIGN.md §7): ``try_admit(slot, n_tokens, matched)`` claims
    the worst-case count of NEW pages for a request at admission time and
    maps any ``matched`` prefix pages into the slot's table (refcount++,
    zero prefill work for them); ``ensure(slot, n_tokens)`` then draws
    private pages lazily as the sequence actually grows, which therefore
    never fails — under pressure a draw evicts the least-recently-released
    refcount-0 index page instead of failing.  ``free_slot`` decrements
    every mapped page's refcount; pages that hit zero return to the free
    list, unless they are published in the prefix index, in which case they
    stay resident (and matchable) until evicted.

    The prefix index is a chained block hash
    ``key = H(parent_key, page_token_ids)`` -> physical page, which is a
    flat encoding of a radix tree over token blocks: matching walks the
    chain page by page from the root and stops at the first miss, so a
    lookup is O(matched pages) regardless of how many prefixes are stored.

    Sharing invariant: a page with ``refcount > 1``, or one still published
    in the index, is IMMUTABLE.  Writers (the decode append landing inside
    a fully-matched last page) must call :meth:`cow_page` first, which
    either hands back a private copy target (refcount>1 → the caller copies
    the device bytes src→dst) or retires the index entry when the writer is
    the sole owner (write-in-place, no copy).

    Admission safety: with ``pinned`` = distinct pages referenced by >= 1
    slot, ``R`` = outstanding worst-case new-page reservations and ``D`` =
    pages already drawn under them, admission maintains
    ``pinned + (R - D) <= capacity`` — so free + evictable pages always
    cover every future draw and ``ensure`` cannot fail mid-decode.

    ``double_free`` selects the free-after-free policy: ``"raise"``
    (default) raises ValueError, ``"ignore"`` makes it a no-op.
    Reserve-after-free of the same slot is the normal lifecycle and always
    works; reserve-after-reserve (without a free between) raises.
    """

    _ROOT_KEY = b"radix-root"

    def __init__(self, num_pages: int, page_size: int, n_slots: int,
                 slot_pages: int, double_free: str = "raise"):
        if num_pages < 2:
            raise ValueError(f"num_pages must be >= 2 (page {SCRATCH_PAGE} "
                             f"is the reserved scratch page), got {num_pages}")
        if double_free not in ("raise", "ignore"):
            raise ValueError(f"double_free must be 'raise' or 'ignore', "
                             f"got {double_free!r}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.slot_pages = int(slot_pages)
        self.double_free = double_free
        # logical->physical map; unallocated entries hit the scratch page
        self.table = np.full((n_slots, slot_pages), SCRATCH_PAGE, np.int32)
        self._free = list(range(num_pages - 1, SCRATCH_PAGE, -1))
        self._n_alloc = np.zeros(n_slots, np.int64)
        self._matched = np.zeros(n_slots, np.int64)  # leading SHARED pages
        self._reserved = np.zeros(n_slots, np.int64)  # worst-case NEW pages
        self._drawn = np.zeros(n_slots, np.int64)     # new pages drawn so far
        self._live = np.zeros(n_slots, bool)
        self.refcount = np.zeros(num_pages, np.int32)
        self._index: Dict[bytes, int] = {}            # block-hash -> page
        self._published: Dict[int, bytes] = {}        # page -> its index key
        # refcount-0 published pages, oldest-released first (eviction order)
        self._evictable: "OrderedDict[int, None]" = OrderedDict()
        self.total_reserved = 0
        self.total_drawn = 0
        self.pages_in_use = 0         # pinned pages (refcount >= 1), distinct
        self.peak_pages_in_use = 0
        self.pages_allocated = 0      # cumulative private draws (KV stored)
        self.evictions = 0
        self.cow_copies = 0

    @property
    def capacity(self) -> int:
        """Allocatable pages (scratch excluded)."""
        return self.num_pages - 1

    @property
    def cached_pages(self) -> int:
        """Refcount-0 pages kept resident by the prefix index (evictable)."""
        return len(self._evictable)

    @property
    def index_pages(self) -> int:
        """Pages currently published in the prefix index (any refcount)."""
        return len(self._index)

    def pages_for(self, n_tokens: int) -> int:
        return -(-max(int(n_tokens), 0) // self.page_size)

    # ------------------------------------------------------ radix prefix index
    def page_key(self, parent: bytes, tokens: np.ndarray) -> bytes:
        """Chained block hash: one radix-tree edge per full token page."""
        h = hashlib.blake2b(parent, digest_size=16)
        h.update(np.ascontiguousarray(tokens, np.int32).tobytes())
        return h.digest()

    def match_prefix(self, tokens: np.ndarray) -> List[int]:
        """Longest-prefix match of ``tokens`` against the index, in FULL
        pages: walk the hash chain from the root, stop at the first miss.
        Returns the matched physical pages (possibly empty)."""
        ps = self.page_size
        tokens = np.asarray(tokens, np.int32)
        pages: List[int] = []
        key = self._ROOT_KEY
        for p in range(len(tokens) // ps):
            nxt = self.page_key(key, tokens[p * ps:(p + 1) * ps])
            page = self._index.get(nxt)
            if page is None:
                break
            pages.append(page)
            key = nxt
        return pages

    def publish(self, slot: int, tokens: np.ndarray, n_tokens: int) -> int:
        """Publish the slot's completed full pages into the prefix index.

        ``tokens`` are the slot's prompt tokens, ``n_tokens`` how many the
        slot actually holds (its prefilled body).  Only pages FULLY covered
        by ``n_tokens`` are publishable — decode never writes below that
        boundary, so published content is final.  Existing entries win (a
        concurrent identical prefill keeps its pages private).  Returns the
        number of new index entries."""
        ps = self.page_size
        tokens = np.asarray(tokens, np.int32)
        nfull = min(int(n_tokens) // ps, int(self._n_alloc[slot]),
                    len(tokens) // ps)
        key = self._ROOT_KEY
        added = 0
        for p in range(nfull):
            key = self.page_key(key, tokens[p * ps:(p + 1) * ps])
            page = int(self.table[slot, p])
            if key in self._index or page in self._published:
                continue
            self._index[key] = page
            self._published[page] = key
            added += 1
        return added

    def _unpublish(self, page: int) -> None:
        key = self._published.pop(page)
        del self._index[key]
        self._evictable.pop(page, None)

    # --------------------------------------------------------------- admission
    def try_admit(self, slot: int, n_tokens: int,
                  matched: Sequence[int] = (), extra_new: int = 0) -> bool:
        """Admission: map ``matched`` prefix pages into the slot's table
        (refcount++) and claim worst-case NEW pages for the rest.  False if
        the pool cannot take the request right now.  ``extra_new`` reserves
        additional headroom (the CoW copy target when the match covers the
        decode append position)."""
        if self._live[slot]:
            raise PageLifecycleError(
                f"slot {slot} already reserved — reserve/admit must be "
                f"paired with free_slot")
        need_total = self.pages_for(n_tokens)
        matched = list(matched)[:need_total]
        need_new = need_total - len(matched) + int(extra_new)
        if need_total > self.slot_pages:
            return False              # longer than one slot's page table
        newly = sum(1 for p in matched if self.refcount[p] == 0)
        if (self.pages_in_use + newly + self.total_reserved + need_new
                - self.total_drawn > self.capacity):
            return False
        for i, p in enumerate(matched):
            if self.refcount[p] == 0:
                self.pages_in_use += 1
                self._evictable.pop(p, None)
            self.refcount[p] += 1
            self.table[slot, i] = p
        self._n_alloc[slot] = len(matched)
        self._matched[slot] = len(matched)
        self._reserved[slot] = need_new
        self._drawn[slot] = 0
        self._live[slot] = True
        self.total_reserved += need_new
        self.peak_pages_in_use = max(self.peak_pages_in_use,
                                     self.pages_in_use)
        return True

    def try_reserve(self, slot: int, n_tokens: int) -> bool:
        """Claim worst-case pages for a request; False if the pool is full.
        (The no-sharing admission path: ``try_admit`` with no matches.)"""
        return self.try_admit(slot, n_tokens)

    def _take_page(self) -> int:
        """Draw a free page; under pressure, evict the oldest-released
        refcount-0 index page (its content is recomputable by definition —
        it was published from a prompt prefix)."""
        if self._free:
            return self._free.pop()
        page, _ = self._evictable.popitem(last=False)
        self._unpublish(page)
        self.evictions += 1
        return page

    def ensure(self, slot: int, n_tokens: int) -> None:
        """Allocate private pages so the slot can hold ``n_tokens``."""
        need = self.pages_for(n_tokens)
        while self._n_alloc[slot] < need:
            if self._drawn[slot] >= self._reserved[slot]:
                raise ReservationError(
                    f"slot {slot} drew {self._drawn[slot]} of "
                    f"{self._reserved[slot]} reserved pages but needs more "
                    f"— reservation bug")
            page = self._take_page()  # cannot fail: admission invariant
            self.refcount[page] = 1
            self.table[slot, self._n_alloc[slot]] = page
            self._n_alloc[slot] += 1
            self._drawn[slot] += 1
            self.total_drawn += 1
            self.pages_in_use += 1
            self.pages_allocated += 1
        self.peak_pages_in_use = max(self.peak_pages_in_use,
                                     self.pages_in_use)

    def cow_page(self, slot: int, logical: int) -> Optional[Tuple[int, int]]:
        """Make the slot's ``logical`` page writable (the CoW rule).

        refcount > 1 → draw a private target under the slot's reservation
        and return ``(src, dst)``: the caller must copy the device page
        bytes before writing.  Sole owner but still published → retire the
        index entry and write in place (no copy).  Private and unpublished
        → None, nothing to do.
        """
        src = int(self.table[slot, logical])
        if self.refcount[src] > 1:
            if self._drawn[slot] >= self._reserved[slot]:
                raise ReservationError(
                    f"slot {slot} has no reserved page left for the CoW "
                    f"copy of logical page {logical} — admission bug")
            dst = self._take_page()
            self.refcount[dst] = 1
            self.refcount[src] -= 1
            self.table[slot, logical] = dst
            self._drawn[slot] += 1
            self.total_drawn += 1
            self.pages_in_use += 1
            self.pages_allocated += 1
            self.peak_pages_in_use = max(self.peak_pages_in_use,
                                         self.pages_in_use)
            self.cow_copies += 1
            return (src, dst)
        if src in self._published:
            self._unpublish(src)
        return None

    def free_slot(self, slot: int) -> None:
        """Release the slot: decrement every mapped page's refcount and
        return the reservation.  Pages hitting refcount 0 go back to the
        free list unless published — those stay resident in the prefix
        index (evictable under pressure) so later requests can share them.
        """
        if not self._live[slot]:
            if self.double_free == "ignore":
                return
            raise PageLifecycleError(
                f"double free: slot {slot} is not reserved (free_slot "
                f"without a matching try_reserve/try_admit)")
        for i in range(int(self._n_alloc[slot])):
            p = int(self.table[slot, i])
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                self.pages_in_use -= 1
                if p in self._published:
                    self._evictable[p] = None   # resident, matchable, LRU
                else:
                    self._free.append(p)
        self.table[slot, :] = SCRATCH_PAGE
        self._n_alloc[slot] = 0
        self._matched[slot] = 0
        self.total_reserved -= int(self._reserved[slot])
        self.total_drawn -= int(self._drawn[slot])
        self._reserved[slot] = 0
        self._drawn[slot] = 0
        self._live[slot] = False

class HostPager:
    """The host-side paging companion the engine owns when ``page_size`` is
    set: PagePool lifecycle, the per-slot length mirror (so the decode loop
    never syncs ``len`` off the device), admission queries (prefix-matching
    against the pool's radix index when sharing is on), CoW scheduling, and
    the page table's copy on the engine's ``device``.  Every host-side
    decision lives here exactly once.
    """

    def __init__(self, page_size: int, num_pages: Optional[int],
                 max_len: int, device="cuda"):
        self.device = torch.device(device)
        if max_len % page_size != 0:
            raise ValueError(
                f"max_len ({max_len}) must be a multiple of page_size "
                f"({page_size}) so the page table tiles the cache exactly")
        self.page_size = int(page_size)
        self.max_len = int(max_len)
        self.slot_pages = max_len // page_size
        self._num_pages_opt = num_pages
        self.pool: Optional[PagePool] = None
        self.host_len = None
        self._table_dev = None     # device copy, invalidated on table writes
        # prefix sharing: armed by the engine's init_slot_cache when the
        # knob is on AND every dynamic cache leaf actually pages
        self.prefix_on = False
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0

    def reset(self, n_slots: int) -> PagePool:
        """Fresh pool (and prefix index) + length mirror for a new slot
        cache."""
        num_pages = (self._num_pages_opt if self._num_pages_opt is not None
                     else n_slots * self.slot_pages + 1)   # +1: scratch
        self.pool = PagePool(num_pages, self.page_size, n_slots,
                             self.slot_pages)
        self.host_len = np.zeros((n_slots,), np.int64)
        self._table_dev = None
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        return self.pool

    def _tokens_for(self, prompt_len: int, max_new: int) -> int:
        return prompt_len - 1 + max_new

    def try_reserve(self, slot: int, prompt_len: int, max_new: int) -> bool:
        return self.pool.try_reserve(slot,
                                     self._tokens_for(prompt_len, max_new))

    def admit(self, slot: int, prompt: np.ndarray, max_new: int,
              chunk: Optional[int] = None) -> Optional[int]:
        """Admission with radix prefix matching.

        Matches the prompt against the index in full pages, maps the
        matched pages into the slot's table (refcount++) and reserves
        worst-case NEW pages for the rest.  Returns the number of CACHED
        tokens (0 = no reuse), or None when the pool cannot take the
        request right now (the scheduler waits for frees).

        Match capping rules (DESIGN.md §7):
          * a match covering the whole prompt body skips prefill entirely
            (``cached = body``); when it overshoots the body — the full
            prompt including the decode-input token is indexed — the last
            matched page contains the decode append position, so one extra
            page is reserved for its CoW copy;
          * a partial match is rounded DOWN to a multiple of
            ``lcm(page_size, chunk)`` so the tail chunk stream starts
            chunk-aligned (the lm block chunk path writes full fixed-width
            chunks); without chunked prefill (``chunk=None``) only
            whole-body matches are usable, partial ones are dropped.
        """
        prompt = np.asarray(prompt, np.int32)
        body = len(prompt) - 1
        total = self._tokens_for(len(prompt), max_new)
        if not self.prefix_on or body < 1:
            return 0 if self.pool.try_admit(slot, total) else None
        pages = self.pool.match_prefix(prompt)
        m_tok = len(pages) * self.page_size
        cow = 0
        if pages and m_tok >= body:
            cached = body
            cow = 1 if m_tok > body else 0
        elif pages and chunk:
            quantum = math.lcm(self.page_size, int(chunk))
            m_tok = (m_tok // quantum) * quantum
            pages = pages[:m_tok // self.page_size]
            cached = m_tok
        else:
            pages, cached = [], 0
        if not self.pool.try_admit(slot, total, matched=pages,
                                   extra_new=cow):
            return None
        if cached:
            self.prefix_hits += 1
            self.prefix_hit_tokens += cached
            self._table_dev = None
        return cached

    def can_ever_admit(self, prompt_len: int, max_new: int) -> bool:
        """Static capacity check: could this request be admitted into an
        IDLE pool?  False means waiting for frees can never help — the
        scheduler rejects immediately instead of head-of-line blocking.
        (Deliberately prefix-blind: a hit could shrink the new-page need,
        but index contents are transient, so admission stays worst-case.)"""
        need = self.pool.pages_for(self._tokens_for(prompt_len, max_new))
        return need <= min(self.pool.slot_pages, self.pool.capacity)

    def free(self, slot: int) -> None:
        self.pool.free_slot(slot)
        self.host_len[slot] = 0
        self._table_dev = None

    def _ensure(self, slot: int, n_tokens: int) -> None:
        before = self.pool.pages_in_use
        self.pool.ensure(slot, n_tokens)
        if self.pool.pages_in_use != before:
            self._table_dev = None

    def note_insert(self, slot: int, n_tokens: int) -> None:
        """Allocate the admitted prompt's pages, mirror its length."""
        self._ensure(slot, n_tokens)
        self.host_len[slot] = n_tokens

    def publish(self, slot: int, prompt: np.ndarray) -> int:
        """Publish the slot's completed full prefill pages (positions below
        its prefilled body) into the prefix index.  No-op when prefix
        sharing is off."""
        if not self.prefix_on:
            return 0
        prompt = np.asarray(prompt, np.int32)
        return self.pool.publish(slot, prompt, int(self.host_len[slot]))

    def pre_decode(self, active: np.ndarray) -> List[Tuple[int, int]]:
        """Make every active slot's append position writable and allocated.

        Each active slot writes at position ``len``: if that position falls
        inside a SHARED or published page (a whole-prompt prefix hit), the
        CoW rule fires first — returns the ``(src, dst)`` physical page
        pairs whose device bytes the engine must copy before dispatching
        the step.  Then allocates any fresh page the step grows into."""
        copies: List[Tuple[int, int]] = []
        for s in np.flatnonzero(active):
            pos = int(self.host_len[s])
            pi = pos // self.page_size
            if pi < int(self.pool._n_alloc[s]):
                op = self.pool.cow_page(int(s), pi)
                if op is not None:
                    copies.append(op)
                    self._table_dev = None
            self._ensure(s, pos + 1)
        return copies

    def post_decode(self, active: np.ndarray) -> None:
        self.host_len[active] += 1


    def table(self) -> torch.Tensor:
        """int32 copy of the page table on the engine's device, uploaded
        again only when a table entry actually changed (steady-state decode
        reuses it)."""
        if self._table_dev is None:
            self._table_dev = torch.as_tensor(self.pool.table,
                                              device=self.device)
        return self._table_dev

    def row(self, slot: int) -> torch.Tensor:
        return torch.as_tensor(self.pool.table[slot], device=self.device)

    def insert_row(self, slot: int) -> torch.Tensor:
        """Table row for the slot's insert: matched prefix entries are
        redirected to the scratch page, so the B=1 request cache's blocks
        land only on the slot's private pages (the shared prefix pages
        already hold what the seed gathered from them)."""
        row = self.pool.table[slot].copy()
        row[:int(self.pool._matched[slot])] = SCRATCH_PAGE
        return torch.as_tensor(row, device=self.device)


# ----------------------------------------------------------------------------
# Pool layout (dicts of tensors, or of lists of tensors such as the lm
# cache's per-pattern-slot K/V leaves).  ``ba`` names each entry's batch
# axis, shared by every tensor of a list; ``sa`` each leaf's sequence axis,
# -1 where the leaf does not page: an int for a tensor entry, a list of
# ints for a list entry (an int there applies to every tensor of the list).
# A paging leaf of an int8 / fp8 pool is a QuantizedLeaf.
# ----------------------------------------------------------------------------
def _leaves(entry):
    return entry if isinstance(entry, list) else [entry]


def _leaf_axes(ax, entry):
    """The sequence axis of each tensor of ``entry``."""
    return list(ax) if isinstance(ax, list) else [ax] * len(_leaves(entry))


def _map(fn, tree, ba, sa, *others):
    """``fn(leaf, b_ax, s_ax, *other_leaves)`` over every leaf of a cache
    dict, keeping its dict / list structure."""
    out = {}
    for name, entry in tree.items():
        rows = zip(_leaves(entry), _leaf_axes(sa[name], entry),
                   *(_leaves(o[name]) for o in others))
        res = [fn(leaf, ba[name], s_ax, *rest) for leaf, s_ax, *rest in rows]
        out[name] = res if isinstance(entry, list) else res[0]
    return out


def _nbytes(t) -> int:
    return (t.nbytes if isinstance(t, QuantizedLeaf)
            else t.numel() * t.element_size())


def check_kv_dtype(kv_dtype: str, page_size) -> str:
    """Validate the engines' ``kv_dtype`` knob: quantized pools exist only
    in the paged layout (their scales are per page), so anything but
    "bf16" needs ``page_size``."""
    if kv_dtype not in ("bf16",) + tuple(KV_DTYPES):
        raise ValueError(
            f"kv_dtype must be one of 'bf16', "
            f"{', '.join(repr(k) for k in KV_DTYPES)}, got {kv_dtype!r}")
    if kv_dtype != "bf16" and page_size is None:
        raise ValueError(
            f"kv_dtype={kv_dtype!r} quantizes the PAGE pool (per-page "
            f"scales) — pass page_size to enable the paged layout")
    return kv_dtype


def check_chunk_width(width: int, max_len: int) -> None:
    """Chunk writes must never spill past the cache end: W | max_len plus
    the full-width feeding order (``transformer.prefill_chunk``'s
    precondition) keep every chunk inside the buffer."""
    if max_len % width != 0:
        raise ValueError(
            f"chunk width {width} must divide max_len ({max_len}) so "
            f"chunk writes never spill past the cache end")


def seq_axes(cache_a: Dict[str, object], cache_b: Dict[str, object],
             delta: int) -> Dict[str, object]:
    """Per-leaf sequence axes, -1 where a leaf does not page, found by
    diffing the same family cache built with two ``max_len`` values
    ``delta`` apart (``meta`` tensors are fine): a leaf pages only if
    exactly one axis grew, by exactly ``delta``.  A ring buffer capped at
    its window, recurrent state and ``len`` stay dense (-1).  A list entry
    gets a list."""
    def axis(a, b):
        diffs = [i for i, (x, y) in enumerate(zip(a.shape, b.shape))
                 if x != y]
        if len(diffs) == 1 and b.shape[diffs[0]] - a.shape[diffs[0]] == delta:
            return diffs[0]
        return -1

    return {name: ([axis(a, b) for a, b in zip(ea, cache_b[name])]
                   if isinstance(ea, list) else axis(ea, cache_b[name]))
            for name, ea in cache_a.items()}


def page_axis(b_ax: int, s_ax: int) -> int:
    """Leading axis of the ``(num_pages, page_size)`` pair in a pool leaf:
    every non-(B, S) axis keeps its dense order and the page axes drop in
    where the batch axis sat."""
    return b_ax - (1 if 0 <= s_ax < b_ax else 0)


def pool_shape(shape: Sequence[int], b_ax: int, s_ax: int, num_pages: int,
               page_size: int) -> Tuple[int, ...]:
    rest = tuple(d for i, d in enumerate(shape) if i not in (b_ax, s_ax))
    pax = page_axis(b_ax, s_ax)
    return rest[:pax] + (num_pages, page_size) + rest[pax:]


def make_pool(cache_like: Dict[str, object], ba: Dict[str, int],
              sa: Dict[str, object], num_pages: int, page_size: int,
              device, kv_dtype: str = "bf16") -> Dict[str, object]:
    """Allocate the paged slot cache: pool layout for paging leaves, dense
    ``(max_slots, ...)`` zeros for the rest (a ring slot's K/V stays
    slot-private).  ``cache_like`` holds tensors (``meta`` ones are fine),
    or lists of them, with the dense cache's shapes and dtypes.  With
    ``kv_dtype`` "int8" / "fp8" each paging leaf is a ``QuantizedLeaf``:
    codes in the pool layout and float32 scales of the pool shape without
    its ``page_size`` axis and trailing head_dim axis."""
    def alloc(like, b_ax, s_ax):
        shape = tuple(like.shape)
        if s_ax < 0:
            return torch.zeros(shape, dtype=like.dtype, device=device)
        shape = pool_shape(shape, b_ax, s_ax, num_pages, page_size)
        if kv_dtype == "bf16":
            return torch.zeros(shape, dtype=like.dtype, device=device)
        pax = page_axis(b_ax, s_ax)
        sc_shape = shape[:pax + 1] + shape[pax + 2:-1]
        return QuantizedLeaf(
            torch.zeros(shape, dtype=KV_DTYPES[kv_dtype], device=device),
            torch.zeros(sc_shape, dtype=torch.float32, device=device),
            kv_dtype, like.dtype)

    return _map(alloc, cache_like, ba, sa)


def _pages_leading(pool: torch.Tensor, b_ax: int, s_ax: int) -> torch.Tensor:
    """A VIEW of a pool leaf (or of its codes) with the (num_pages,
    page_size) axes leading; fp8 codes are viewed as their bytes."""
    pax = page_axis(b_ax, s_ax)
    return torch.movedim(byte_view(pool), (pax, pax + 1), (0, 1))


def _scales_leading(scales: torch.Tensor, b_ax: int,
                    s_ax: int) -> torch.Tensor:
    """A VIEW of a scale array with its page axis leading (scales have no
    page_size axis)."""
    return torch.movedim(scales, page_axis(b_ax, s_ax), 0)


def pool_bytes(pcache: Dict[str, object], sa: Dict[str, object]) -> int:
    """Resident bytes of the paging leaves, codes and scales of a quantized
    pool included."""
    return sum(_nbytes(t) for name, e in pcache.items()
               for t, s_ax in zip(_leaves(e), _leaf_axes(sa[name], e))
               if s_ax >= 0)


def page_token_bytes(pcache: Dict[str, object], sa: Dict[str, object],
                     num_pages: int, page_size: int) -> int:
    """Pool bytes per token position (``num_pages * page_size`` of them),
    summed over the paging leaves."""
    return pool_bytes(pcache, sa) // (int(num_pages) * int(page_size))


def kv_token_bytes(cache_like: Dict[str, object], ba: Dict[str, int],
                   sa: Dict[str, object], kv_shards: int = 1) -> int:
    """Per-token-per-slot bytes of the sequence-scaling cache leaves, from
    the DENSE cache shapes (paged or not: the same KV bytes per token).  A
    ring slot's K/V does not grow with the sequence and counts nothing.

    ``kv_shards`` > 1: the bytes of ONE shard of a pool whose KV heads are
    cut that many ways (tensor parallelism), exactly ``total / kv_shards``;
    a total it does not divide raises, since per-shard figures would not
    sum to it."""
    total = 0
    for name, entry in cache_like.items():
        for like, s_ax in zip(_leaves(entry), _leaf_axes(sa[name], entry)):
            if s_ax >= 0:
                n = like.numel() // (like.shape[ba[name]] * like.shape[s_ax])
                total += n * like.element_size()
    kv_shards = int(kv_shards)
    if kv_shards > 1:
        if total % kv_shards != 0:
            raise ValueError(
                f"kv_token_bytes ({total}) not divisible by kv_shards "
                f"({kv_shards}): per-shard accounting would not sum "
                f"exactly; use kv_shards=1 (the replicated fallback)")
        return total // kv_shards
    return total


def make_rank_pool(cache_like: Dict[str, object], ba: Dict[str, int],
                   sa: Dict[str, object], num_pages: int, page_size: int,
                   device, kv_dtype: str, tp) -> Tuple[Dict[str, object], int]:
    """The paged slot cache that a rank of ``tp`` (a ``TPGroup`` or None)
    holds, and the pool's KV-head cut: the whole pool of ``cache_like``
    (the whole model's dense shapes, :func:`make_pool`) cut leaf by leaf as
    ``sharding.pool_cuts`` says (``sharding.rank_zeros``), and
    ``sharding.pool_kv_cut`` of the same cuts.  One device: the whole pool
    and 1."""
    n = sharding.size_of(tp)
    if n == 1:
        return make_pool(cache_like, ba, sa, num_pages, page_size, device,
                         kv_dtype=kv_dtype), 1
    whole = make_pool(cache_like, ba, sa, num_pages, page_size,
                      torch.device("meta"), kv_dtype=kv_dtype)
    cuts = sharding.pool_cuts(whole, sa, n)
    return (sharding.rank_zeros(whole, cuts, tp, device),
            sharding.pool_kv_cut(cuts, sa, n))


def kv_token_bytes_quant(cache_like: Dict[str, object], ba: Dict[str, int],
                         sa: Dict[str, object], page_size: int,
                         kv_dtype: str) -> float:
    """Per-token bytes of the QUANTIZED pool leaves: the 1-byte codes plus
    the per-page x per-KV-head float32 scales spread over ``page_size``
    positions, from the DENSE cache shapes (fractional; the meter rounds)."""
    itemsize = torch.empty((), dtype=KV_DTYPES[kv_dtype]).element_size()
    total = 0.0
    for name, entry in cache_like.items():
        for like, s_ax in zip(_leaves(entry), _leaf_axes(sa[name], entry)):
            if s_ax >= 0:
                n = like.numel() // (like.shape[ba[name]] * like.shape[s_ax])
                total += n * itemsize + (n // like.shape[-1]) * 4.0 / int(
                    page_size)
    return float(total)


def gather_view(pool, table: torch.Tensor, b_ax: int,
                s_ax: int) -> torch.Tensor:
    """Reassemble one paged leaf into its dense ``(..., B, ..., S, ...)``
    view through the page table ``(B, P)`` (a new tensor: the O(B x
    max_len) transient the in-place discipline avoids; the gather
    discipline and the prefix seed only), contiguous in the dense layout:
    the dense token step then reads it as it reads a slot cache (on the
    card a strided view can take another GEMM algorithm, whose last bits
    differ).  A ``QuantizedLeaf`` gathers codes and scales together and
    dequantizes, ``codes * scale`` in float32 rounded once to its
    ``out_dtype``."""
    B, P = table.shape
    idx = table.to(torch.int64)
    if isinstance(pool, QuantizedLeaf):
        cl = _pages_leading(pool.codes, b_ax, s_ax)     # (N, ps, *rest)
        sl = _scales_leading(pool.scales, b_ax, s_ax)   # (N, *rest[:-1])
        g = cl[idx].view(pool.codes.dtype).to(torch.float32)
        gs = sl[idx]                                    # (B, P, *rest[:-1])
        gs = gs.reshape((B, P, 1) + tuple(gs.shape[2:]) + (1,))
        d = (g * gs).to(pool.out_dtype)
        d = d.reshape((B, P * cl.shape[1]) + tuple(cl.shape[2:]))
        return torch.movedim(d, (0, 1), (b_ax, s_ax)).contiguous()
    pl = _pages_leading(pool, b_ax, s_ax)
    g = pl[idx]                                         # (B, P, ps, *rest)
    g = g.reshape((B, P * pl.shape[1]) + tuple(pl.shape[2:]))
    return torch.movedim(g, (0, 1), (b_ax, s_ax)).contiguous()


def gather_tree(pcache: Dict[str, object], table: torch.Tensor,
                ba: Dict[str, int], sa: Dict[str, object]) -> Dict[str, object]:
    """The dense-view cache the family ``decode_step`` takes: paged leaves
    gathered into new tensors, dense leaves (ring K/V, ``len``) passed
    through as the same tensors, so an in-place step on the view updates
    them where they lie."""
    return _map(lambda p, b_ax, s_ax: p if s_ax < 0
                else gather_view(p, table, b_ax, s_ax), pcache, ba, sa)


def _take_token(leaf: torch.Tensor, pos: torch.Tensor, b_ax: int,
                s_ax: int) -> torch.Tensor:
    """Slot b's entry at position ``pos[b]`` of a dense leaf -> (B, *rest)."""
    x = torch.movedim(leaf, (b_ax, s_ax), (0, 1))       # (B, S, *rest)
    rows = torch.arange(x.shape[0], device=x.device)
    # a finished slot's stale position may sit at S; it writes to scratch
    return x[rows, torch.clamp(pos.to(torch.int64), max=x.shape[1] - 1)]


def scatter_token(pool, table: torch.Tensor, new_leaf: torch.Tensor,
                  pos: torch.Tensor, write: torch.Tensor, b_ax: int,
                  s_ax: int) -> None:
    """Write each active slot's token at ``pos[b]`` of the updated dense
    view back into its page, IN PLACE; inactive slots land on the scratch
    page.  A quantized pool takes the same quantize-on-write append as the
    in-place discipline (``layers.quant_page_append``), so both encode pages
    identically."""
    tok = _take_token(new_leaf, pos, b_ax, s_ax)        # (B, *rest)
    ps = pool.shape[page_axis(b_ax, s_ax) + 1]
    page, off = page_offsets(table, pos, write, ps)
    if isinstance(pool, QuantizedLeaf):
        quant_page_append(_pages_leading(pool.codes, b_ax, s_ax).view(
            pool.codes.dtype), _scales_leading(pool.scales, b_ax, s_ax),
            tok, page, off, pool.kv_dtype)
        return
    _pages_leading(pool, b_ax, s_ax)[page, off] = tok.to(pool.dtype)


def scatter_token_tree(pcache: Dict[str, object],
                       new_view: Dict[str, object], table: torch.Tensor,
                       pos: torch.Tensor, write: torch.Tensor,
                       ba: Dict[str, int], sa: Dict[str, object]) -> None:
    """After a decode step on :func:`gather_tree`'s view: each paged leaf
    gets its one new token per active slot scattered into its page (the
    dense leaves were the view's own tensors and are already updated)."""
    _map(lambda p, b_ax, s_ax, n: None if s_ax < 0
         else scatter_token(p, table, n, pos, write, b_ax, s_ax),
         pcache, ba, sa, new_view)


def insert_tree(pcache: Dict[str, object], single: Dict[str, object],
                table_row: torch.Tensor, slot: int, ba: Dict[str, int],
                sa: Dict[str, object], n_tokens: int = 0) -> None:
    """Admit one prefilled B=1 dense cache IN PLACE: paged leaves scatter
    their page blocks to the slot's physical pages (the first entries of
    ``table_row``, as many as the B=1 cache holds pages; excess logical
    pages land on scratch), dense leaves take the slot's row.  A B=1 ring
    sized to a prompt shorter than the slot's ring fills the ring's first
    positions; the rest is written by decode before anything reads it.

    A quantized pool encodes each block under its page's scale; positions
    at or past ``n_tokens`` (the prefilled length) are zeroed first, so
    whatever lies past the prompt never coarsens a page's scale."""
    rows = table_row.to(torch.int64)
    for name, entry in pcache.items():
        b_ax = ba[name]
        for p, s, s_ax in zip(_leaves(entry), _leaves(single[name]),
                              _leaf_axes(sa[name], entry)):
            if s_ax < 0:
                dst = p.narrow(b_ax, slot, 1)
                for ax, n in enumerate(s.shape):
                    dst = dst.narrow(ax, 0, n)
                dst.copy_(s.to(p.dtype))
                continue
            x = torch.movedim(s, (b_ax, s_ax), (0, 1))[0]  # (S, *rest)
            ps = p.shape[page_axis(b_ax, s_ax) + 1]
            blocks = x.reshape((x.shape[0] // ps, ps) + tuple(x.shape[1:]))
            dst = rows[:blocks.shape[0]]
            if not isinstance(p, QuantizedLeaf):
                _pages_leading(p, b_ax, s_ax)[dst] = blocks.to(p.dtype)
                continue
            P = blocks.shape[0]
            pos = torch.arange(P * ps, device=blocks.device).reshape(P, ps)
            valid = (pos < int(n_tokens)).reshape(
                (P, ps) + (1,) * (blocks.dim() - 2))
            blocks = torch.where(valid, blocks.to(torch.float32),
                                 torch.zeros((), dtype=torch.float32,
                                             device=blocks.device))
            amax = blocks.abs().amax(dim=(1, blocks.dim() - 1))
            sc = kv_pow2_scale(amax, p.kv_dtype)        # (P, *rest[:-1])
            q = kv_quantize(blocks, sc.reshape(
                (P, 1) + tuple(sc.shape[1:]) + (1,)), p.kv_dtype)
            _pages_leading(p.codes, b_ax, s_ax)[dst] = byte_view(q)
            _scales_leading(p.scales, b_ax, s_ax)[dst] = sc


def fake_quant_tree(cache: Dict[str, object], n_tokens: int,
                    sa: Dict[str, object], page_size: int,
                    kv_dtype: str) -> Dict[str, object]:
    """Round-trip the completed pages of a dense B=1 request cache through
    the page quantizer, IN PLACE (``layers.fake_quant_pages`` per paging
    leaf; dense leaves untouched).  Both engines apply it after every
    prefill and prefill chunk of a quantized pool, so the chunk stream
    attends to exactly the values insertion will store."""
    for name, entry in cache.items():
        for leaf, s_ax in zip(_leaves(entry), _leaf_axes(sa[name], entry)):
            if s_ax >= 0:
                fake_quant_pages(leaf, s_ax, n_tokens, page_size, kv_dtype)
    return cache


# ----------------------------------------------------------------------------
# Engine hooks
# ----------------------------------------------------------------------------
class PagedEngineMixin:
    """The slot-protocol paging hooks the serving engines share.

    An engine keeps ``_pager`` (a :class:`HostPager`, or None for a dense
    slot cache), sets ``_paged_attn``, ``_prefix_cache_on`` and
    ``_kv_dtype`` from its constructor and calls :meth:`_note_slot_cache`
    from its ``init_slot_cache``.  With no pager every hook takes the dense
    branch: admission admits everything, and reserve, free and publish do
    nothing.

    ``paged_attn`` picks the paged decode discipline: ``"inplace"``
    attends through the page table (the paged kernel on the card),
    ``"gather"`` gathers the dense view, runs the family's dense decode step
    and scatters the one new token per active slot back (the reference
    discipline).  ``prefix_cache="on"`` arms shared-prefix reuse:
    admission radix-matches the prompt against the pool's index, maps the
    matched pages into the slot's table (refcount++, no prefill for them)
    and the tail is prefilled from a B=1 cache seeded with the gathered
    prefix; it engages only when every dynamic cache leaf pages (``len``
    aside), so a ring or recurrent family runs a no-op index.
    """

    _pager: Optional[HostPager] = None
    _paged_attn: str = "inplace"
    _prefix_cache_on: bool = False
    _prefix_shareable: bool = False
    _kv_dtype: str = "bf16"      # pool storage format
    _kv_tok_bytes: int = 0       # per-token-per-slot seq-scaling cache bytes
    _kv_quant_tok_bytes: Optional[float] = None   # a quantized pool's figure
    _kv_shards: int = 1          # TP head cut of the pool (1 = whole)
    _slot_count: int = 0

    @property
    def _paging_active(self) -> bool:
        return self._pager is not None

    def _set_paging(self, page_size: Optional[int], num_pages: Optional[int],
                    paged_attn: str, prefix_cache: str,
                    kv_dtype: str) -> None:
        """Validate and set the slot cache's paging options (the engines'
        constructors call this once the cache layout is known): a host pager
        only with ``page_size`` and where some cache leaf grows with the
        sequence; rwkv keeps the dense slot layout, as in the JAX
        package."""
        self._paged_attn = self.check_paged_attn(paged_attn)
        self._prefix_cache_on = self.check_prefix_cache(prefix_cache)
        self._kv_dtype = check_kv_dtype(kv_dtype, page_size)
        self.page_size, self.num_pages = page_size, num_pages
        pages_any = any(s_ax >= 0 for e in self._stats_seq_axes().values()
                        for s_ax in (e if isinstance(e, list) else [e]))
        self._pager = (HostPager(page_size, num_pages, self.max_len,
                                 device=self.device)
                       if page_size is not None and pages_any else None)

    def with_paging(self, page_size: Optional[int] = None,
                    num_pages: Optional[int] = None,
                    paged_attn: str = "inplace", prefix_cache: str = "off",
                    kv_dtype: str = "bf16"):
        """A second engine over the SAME device weights with other
        slot-cache options and a fresh meter: the weights are immutable, so
        one set serves several pool configurations without being built (or
        LAQ-quantized) again."""
        other = copy.copy(self)
        other.meter = type(self.meter)()
        other._set_paging(page_size, num_pages, paged_attn, prefix_cache,
                          kv_dtype)
        return other

    @staticmethod
    def check_paged_attn(paged_attn: str) -> str:
        if paged_attn not in ("inplace", "gather"):
            raise ValueError(
                f"paged_attn must be 'inplace' or 'gather', got {paged_attn!r}")
        return paged_attn

    @staticmethod
    def check_prefix_cache(prefix_cache: str) -> bool:
        if prefix_cache not in ("on", "off"):
            raise ValueError(
                f"prefix_cache must be 'on' or 'off', got {prefix_cache!r}")
        return prefix_cache == "on"

    def _note_slot_cache(self, n_slots: int, cache_like, ba, sa,
                         kv_shards: int = 1) -> None:
        """Record the slot-cache geometry the KV byte accounting needs, and
        whether prefix reuse is sound: only when every leaf but ``len``
        pages (a ring or recurrent leaf is slot-private state a shared page
        cannot restore).  ``cache_like`` has the whole model's shapes, also
        on a rank of a tensor-parallel engine, so the read accounting is
        the one-device figure; ``kv_shards`` is the pool's KV-head cut,
        whose per-shard bytes :meth:`cache_stats` reports."""
        self._slot_count = int(n_slots)
        self._kv_tok_bytes = kv_token_bytes(cache_like, ba, sa)
        self._kv_shards = int(kv_shards)
        if self._kv_shards > 1:      # validates exact divisibility
            kv_token_bytes(cache_like, ba, sa, self._kv_shards)
        self._prefix_shareable = all(
            s_ax >= 0 for name, e in sa.items() if name != "len"
            for s_ax in _leaf_axes(e, cache_like[name]))
        self._kv_quant_tok_bytes = (
            kv_token_bytes_quant(cache_like, ba, sa, self.page_size,
                                 self._kv_dtype)
            if self._paging_active and self._kv_dtype != "bf16" else None)
        if self._paging_active:
            self._pager.prefix_on = self.prefix_sharing_active()

    # ------------------------------------------------ host KV-read accounting
    def _kv_bytes(self, tokens) -> int:
        """KV bytes ``tokens`` positions occupy in the pool's storage
        format: 1-byte codes plus page-amortized scales for a quantized
        pool, the dense figure otherwise."""
        if self._kv_quant_tok_bytes is not None:
            return int(round(tokens * self._kv_quant_tok_bytes))
        return int(tokens * self._kv_tok_bytes)

    def _dense_view_read_bytes(self) -> int:
        """Bytes a step reads through a dense (or gathered) ``max_slots x
        max_len`` view: the dense figure, also under a quantized pool (the
        gather discipline reads the dequantized view)."""
        return self._slot_count * self.max_len * self._kv_tok_bytes

    def kv_read_bytes_step(self, active: np.ndarray) -> int:
        """KV-cache bytes ONE decode step reads under the engine's read
        MODEL (replayed on the host, not a hardware counter): in place
        through the page table only the live pages, ``ceil((len +
        is_active) / page_size)`` per occupied slot, in the pool's storage
        format; the gather discipline and a dense slot cache read the whole
        ``max_slots x max_len`` view."""
        if self._paging_active and self._paged_attn == "inplace":
            ps = self._pager.page_size
            lens = self._pager.host_len + np.asarray(active, bool)
            pages_touched = int(-((lens[lens > 0]) // -ps).sum())
            return self._kv_bytes(pages_touched * ps)
        return self._dense_view_read_bytes()

    def _meter_kv_read(self, active: np.ndarray) -> None:
        n = self.kv_read_bytes_step(active)
        if n:
            self.meter.host_read("kv_cache_read", n)

    def gather_transient_bytes_per_step(self) -> int:
        """Dense-view transient bytes one paged decode step materialises:
        the gather discipline's full view, none in place or dense."""
        if self._paging_active and self._paged_attn == "gather":
            return self._dense_view_read_bytes()
        return 0

    def paged_insert(self, batched_cache, single_cache, slot: int, ba, sa,
                     n_tokens: int):
        """Admit one prefilled B=1 dense cache into the pool: allocate the
        slot's pages, then scatter its page blocks through the table row (in
        place; matched prefix entries of the row point at scratch, so the
        shared pages are never written)."""
        self._pager.note_insert(slot, n_tokens)
        insert_tree(batched_cache, single_cache,
                    self._pager.insert_row(slot), slot, ba, sa, n_tokens)
        return batched_cache

    # ------------------------------------------------- shared-prefix KV reuse
    def prefix_cache_armed(self) -> bool:
        """Whether the engine was built with the prefix cache on and a page
        size (before ``init_slot_cache`` knows whether it can share)."""
        return (self._prefix_cache_on
                and getattr(self, "page_size", None) is not None)

    def prefix_sharing_active(self) -> bool:
        """Whether admission radix-matches: the knob is on, the slot cache
        pages, and every dynamic leaf pages."""
        return (self._paging_active and self._prefix_cache_on
                and self._prefix_shareable)

    def admit_slot(self, slot: int, prompt: np.ndarray, max_new: int,
                   chunk: Optional[int] = None) -> Optional[int]:
        """Admission control with prefix reuse: the CACHED token count (0 =
        admitted with no reuse; a dense slot cache always 0), or None when
        the pool cannot take the request now and the scheduler should wait
        for frees.  ``chunk`` is the scheduler's prefill chunk width, the
        alignment quantum of a partial match.  A hit meters the prefill KV
        bytes it saved on the host channel ``prefix_prefill_saved``, in the
        pool's storage format."""
        if not self._paging_active:
            return 0
        cached = self._pager.admit(
            slot, prompt, max_new,
            chunk if self.prefix_sharing_active() else None)
        if cached:
            self.meter.host_read("prefix_prefill_saved",
                                 self._kv_bytes(cached))
        return cached

    def publish_prefix(self, slot: int, prompt: np.ndarray) -> None:
        if self._paging_active:
            self._pager.publish(slot, prompt)

    def paged_seed(self, batched_cache, slot: int, cached_len: int, ba, sa,
                   b1_like):
        """The prefix-aware prefill entry: a fresh B=1 dense cache (shapes
        and dtypes of ``b1_like``) holding the slot's matched prefix pages
        gathered (and dequantized) from the pool, with ``len =
        cached_len``; the tail chunk stream continues from there."""
        row = self._pager.row(slot)[None, :]

        def leaf(like, b_ax, s_ax, pool):
            # a dense leaf other than ``len`` cannot occur while sharing is
            # active (the shareability rule); zeros keep the seed total
            if s_ax >= 0:
                return gather_view(pool, row, b_ax, s_ax)
            return torch.zeros(tuple(like.shape), dtype=like.dtype,
                               device=self.device)

        out = _map(leaf, b1_like, ba, sa, batched_cache)
        out["len"] = torch.full(tuple(b1_like["len"].shape), int(cached_len),
                                dtype=b1_like["len"].dtype,
                                device=self.device)
        return out

    def apply_cow_copies(self, cache, copies, ba, sa):
        """Copy each CoW'd page's device bytes (src -> dst) in every pool
        leaf, scales with their codes; runs only on CoW events (a
        whole-prompt prefix hit's first decode step).  Meters each copy's
        bytes on the host channel ``page_cow_copy``."""
        if not copies:
            return cache

        def copy(p, b_ax, s_ax, src, dst):
            if s_ax < 0:
                return
            if isinstance(p, QuantizedLeaf):
                sl = _scales_leading(p.scales, b_ax, s_ax)
                sl[dst].copy_(sl[src])
                p = p.codes
            pl = _pages_leading(p, b_ax, s_ax)
            pl[dst].copy_(pl[src])

        page_bytes = self._kv_bytes(self._pager.page_size)
        for src, dst in copies:
            _map(lambda p, b_ax, s_ax: copy(p, b_ax, s_ax, src, dst),
                 cache, ba, sa)
            self.meter.host_read("page_cow_copy", page_bytes)
        return cache

    def paged_pre_step(self, cache, active: np.ndarray, ba, sa):
        """Host work before one paged decode step: CoW-protect and allocate
        every active slot's append position, copy any CoW'd pages, and
        meter the step's KV reads.  Returns the cache (updated in place)."""
        copies = self._pager.pre_decode(active)
        cache = self.apply_cow_copies(cache, copies, ba, sa)
        self._meter_kv_read(active)
        return cache

    def reserve_slot(self, slot: int, prompt_len: int, max_new: int) -> bool:
        if not self._paging_active:
            return True
        return self._pager.try_reserve(slot, prompt_len, max_new)

    def can_ever_admit(self, prompt_len: int, max_new: int) -> bool:
        if not self._paging_active:
            return True
        return self._pager.can_ever_admit(prompt_len, max_new)

    def free_slot(self, slot: int) -> None:
        if self._paging_active:
            self._pager.free(slot)

    def _stats_seq_axes(self):
        raise NotImplementedError

    def cache_stats(self, cache) -> Dict[str, object]:
        """Resident-cache accounting: ``cache_bytes`` backs the slot cache
        (codes and scales of a quantized pool); ``peak_kv_bytes_in_use`` is
        what its pages held at peak (the whole allocation for the dense
        layout); the prefix index's hits, pages, evictions and CoW copies;
        the pool's storage format and its bytes per stored token.  On a
        rank of a tensor-parallel engine the byte figures of the cache are
        this rank's, and ``kv_shards`` the pool's KV-head cut."""
        total = sum(_nbytes(t) for e in cache.values() for t in _leaves(e))
        if not self._paging_active:
            return {"cache_bytes": total, "peak_kv_bytes_in_use": total}
        pool, pager = self._pager.pool, self._pager
        sa = self._stats_seq_axes()
        pbytes = pool_bytes(cache, sa)
        page_bytes = page_token_bytes(cache, sa, pool.num_pages,
                                      pool.page_size) * pool.page_size
        return {"cache_bytes": total, "page_size": pool.page_size,
                "num_pages": pool.num_pages, "pool_bytes": pbytes,
                "page_bytes": page_bytes, "pages_in_use": pool.pages_in_use,
                "peak_pages_in_use": pool.peak_pages_in_use,
                "pages_allocated": pool.pages_allocated,
                "peak_kv_bytes_in_use": (total - pbytes
                                         + pool.peak_pages_in_use * page_bytes),
                "prefix_hits": pager.prefix_hits,
                "prefix_hit_tokens": pager.prefix_hit_tokens,
                "index_pages": pool.index_pages,
                "cached_index_pages": pool.cached_pages,
                "evictions": pool.evictions,
                "cow_copies": pool.cow_copies,
                "kv_shards": self._kv_shards,
                "kv_token_bytes_per_shard": (self._kv_tok_bytes
                                             // self._kv_shards),
                "kv_dtype": self._kv_dtype,
                "kv_token_bytes_stored": (
                    self._kv_quant_tok_bytes
                    if self._kv_quant_tok_bytes is not None
                    else self._kv_tok_bytes)}
