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
prefix index and copy-on-write included (the engines keep prefix sharing
off so far).  The device-side helpers work on plain dicts of tensors, or of
lists of tensors (the lm cache's per-pattern-slot leaves
``(n_groups, gs // P, B, Hkv, S, hd)`` page into
``(n_groups, gs // P, num_pages, page_size, Hkv, hd)``), and write the pool
IN PLACE.
"""
from __future__ import annotations

import hashlib
import math
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.layers import SCRATCH_PAGE
from repro_torch.serve.errors import PageLifecycleError, ReservationError

__all__ = [
    "PagePool",
    "HostPager",
    "PagedEngineMixin",
    "seq_axes",
    "page_axis",
    "pool_shape",
    "make_pool",
    "insert_tree",
    "kv_token_bytes",
    "round_len",
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

    def insert_row(self, slot: int) -> torch.Tensor:
        """Table row for the slot's insert: matched prefix entries are
        redirected to the scratch page, so the B=1 request cache's blocks
        land only on the slot's private pages."""
        row = self.pool.table[slot].copy()
        row[:int(self.pool._matched[slot])] = SCRATCH_PAGE
        return torch.as_tensor(row, device=self.device)


# ----------------------------------------------------------------------------
# Pool layout (dicts of tensors, or of lists of tensors such as the lm
# cache's per-pattern-slot K/V leaves).  ``ba`` names each entry's batch
# axis, shared by every tensor of a list; ``sa`` each leaf's sequence axis,
# -1 where the leaf does not page: an int for a tensor entry, a list of
# ints for a list entry (an int there applies to every tensor of the list).
# ----------------------------------------------------------------------------
def _leaves(entry):
    return entry if isinstance(entry, list) else [entry]


def _leaf_axes(ax, entry):
    """The sequence axis of each tensor of ``entry``."""
    return list(ax) if isinstance(ax, list) else [ax] * len(_leaves(entry))


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
              device) -> Dict[str, object]:
    """Allocate the paged slot cache: pool layout for paging leaves, dense
    ``(max_slots, ...)`` zeros for the rest (a ring slot's K/V stays
    slot-private).  ``cache_like`` holds tensors (``meta`` ones are fine),
    or lists of them, with the dense cache's shapes and dtypes."""
    def alloc(like, b_ax, s_ax):
        shape = tuple(like.shape)
        if s_ax >= 0:
            shape = pool_shape(shape, b_ax, s_ax, num_pages, page_size)
        return torch.zeros(shape, dtype=like.dtype, device=device)

    out = {}
    for name, like in cache_like.items():
        leaves = [alloc(t, ba[name], s_ax) for t, s_ax in
                  zip(_leaves(like), _leaf_axes(sa[name], like))]
        out[name] = leaves if isinstance(like, list) else leaves[0]
    return out


def _pages_leading(pool: torch.Tensor, b_ax: int, s_ax: int) -> torch.Tensor:
    """A VIEW of a pool leaf with the (num_pages, page_size) axes leading."""
    pax = page_axis(b_ax, s_ax)
    return torch.movedim(pool, (pax, pax + 1), (0, 1))


def insert_tree(pcache: Dict[str, object], single: Dict[str, object],
                table_row: torch.Tensor, slot: int, ba: Dict[str, int],
                sa: Dict[str, object]) -> None:
    """Admit one prefilled B=1 dense cache IN PLACE: paged leaves scatter
    their page blocks to the slot's physical pages (the first entries of
    ``table_row``, as many as the B=1 cache holds pages; excess logical
    pages land on scratch), dense leaves take the slot's row.  A B=1 ring
    sized to a prompt shorter than the slot's ring fills the ring's first
    positions; the rest is written by decode before anything reads it."""
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
            pl = _pages_leading(p, b_ax, s_ax)             # (N, ps, *rest)
            ps = pl.shape[1]
            x = torch.movedim(s, (b_ax, s_ax), (0, 1))[0]  # (S, *rest)
            blocks = x.reshape((x.shape[0] // ps, ps) + tuple(x.shape[1:]))
            pl[rows[:blocks.shape[0]]] = blocks.to(p.dtype)


def kv_token_bytes(cache_like: Dict[str, object], ba: Dict[str, int],
                   sa: Dict[str, object]) -> int:
    """Per-token-per-slot bytes of the sequence-scaling cache leaves, from
    the DENSE cache shapes (paged or not: the same KV bytes per token).  A
    ring slot's K/V does not grow with the sequence and counts nothing."""
    total = 0
    for name, entry in cache_like.items():
        for like, s_ax in zip(_leaves(entry), _leaf_axes(sa[name], entry)):
            if s_ax >= 0:
                n = like.numel() // (like.shape[ba[name]] * like.shape[s_ax])
                total += n * like.element_size()
    return total


# ----------------------------------------------------------------------------
# Engine hooks
# ----------------------------------------------------------------------------
class PagedEngineMixin:
    """The slot-protocol paging hooks the serving engines share.

    An engine keeps ``_pager`` (a :class:`HostPager`, or None for a dense
    slot cache) and calls :meth:`_note_slot_cache` from its
    ``init_slot_cache``.  With no pager every hook takes the dense branch:
    admission admits everything, and reserve, free and publish do nothing.
    The in-place discipline is the one ported (attention through the page
    table); the gather discipline and prefix sharing are not ported yet and
    refuse to be selected.
    """

    _pager: Optional[HostPager] = None
    _kv_tok_bytes: int = 0       # per-token-per-slot seq-scaling cache bytes
    _slot_count: int = 0

    @property
    def _paging_active(self) -> bool:
        return self._pager is not None

    @staticmethod
    def check_paged_attn(paged_attn: str) -> str:
        if paged_attn == "gather":
            raise NotImplementedError(
                "paged_attn='gather' is not ported yet; use 'inplace'")
        if paged_attn != "inplace":
            raise ValueError(
                f"paged_attn must be 'inplace' or 'gather', got {paged_attn!r}")
        return paged_attn

    @staticmethod
    def check_prefix_cache(prefix_cache: str) -> None:
        if prefix_cache == "on":
            raise NotImplementedError(
                "prefix_cache='on' (shared-prefix KV reuse) is not ported yet")
        if prefix_cache != "off":
            raise ValueError(
                f"prefix_cache must be 'on' or 'off', got {prefix_cache!r}")

    def _note_slot_cache(self, n_slots: int, cache_like, ba, sa) -> None:
        """Record the slot-cache geometry the KV-read accounting needs."""
        self._slot_count = int(n_slots)
        self._kv_tok_bytes = kv_token_bytes(cache_like, ba, sa)

    # ------------------------------------------------ host KV-read accounting
    def kv_read_bytes_step(self, active: np.ndarray) -> int:
        """KV-cache bytes ONE decode step reads under the engine's read
        MODEL (replayed on the host, not a hardware counter): through the
        page table only the live pages, ``ceil((len + is_active) /
        page_size)`` per occupied slot; a dense slot cache reads its whole
        ``max_slots x max_len`` view."""
        if not self._paging_active:
            return self._slot_count * self.max_len * self._kv_tok_bytes
        ps = self._pager.page_size
        lens = self._pager.host_len + np.asarray(active, bool)
        pages_touched = int(-((lens[lens > 0]) // -ps).sum())
        return pages_touched * ps * self._kv_tok_bytes

    def _meter_kv_read(self, active: np.ndarray) -> None:
        n = self.kv_read_bytes_step(active)
        if n:
            self.meter.host_read("kv_cache_read", n)

    def paged_insert(self, batched_cache, single_cache, slot: int, ba, sa,
                     n_tokens: int):
        """Admit one prefilled B=1 dense cache into the pool: allocate the
        slot's pages, then scatter its page blocks through the table row
        (in place)."""
        self._pager.note_insert(slot, n_tokens)
        insert_tree(batched_cache, single_cache,
                    self._pager.insert_row(slot), slot, ba, sa)
        return batched_cache

    def prefix_cache_armed(self) -> bool:
        return False

    def admit_slot(self, slot: int, prompt: np.ndarray, max_new: int,
                   chunk: Optional[int] = None) -> Optional[int]:
        """Admission control: 0 when admitted (no prefix reuse in the port
        yet; a dense slot cache always admits), None when the pool cannot
        take the request right now and the scheduler should wait for
        running requests to free pages."""
        if not self._paging_active:
            return 0
        return self._pager.admit(slot, prompt, max_new, None)

    def publish_prefix(self, slot: int, prompt: np.ndarray) -> None:
        if self._paging_active:
            self._pager.publish(slot, prompt)

    def paged_pre_step(self, cache, active: np.ndarray):
        """Host work before one paged decode step: allocate every active
        slot's append page and meter the step's KV reads."""
        copies = self._pager.pre_decode(active)
        if copies:
            raise NotImplementedError(
                "copy-on-write page copies need prefix sharing, which is not "
                "ported yet")
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

    def cache_stats(self, cache) -> Dict[str, int]:
        """Resident-cache accounting: ``cache_bytes`` backs the slot cache;
        ``peak_kv_bytes_in_use`` is what its pages held at peak (the whole
        allocation for the dense layout)."""
        tensors = [t for e in cache.values() for t in _leaves(e)]
        total = sum(t.numel() * t.element_size() for t in tensors)
        if not self._paging_active:
            return {"cache_bytes": total, "peak_kv_bytes_in_use": total}
        pool = self._pager.pool
        page_bytes = self._kv_tok_bytes * pool.page_size
        pool_bytes = page_bytes * pool.num_pages
        return {"cache_bytes": total, "page_size": pool.page_size,
                "num_pages": pool.num_pages, "pool_bytes": pool_bytes,
                "page_bytes": page_bytes, "pages_in_use": pool.pages_in_use,
                "peak_pages_in_use": pool.peak_pages_in_use,
                "pages_allocated": pool.pages_allocated,
                "peak_kv_bytes_in_use": (total - pool_bytes
                                         + pool.peak_pages_in_use * page_bytes)}
