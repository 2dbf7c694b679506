"""Continuous-batching serve loop: slot-based KV cache, zero-recompile
steady state, and the ONLINE request lifecycle the serving runtime builds on.

The paper's Split-Brain protocol (§IV-B) makes the ITA device stateless so
the host can multiplex many streams over one immutable datapath; this module
is that host.  It keeps ONE persistent jitted batched decode step alive and
feeds it from a fixed ``(max_slots, ...)`` slot cache:

  admit ──> reserve pages ──> prefill (whole or CHUNKED) ──> insert_slot
    │                                         │
    └── free slot + pages <── EOS / max_new <── masked batched decode
                                               (1 dispatch per token for
                                                ALL active slots)

Slot lifecycle (DESIGN.md §4): a finished request frees its slot in place —
no reallocation, no shape change — and the next pending request is prefilled
into it mid-flight while the other slots keep decoding.  Every compiled
shape is a power-of-two bucket (serve/slots.py), so after warmup the steady
state dispatches exactly one fixed-shape program per token and NEVER
recompiles (asserted with a compile counter in benchmarks/serve_bench.py).

``prefill_chunk=C`` enables *chunked prefill* (DESIGN.md §5): a prompt body
is fed as fixed-width-C chunks, AT MOST ONE chunk per loop iteration, so a
long prompt adds bounded latency to each batched decode step instead of
head-of-line-blocking every decoding slot with a monolithic prefill.

Request lifecycle (DESIGN.md §8) — every request walks the state machine

  QUEUED ─> PREFILL ─> DECODE ─> DONE
     │          │          ├────> CANCELLED   (cancel(uid), ≤ 1 iteration)
     │          │          ├────> TIMEOUT     (deadline_s exceeded)
     │          │          ├────> FAILED      (quarantined max_strikes times)
     │          │          └────> EVICTED ──> QUEUED   (preemption or
     │          └───> REJECTED                 quarantine, bounded backoff)
     └──> REJECTED / CANCELLED / TIMEOUT

driven by the OPEN-LOOP api: ``submit()`` enqueues, ``step()`` runs one
scheduler iteration (cancellations, deadlines, admission incl. preemption,
one prefill chunk, one masked decode step), ``poll()`` drains terminal
results, ``cancel()`` requests mid-flight cancellation — the slot and its
pages are freed within ONE iteration.  ``run()`` is the closed-loop wrapper
(submit all, step until drained) the offline benchmarks and parity tests
use; serve/server.py wraps the open loop in a thread-queue front end with
per-token streaming.

SLA-aware preemption (``preemption=True``): when the highest-priority
waiting request cannot be admitted — no free slot, or the page pool refuses
— the scheduler evicts a strictly-lower-priority victim (lowest priority
class first, most recently admitted within it: least work lost).  Eviction
publishes the victim's completed full pages into the radix prefix index
FIRST (prefix-armed engines), so re-admission re-prefills almost nothing,
then frees the slot and pages (shared pages only lose one refcount — the
copy-on-write rule means eviction can never corrupt another stream) and
re-queues the victim with bounded exponential backoff
(``backoff_steps * 2**(evictions-1)`` iterations, capped).  A resumed
victim re-enters admission with prompt+generated-so-far as its effective
prompt, so greedy decode continues token-identically.

Failures are RECOVERABLE per request: any ``SchedulerError``
(serve/errors.py) raised while admitting or prefilling one request —
including faults injected by serve/faults.py — releases its slot, reserved
pages and radix refcounts and degrades that one request to a REJECTED
entry; every other stream keeps decoding.  Unknown exceptions still
propagate after the same cleanup.

TrafficMeter accounting stays byte-exact per *active* token: every token
that actually crosses the boundary — prefill (minus prefix-cached), decode,
re-prefill after eviction, even chunks computed by a job that later failed
— is replayed on the meter, so measured bytes always equal
``(prefill_tokens + decoded_tokens) * bytes_per_token`` and, for runs with
no eviction/abort, the classic per-request identity
``sum(T0 - 1 - cached + gen)`` (tests/test_scheduler.py).

The loop clock (``clock=``): deadlines and realtime arrivals are decided
against one reading of the clock per iteration, taken at the top of
``step()`` (and before a realtime idle sleep).  Over a tensor-parallel
engine (``engine.tp``) the default clock is the group's
(``TPGroup.clock``: rank 0's ``perf_counter`` broadcast to every rank), so
every rank's scheduler expires and admits the same requests at the same
iteration and the ranks keep decoding the same batches; on one device it
is ``time.perf_counter``.  The results' times (admission, first token,
finish) and ``wall_s`` are each process's own ``perf_counter``.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.serve.errors import DeviceError, SchedulerError

__all__ = ["Request", "RequestResult", "RejectedRequest", "RequestState",
           "ContinuousBatchingScheduler"]


class RequestState(str, enum.Enum):
    """The request lifecycle's states (DESIGN.md §8).  Terminal states are
    DONE / CANCELLED / TIMEOUT / REJECTED / FAILED; EVICTED is transient
    (the victim re-queues) and shows up only as
    ``RequestResult.preemptions > 0``.  FAILED is the quarantine terminal:
    a request whose decode step kept producing non-finite logits through
    ``max_strikes`` retries (DESIGN.md §12)."""
    QUEUED = "QUEUED"
    PREFILL = "PREFILL"
    DECODE = "DECODE"
    DONE = "DONE"
    CANCELLED = "CANCELLED"
    EVICTED = "EVICTED"
    TIMEOUT = "TIMEOUT"
    REJECTED = "REJECTED"
    FAILED = "FAILED"


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (T0,) int32
    max_new: int = 16
    arrival_s: float = 0.0        # offset from serve-loop start
    priority: int = 0             # higher = more important (SLA class)
    deadline_s: Optional[float] = None   # absolute loop-clock deadline
    stream: Optional[Callable[[int], None]] = None  # per-token callback


@dataclasses.dataclass
class RequestResult:
    uid: int
    tokens: np.ndarray            # (gen_len,) int32 — exactly what was generated
    gen_len: int
    prompt_len: int
    admitted_s: float             # first admission (-1.0 if never admitted)
    finished_s: float
    cached_tokens: int = 0        # prompt tokens served from the prefix cache
    queue_wait_s: float = 0.0     # arrival (or loop start) -> first admission
    ttft_s: float = 0.0           # arrival (or loop start) -> first token
    state: str = "DONE"           # terminal RequestState value
    preemptions: int = 0          # times evicted + resumed on the way here


@dataclasses.dataclass
class RejectedRequest:
    uid: int
    reason: str


@dataclasses.dataclass
class _ReqRecord:
    """Per-request lifetime record, persistent across evictions: generated
    tokens accumulate here, so a resumed victim's effective prompt is
    ``prompt + tokens`` and its remaining budget ``max_new - len(tokens)``."""
    req: Request
    tokens: List[int] = dataclasses.field(default_factory=list)
    cached: int = 0               # cumulative prefix-cache hits (tokens)
    preemptions: int = 0
    strikes: int = 0              # quarantines (non-finite logits) so far
    not_before: int = 0           # earliest re-admission ITERATION (backoff)
    admitted_s: Optional[float] = None    # first admission
    first_token_s: Optional[float] = None


@dataclasses.dataclass
class _SlotState:
    rec: _ReqRecord
    tenure_s: float               # THIS tenure's admission (victim ordering)


@dataclasses.dataclass
class _PrefillJob:
    """A request whose (effective) prompt is being fed chunk-by-chunk into
    a B=1 cache (the slot is held but inactive until the last chunk is
    inserted).  ``cached`` prompt tokens were served from the prefix cache:
    the B=1 cache was seeded with them and the chunk stream starts there."""
    slot: int
    rec: _ReqRecord
    prompt: np.ndarray            # effective prompt (original + resumed)
    cache: Any
    consumed: int
    tenure_s: float
    cached: int = 0


class ContinuousBatchingScheduler:
    """Slot-based continuous batching over one persistent decode program.

    ``realtime=True`` honours ``Request.arrival_s`` against the wall clock
    (Poisson-arrival benchmarking); ``realtime=False`` treats arrivals as an
    admission ORDER only and admits as fast as slots free up (deterministic,
    used by the parity tests).

    ``prefill_chunk=C`` feeds prompt bodies as width-C chunks interleaved
    with decode steps (at most one chunk per iteration).  C must divide the
    engine's ``max_len``.  ``max_prefill_jobs`` bounds how many in-flight
    chunked prefills may exist at once — each holds a dense B=1 request
    cache until insertion, so the cap also bounds that resident memory
    (1/max_slots of the dense slot cache per job).

    ``preemption=True`` arms SLA-aware eviction (module docstring);
    ``backoff_steps``/``backoff_cap`` bound the evicted victim's
    exponential re-admission backoff in scheduler iterations.  ``faults``
    takes a :class:`repro_torch.serve.faults.FaultInjector` whose seeded
    failure points the loop must absorb gracefully.  ``clock`` (seconds,
    monotonic) is the loop clock of the deadline and arrival decisions
    (module docstring); by default the engine's TP group's, else
    ``time.perf_counter``.
    """

    def __init__(self, engine, max_slots: int = 8,
                 eos_id: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 max_prefill_jobs: int = 2,
                 preemption: bool = False,
                 backoff_steps: int = 2,
                 backoff_cap: int = 32,
                 max_strikes: int = 3,
                 faults=None,
                 clock: Optional[Callable[[], float]] = None):
        self.engine = engine
        if clock is None:
            tp = getattr(engine, "tp", None)
            clock = time.perf_counter if tp is None else tp.clock
        self._clock = clock
        self.max_slots = int(max_slots)
        self.eos_id = eos_id
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be a positive chunk width, "
                f"got {prefill_chunk}")
        self.prefill_chunk = prefill_chunk
        if max_prefill_jobs < 1:
            raise ValueError(
                f"max_prefill_jobs must be >= 1, got {max_prefill_jobs}")
        self.max_prefill_jobs = int(max_prefill_jobs)
        self.preemption = bool(preemption)
        if backoff_steps < 1 or backoff_cap < backoff_steps:
            raise ValueError(
                f"backoff must satisfy 1 <= backoff_steps <= backoff_cap, "
                f"got {backoff_steps}/{backoff_cap}")
        self.backoff_steps = int(backoff_steps)
        self.backoff_cap = int(backoff_cap)
        if max_strikes < 1:
            raise ValueError(f"max_strikes must be >= 1, got {max_strikes}")
        self.max_strikes = int(max_strikes)
        self.faults = faults
        self.cache = None
        self._began = False

    # ----------------------------------------------------------- loop state
    def begin(self) -> None:
        """(Re)initialize the serving state: fresh slot cache, empty queues,
        zeroed counters, loop clock anchored NOW.  ``run()`` calls this
        itself; the open-loop api (``submit``/``step``/``poll``) calls it
        lazily on first use — call it explicitly to drop leftover state."""
        eng = self.engine
        n = self.max_slots
        self.cache = None       # free the old slot cache before the new one
        self.cache = eng.init_slot_cache(n)
        self._tokens = np.zeros((n,), np.int32)
        self._active = np.zeros((n,), bool)
        self._states: Dict[int, _SlotState] = {}
        self._prefilling: deque = deque()          # _PrefillJob FIFO
        self._free = list(range(n - 1, -1, -1))
        self._pending: List[_ReqRecord] = []
        self._results: List[RequestResult] = []
        self._rejected: List[RejectedRequest] = []
        self._cancels: set = set()
        self._iterations = 0          # every step() (backoff clock)
        self._decode_steps = 0        # decode dispatches only
        self._decoded_tokens = 0
        self._prefill_tokens = 0
        self._cached_tokens = 0
        self._preempt_count = 0
        self._quarantines = 0
        self._failed_count = 0
        self._recoveries = 0
        self._last_recovery_s = 0.0
        self.recovery_log: List[Dict[str, Any]] = []
        self._unmetered = 0
        self._slept_s = 0.0
        self._t_local = time.perf_counter()
        self._t_start = self._clock()
        self._t_loop = 0.0            # this iteration's loop clock reading
        self._began = True

    def _ensure_began(self) -> None:
        if not self._began:
            self.begin()

    def _now(self) -> float:
        """This process's seconds since ``begin`` (the results' times)."""
        return time.perf_counter() - self._t_local

    def _tick(self) -> None:
        """Read the loop clock once: the reading every deadline and arrival
        decision until the next one uses."""
        self._t_loop = self._clock() - self._t_start

    def clock(self) -> float:
        """The loop clock (seconds since ``begin``): the timebase of
        ``arrival_s`` and ``deadline_s``, read now (over a TP group every
        rank must call it at the same point)."""
        self._ensure_began()
        return self._clock() - self._t_start

    def has_work(self) -> bool:
        """Anything queued, prefilling or decoding."""
        if not self._began:
            return False
        return bool(self._pending or self._states or self._prefilling)

    def decoding_uids(self) -> List[int]:
        """Uids currently in DECODE, slot order (fault-burst targeting)."""
        return [self._states[s].rec.req.uid
                for s in sorted(self._states) if self._active[s]]

    # ------------------------------------------------------------- admission
    def submit(self, req: Request) -> bool:
        """Enqueue one request (open-loop entry).  Malformed requests are
        rejected immediately with a readable reason (False); accepted ones
        enter QUEUED (True) and terminate through ``poll()``."""
        self._ensure_began()
        reason = self._invalid_reason(req)
        if reason is not None:
            self._rejected.append(RejectedRequest(req.uid, reason))
            return False
        self._pending.append(_ReqRecord(req))
        return True

    def cancel(self, uid: int) -> None:
        """Request cancellation of ``uid``: honoured within ONE scheduler
        iteration, whatever state the request is in — queued, prefilling or
        decoding — and its slot + pages are freed there and then.  Unknown
        or already-terminal uids are ignored."""
        self._ensure_began()
        self._cancels.add(int(uid))

    def poll(self) -> List[RequestResult]:
        """Drain terminal results produced since the last poll (flushes the
        pending meter replay so open-loop traffic accounting stays exact)."""
        self._ensure_began()
        self._flush_meter()
        out = self._results
        self._results = []
        return out

    def poll_rejected(self) -> List[RejectedRequest]:
        """Drain rejections (validation failures and mid-flight REJECTED)."""
        self._ensure_began()
        out = self._rejected
        self._rejected = []
        return out

    def _invalid_reason(self, r: Request) -> Optional[str]:
        try:
            prompt = np.asarray(r.prompt)
            T0 = int(prompt.shape[0]) if prompt.ndim == 1 else -1
        except Exception:
            return "prompt is not array-like"
        if prompt.ndim != 1:
            return f"prompt must be 1-D, got shape {prompt.shape}"
        if T0 < 1:
            return ("empty prompt: a request needs at least one token to "
                    "seed decoding")
        if r.max_new < 1:
            return f"max_new={r.max_new} asks for no output tokens"
        if T0 - 1 + r.max_new > self.engine.max_len:
            return (f"request does not fit the cache: prompt_len={T0} + "
                    f"max_new={r.max_new} needs {T0 - 1 + r.max_new} "
                    f"positions but max_len={self.engine.max_len}")
        return None

    def _effective(self, rec: _ReqRecord):
        """The (prompt, max_new) a record admits with: a resumed victim
        re-prefills its original prompt PLUS everything it already
        generated, so greedy decode continues token-identically."""
        if not rec.tokens:
            return np.asarray(rec.req.prompt, np.int32), rec.req.max_new
        prompt = np.concatenate([np.asarray(rec.req.prompt, np.int32),
                                 np.asarray(rec.tokens, np.int32)])
        return prompt, rec.req.max_new - len(rec.tokens)

    # --------------------------------------------------------- terminalizers
    def _make_result(self, rec: _ReqRecord, state: RequestState
                     ) -> RequestResult:
        t = self._now()
        first = rec.first_token_s
        return RequestResult(
            uid=rec.req.uid,
            tokens=np.asarray(rec.tokens, np.int32),
            gen_len=len(rec.tokens),
            prompt_len=len(rec.req.prompt),
            admitted_s=rec.admitted_s if rec.admitted_s is not None else -1.0,
            finished_s=t,
            cached_tokens=rec.cached,
            queue_wait_s=max(0.0, (rec.admitted_s if rec.admitted_s
                                   is not None else t) - rec.req.arrival_s),
            ttft_s=(max(0.0, first - rec.req.arrival_s)
                    if first is not None else 0.0),
            state=state.value,
            preemptions=rec.preemptions)

    def _finish_record(self, rec: _ReqRecord, state: RequestState) -> None:
        self._results.append(self._make_result(rec, state))

    def _release_slot(self, slot: int) -> None:
        """Return a slot (and its pages) to the free pool — the single
        release point every terminal path funnels through, so pages can
        never leak past the iteration that retired the request."""
        self._active[slot] = False
        if slot not in self._free:
            self._free.append(slot)
        if hasattr(self.engine, "free_slot"):
            self.engine.free_slot(slot)

    def _finish_slot(self, slot: int, state: RequestState) -> None:
        st = self._states.pop(slot)
        self._release_slot(slot)
        self._finish_record(st.rec, state)

    def _abort_job(self, job: _PrefillJob, state: RequestState,
                   reason: Optional[str] = None) -> None:
        """Tear down an in-flight prefill job: account the chunks it DID
        compute (they crossed the boundary), release the slot, reserved
        pages and radix refcounts, and terminalize the record."""
        try:
            self._prefilling.remove(job)
        except ValueError:
            pass
        computed = job.consumed - job.cached
        self._prefill_tokens += computed
        self._unmetered += computed
        self._release_slot(job.slot)
        if state is RequestState.REJECTED:
            self._rejected.append(RejectedRequest(
                job.rec.req.uid, reason or "prefill failed"))
        else:
            self._finish_record(job.rec, state)

    def _reject_record(self, rec: _ReqRecord, reason: str) -> None:
        self._rejected.append(RejectedRequest(rec.req.uid, reason))

    def _reject_pool(self, rec: _ReqRecord) -> None:
        prompt, max_new = self._effective(rec)
        self._pending.remove(rec)
        self._reject_record(
            rec,
            "request does not fit the KV page pool even with every "
            f"slot idle (prompt_len={len(prompt)}, max_new={max_new})")

    # ------------------------------------------------- cancellation/deadline
    def _apply_cancellations(self) -> None:
        if not self._cancels:
            return
        uids = self._cancels
        self._cancels = set()
        for rec in [r for r in self._pending if r.req.uid in uids]:
            self._pending.remove(rec)
            self._finish_record(rec, RequestState.CANCELLED)
        for job in [j for j in list(self._prefilling)
                    if j.rec.req.uid in uids]:
            self._abort_job(job, RequestState.CANCELLED)
        for slot in [s for s, st in self._states.items()
                     if st.rec.req.uid in uids]:
            self._finish_slot(slot, RequestState.CANCELLED)

    def _expire_deadlines(self) -> None:
        now = self._t_loop

        def expired(req: Request) -> bool:
            return req.deadline_s is not None and now > req.deadline_s

        for rec in [r for r in self._pending if expired(r.req)]:
            self._pending.remove(rec)
            self._finish_record(rec, RequestState.TIMEOUT)
        for job in [j for j in list(self._prefilling) if expired(j.rec.req)]:
            self._abort_job(job, RequestState.TIMEOUT)
        for slot in [s for s, st in self._states.items()
                     if expired(st.rec.req)]:
            self._finish_slot(slot, RequestState.TIMEOUT)

    # ------------------------------------------------- preemption (SLA-aware)
    def _preempt_for(self, rec: _ReqRecord) -> bool:
        """Evict ONE victim of strictly lower priority than ``rec`` —
        lowest priority class first, most recently admitted within it
        (least work lost).  Returns True if a victim was evicted (its slot
        and pages are free now)."""
        if not self.preemption:
            return False
        prio = rec.req.priority
        best = None
        for slot, st in self._states.items():
            if st.rec.req.priority < prio:
                key = (st.rec.req.priority, -st.tenure_s)
                if best is None or key < best[0]:
                    best = (key, ("slot", slot))
        for job in self._prefilling:
            if job.rec.req.priority < prio:
                key = (job.rec.req.priority, -job.tenure_s)
                if best is None or key < best[0]:
                    best = (key, ("job", job))
        if best is None:
            return False
        kind, target = best[1]
        if kind == "slot":
            self._evict_slot(target)
        else:
            self._evict_job(target)
        return True

    def _requeue(self, rec: _ReqRecord) -> None:
        rec.preemptions += 1
        self._preempt_count += 1
        backoff = min(self.backoff_steps * (2 ** (rec.preemptions - 1)),
                      self.backoff_cap)
        rec.not_before = self._iterations + backoff
        self._pending.append(rec)

    def _evict_slot(self, slot: int) -> None:
        """EVICTED -> QUEUED for a decoding victim: publish its completed
        full pages FIRST (prefix-armed engines make re-admission near-free;
        shared pages merely lose one refcount — the CoW rule keeps every
        other stream untouched), then free the slot + pages and re-queue
        with backoff."""
        st = self._states.pop(slot)
        eng = self.engine
        if hasattr(eng, "publish_prefix"):
            prompt, _ = self._effective(st.rec)
            eng.publish_prefix(slot, prompt)
        self._release_slot(slot)
        self._requeue(st.rec)

    def _evict_job(self, job: _PrefillJob) -> None:
        """Evict a still-prefilling victim: the chunks it computed are
        accounted (they crossed the boundary) and it restarts from
        admission later."""
        try:
            self._prefilling.remove(job)
        except ValueError:
            pass
        computed = job.consumed - job.cached
        self._prefill_tokens += computed
        self._unmetered += computed
        self._release_slot(job.slot)
        self._requeue(job.rec)

    # ------------------------------------------------------------- admission
    def _pick_pending(self, realtime: bool) -> Optional[_ReqRecord]:
        """Highest-priority eligible record (ties: earliest arrival, then
        uid).  Realtime gates on the loop clock; backoff gates evicted
        victims on the iteration clock either way."""
        now = self._t_loop if realtime else 0.0
        best = None
        for rec in self._pending:
            if realtime and rec.req.arrival_s > now:
                continue
            if rec.not_before > self._iterations:
                continue
            key = (-rec.req.priority, rec.req.arrival_s, rec.req.uid)
            if best is None or key < best[0]:
                best = (key, rec)
        return best[1] if best else None

    def _try_admit(self, rec: _ReqRecord, slot: int):
        """One admission attempt into ``slot``: returns the cached-token
        count, or None on pool pressure.  The fault injector's admission
        point sits BEFORE real admission, so an injected refusal takes no
        resources (``(None, True)`` marks it injected: transient by
        construction, never grounds for rejection)."""
        eng = self.engine
        if (self.faults is not None
                and self.faults.admission_fault(rec.req.uid)):
            return None, True
        prompt, max_new = self._effective(rec)
        if hasattr(eng, "admit_slot"):
            return eng.admit_slot(slot, prompt, max_new,
                                  self.prefill_chunk), False
        if hasattr(eng, "reserve_slot"):
            ok = eng.reserve_slot(slot, len(prompt), max_new)
            return (0 if ok else None), False
        return 0, False

    def _in_flight(self) -> bool:
        return bool(self._states) or bool(self._prefilling)

    def _admit(self, realtime: bool) -> None:
        eng = self.engine
        chunk = self.prefill_chunk
        while True:
            rec = self._pick_pending(realtime)
            if rec is None:
                break
            prompt, max_new = self._effective(rec)
            if (chunk is not None and len(prompt) > 1
                    and len(self._prefilling) >= self.max_prefill_jobs):
                break   # bound the resident B=1 prefill caches
            if (hasattr(eng, "can_ever_admit")
                    and not eng.can_ever_admit(len(prompt), max_new)):
                # statically impossible (exceeds the pool itself): reject
                # NOW instead of head-of-line blocking the queue behind a
                # request no amount of frees can admit
                self._reject_pool(rec)
                continue
            if not self._free and not self._preempt_for(rec):
                break                      # every slot busy, no victim
            slot = self._free[-1]
            cached, injected = self._try_admit(rec, slot)
            while cached is None and not injected:
                # pool pressure: evict strictly-lower-priority victims
                # until the request fits or none remain
                if not self._preempt_for(rec):
                    break
                prompt, max_new = self._effective(rec)
                if hasattr(eng, "admit_slot"):
                    cached = eng.admit_slot(slot, prompt, max_new, chunk)
                elif eng.reserve_slot(slot, len(prompt), max_new):
                    cached = 0
            if cached is None:
                if injected or self._in_flight():
                    break     # wait for running requests to free resources
                # backstop: an idle pool that still refuses can never admit
                self._reject_pool(rec)
                continue
            self._pending.remove(rec)
            self._free.remove(slot)
            self._start(rec, slot, cached)

    def _activate(self, slot: int, rec: _ReqRecord, tok: int,
                  tenure_s: float) -> None:
        self._tokens[slot] = tok
        self._active[slot] = True
        self._states[slot] = _SlotState(rec, tenure_s)

    def _start(self, rec: _ReqRecord, slot: int, cached: int) -> None:
        """Move an admitted record into PREFILL (or straight to DECODE).
        Any ``SchedulerError`` between here and activation — the window
        where the slot holds reserved pages and radix refcounts — releases
        everything and degrades the one request to REJECTED; unknown
        exceptions propagate after the same cleanup."""
        eng = self.engine
        prompt, _ = self._effective(rec)
        body = len(prompt) - 1
        now = self._now()
        if rec.admitted_s is None:
            rec.admitted_s = now
        self._cached_tokens += cached
        rec.cached += cached
        try:
            if cached > 0:
                # prefix hit: seed a B=1 request cache with the matched
                # pages gathered from the pool; only the unmatched tail is
                # prefilled (chunk stream continuing at position ``cached``)
                seeded = eng.seed_request_cache(self.cache, slot, cached)
                if cached < body:
                    self._prefilling.append(_PrefillJob(
                        slot, rec, prompt, seeded, cached, now, cached))
                    return
                # whole-body hit: nothing to prefill, go straight to decode
                self.cache = eng.insert_slot(self.cache, seeded, slot)
                eng.publish_prefix(slot, prompt)
                self._activate(slot, rec, int(prompt[-1]), now)
                return
            if self.prefill_chunk is not None and body > 0:
                self._prefilling.append(_PrefillJob(
                    slot, rec, prompt, eng.new_request_cache(), 0, now))
                return
            slot_cache, tok = eng.prefill_slot(prompt)
            self.cache = eng.insert_slot(self.cache, slot_cache, slot)
            if hasattr(eng, "publish_prefix"):
                eng.publish_prefix(slot, prompt)
            self._prefill_tokens += body
            self._unmetered += body
            self._activate(slot, rec, tok, now)
        except SchedulerError as e:
            self._release_slot(slot)
            self._reject_record(rec, f"prefill failed: {e}")
        except Exception:
            self._release_slot(slot)
            raise

    # -------------------------------------------------------- prefill/decode
    def _prefill_tick(self) -> None:
        """At most ONE chunk per iteration, so a long prompt adds bounded
        latency per decode step.  The fault injector may stall the job
        (chunk withheld) or make it throw; a thrown job releases its slot,
        pages and refcounts and becomes a REJECTED entry."""
        if not self._prefilling:
            return
        eng = self.engine
        chunk = self.prefill_chunk
        job = self._prefilling[0]
        uid = job.rec.req.uid
        if self.faults is not None and self.faults.prefill_stalled(uid):
            return
        body = len(job.prompt) - 1
        try:
            if self.faults is not None:
                self.faults.prefill_fault(uid)
            w = min(chunk, body - job.consumed)
            buf = np.zeros((chunk,), np.int32)
            buf[:w] = job.prompt[job.consumed:job.consumed + w]
            job.cache = eng.prefill_chunk_slot(job.cache, buf, w)
            job.consumed += w
            if job.consumed == body:
                self._prefilling.popleft()
                self.cache = eng.insert_slot(self.cache, job.cache, job.slot)
                if hasattr(eng, "publish_prefix"):
                    eng.publish_prefix(job.slot, job.prompt)
                self._prefill_tokens += body - job.cached
                self._unmetered += body - job.cached
                self._activate(job.slot, job.rec, int(job.prompt[-1]),
                               job.tenure_s)
        except SchedulerError as e:
            self._abort_job(job, RequestState.REJECTED,
                            reason=f"prefill failed: {e}")
        except Exception:
            self._abort_job(job, RequestState.REJECTED,
                            reason="prefill failed: unrecoverable")
            raise

    def _decode_tick(self) -> None:
        if not self._active.any():
            return
        eng = self.engine
        n_active = int(self._active.sum())
        corrupt = None
        if self.faults is not None:
            self.faults.step_stall()
            self.faults.step_fault()       # may raise StepError/DeviceLost
            bad = self.faults.corrupt_uids(self.decoding_uids())
            if bad:
                corrupt = np.zeros_like(self._active)
                for slot, st in self._states.items():
                    if st.rec.req.uid in bad:
                        corrupt[slot] = True
        nxt, ok, self.cache = eng.decode_slots(self.cache, self._tokens,
                                               self._active, corrupt)
        self._decode_steps += 1
        self._decoded_tokens += n_active
        self._unmetered += n_active
        nxt = np.asarray(nxt)
        okh = np.asarray(ok)
        t_step = self._now()
        for slot in np.flatnonzero(self._active):
            st = self._states[slot]
            rec = st.rec
            if not okh[slot]:
                # the sentinel flagged non-finite logits: the token is
                # garbage — quarantine the slot instead of appending it
                self._quarantine_slot(slot)
                continue
            tok = int(nxt[slot])
            if rec.first_token_s is None:
                rec.first_token_s = t_step
            rec.tokens.append(tok)
            if rec.req.stream is not None:
                try:
                    rec.req.stream(tok)
                except Exception:
                    # a throwing consumer is a gone consumer: cancel its
                    # request next iteration, keep every other stream alive
                    self._cancels.add(rec.req.uid)
            done = (len(rec.tokens) >= rec.req.max_new
                    or (self.eos_id is not None and tok == self.eos_id))
            if done:
                self._finish_slot(slot, RequestState.DONE)
            else:
                self._tokens[slot] = tok

    def _quarantine_slot(self, slot: int) -> None:
        """Quarantine a slot whose logits went non-finite: the device-side
        bytes this request touched are suspect, so its pages are freed
        WITHOUT publishing them into the prefix index (a poisoned prefix
        would spread to every future sharer), and the request re-queues
        with strike-keyed bounded backoff.  After ``max_strikes`` strikes
        it degrades to the terminal FAILED state — a deterministically-
        corrupting request must not retry forever — while its batchmates
        keep decoding untouched.  Strikes are counted separately from
        preemptions: an evicted victim did nothing wrong."""
        st = self._states.pop(slot)
        rec = st.rec
        self._release_slot(slot)
        rec.strikes += 1
        self._quarantines += 1
        self.recovery_log.append({
            "event": "quarantine", "uid": rec.req.uid,
            "iteration": self._iterations, "strikes": rec.strikes})
        if rec.strikes >= self.max_strikes:
            self._failed_count += 1
            self.recovery_log.append({
                "event": "failed", "uid": rec.req.uid,
                "iteration": self._iterations,
                "reason": f"StepCorruption: non-finite logits in "
                          f"{rec.strikes} decode attempts"})
            self._finish_record(rec, RequestState.FAILED)
            return
        rec.not_before = self._iterations + min(
            self.backoff_steps * (2 ** (rec.strikes - 1)), self.backoff_cap)
        self._pending.append(rec)

    # ------------------------------------------------------------- recovery
    def recover(self, reason: str = "device fault") -> None:
        """Rebuild the device half of the world from host-authoritative
        state after a device failure (DESIGN.md §12).

        The split-brain contract makes this possible: prompts, generated
        tails, page tables and counters all live on the host, so the
        device's arrays are disposable.  Every in-flight request — decoding
        slots AND chunked-prefill jobs — goes back to QUEUED with its
        generated tail intact (``_effective`` re-prefills prompt+tail, so
        greedy decode resumes bitwise token-identically) and WITHOUT a
        preemption or strike charge: the device failed, not the request.
        The engine then ``rebuild()``s params + pool; the prefix index dies
        with the pool (its device bytes are gone) and re-forms as recovered
        requests republish.  Compiled programs are untouched — recovery
        costs zero recompiles (gated in serve_bench)."""
        self._ensure_began()
        t0 = time.perf_counter()
        n_requeued = 0
        for slot in sorted(self._states):
            st = self._states.pop(slot)
            self._pending.append(st.rec)
            n_requeued += 1
        while self._prefilling:
            job = self._prefilling.popleft()
            computed = job.consumed - job.cached
            self._prefill_tokens += computed
            self._unmetered += computed
            self._pending.append(job.rec)
            n_requeued += 1
        self.cache = None            # the old device arrays are gone
        eng = self.engine
        n = self.max_slots
        if hasattr(eng, "rebuild"):
            self.cache = eng.rebuild(n)
        else:
            self.cache = eng.init_slot_cache(n)
        self._tokens = np.zeros((n,), np.int32)
        self._active = np.zeros((n,), bool)
        self._free = list(range(n - 1, -1, -1))
        self._recoveries += 1
        dt = time.perf_counter() - t0
        self._last_recovery_s = dt
        self.recovery_log.append({
            "event": "recover", "reason": str(reason),
            "iteration": self._iterations, "requeued": n_requeued,
            "recovery_s": dt})

    # ------------------------------------------------------------ open loop
    def step(self, realtime: bool = False) -> List[RequestResult]:
        """ONE scheduler iteration: fault hooks, cancellations, deadlines,
        admission (with preemption), one prefill chunk, one masked decode
        step.  Returns the results that reached a terminal state during
        this iteration (they also stay queued for ``poll()``)."""
        self._ensure_began()
        self._tick()
        n0 = len(self._results)
        if self.faults is not None:
            self.faults.on_step(self)
        self._apply_cancellations()
        self._expire_deadlines()
        self._admit(realtime)
        self._prefill_tick()
        try:
            self._decode_tick()
        except DeviceError as e:
            # a typed device failure is survivable by construction: every
            # byte of dynamic state has a host copy — rebuild and resume
            self.recover(reason=f"{type(e).__name__}: {e}")
        self._iterations += 1
        return self._results[n0:]

    def _flush_meter(self) -> None:
        """Replay the accumulated active-token boundary crossings on the
        meter (aggregate form — crossings are linear in count, so one
        replay is byte-identical to per-step logging).  Prefix-cached
        prompt tokens never cross: their K/V was neither recomputed nor
        re-shipped (the saved bytes land on the excluded
        "prefix_prefill_saved" host channel instead, so the eq. 7-10
        exactness contract holds with the cache on or off)."""
        if self._unmetered:
            self.engine.meter_tokens(self._unmetered)
            self._unmetered = 0

    # ------------------------------------------------------------ serve loop
    def run(self, requests: List[Request],
            realtime: bool = False) -> Dict[str, Any]:
        """Closed loop: serve every request to a terminal state; returns
        results + loop stats.

        ``wall_s`` includes realtime arrival sleeps; ``busy_s`` counts only
        time spent doing work, and both tokens/s figures are reported so an
        idle-heavy Poisson run can't masquerade as an efficient one.
        """
        self.begin()
        for r in sorted(requests, key=lambda r: (r.arrival_s, r.uid)):
            self.submit(r)
        while self.has_work():
            self.step(realtime=realtime)
            if (realtime and not self._active.any()
                    and not self._prefilling and self._pending):
                nxt = min(r.req.arrival_s for r in self._pending)
                self._tick()
                dt = nxt - self._t_loop
                if dt > 0:
                    t0 = time.perf_counter()
                    time.sleep(dt)
                    self._slept_s += time.perf_counter() - t0
        wall_s = self._now()
        busy_s = wall_s - self._slept_s
        self._flush_meter()
        results = self._results
        self._results = []
        results.sort(key=lambda r: r.uid)
        by_state: Dict[str, int] = {}
        for r in results:
            by_state[r.state] = by_state.get(r.state, 0) + 1
        return {
            "results": results,
            "rejected": self._rejected,
            "steps": self._decode_steps,
            "iterations": self._iterations,
            "decoded_tokens": self._decoded_tokens,
            "prefill_tokens": self._prefill_tokens,
            "cached_prompt_tokens": self._cached_tokens,
            "preemptions": self._preempt_count,
            "quarantines": self._quarantines,
            "failed": self._failed_count,
            "recoveries": self._recoveries,
            "last_recovery_s": self._last_recovery_s,
            "by_state": by_state,
            "wall_s": wall_s,
            "busy_s": busy_s,
            "slept_s": self._slept_s,
            "tokens_per_s": self._decoded_tokens / wall_s if wall_s else 0.0,
            "requests_per_s": len(results) / wall_s if wall_s else 0.0,
            "tokens_per_s_busy":
                self._decoded_tokens / busy_s if busy_s else 0.0,
            "requests_per_s_busy":
                len(results) / busy_s if busy_s else 0.0,
        }

    def warmup(self, prompt_len: int = 4, max_new: int = 2) -> None:
        """Compile the steady-state programs (prefill bucket / chunk,
        insert, slot step) before timing starts; leaves the TrafficMeter
        untouched.

        With an engine whose prefix cache is armed, the warm trace also
        exercises the sharing programs: a page-aligned prompt is published,
        then a whole-prefix repeat of it forces the seed gather AND the CoW
        page copy (its decode append lands inside the shared last page).
        ``max_prefill_jobs`` is pinched to 1 for the warm run so the
        publisher's insert lands before the repeat is admitted — otherwise
        both would miss the index and nothing prefix-specific compiles.
        """
        eng = self.engine
        ps = getattr(eng, "page_size", None)
        reqs = [Request(uid=-1, prompt=np.ones((prompt_len,), np.int32),
                        max_new=max_new)]
        prefix_armed = (hasattr(eng, "prefix_cache_armed")
                        and eng.prefix_cache_armed())
        if prefix_armed and 2 * ps + max_new <= eng.max_len:
            # publisher: body = 2*ps (two publishable full pages);
            # repeat: its full prompt is a strict prefix of the published
            # body -> whole-body match overshooting into the last page
            long = np.arange(1, 2 * ps + 2, dtype=np.int32)   # T0 = 2ps+1
            reqs = [Request(uid=-3, prompt=long, max_new=max_new),
                    Request(uid=-2, prompt=long[:2 * ps].copy(),
                            max_new=max_new)]
        jobs = self.max_prefill_jobs
        try:
            if prefix_armed:
                self.max_prefill_jobs = 1
            self.run(reqs)
        finally:
            self.max_prefill_jobs = jobs
        self.engine.meter.reset()
