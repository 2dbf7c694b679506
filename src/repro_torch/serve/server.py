"""Online serving front end: a thread-queue server over the open-loop
scheduler, with per-token streaming, cancellation and deadlines.

The split-brain contract says ONE host thread owns all dynamic state — the
scheduler, the page tables, the decode step.  ``OnlineServer`` keeps
that true while accepting requests from anywhere: ``submit()`` / ``cancel()``
are thread-safe and merely enqueue operations; a single background loop
thread drains them, runs ``scheduler.step()`` iterations while there is
work (briefly parking when idle), and fans terminal results out to
:class:`RequestHandle` futures.  No caller thread ever touches the
scheduler or the engine's tensors.  The loop thread runs under the
engine's CUDA device (the current device and stream are per thread), so
the scheduler's work lands on the card the engine was built for.  This
module is a copy of the JAX package's ``serve/server.py``.

  caller threads                 loop thread (sole scheduler owner)
  ──────────────                 ───────────────────────────────────
  submit(prompt, ...) ──op──▶    drain ops: sched.submit()/cancel()
  handle.cancel()     ──op──▶    sched.step()      (one iteration)
  handle.stream()  ◀──tokens──   per-token callbacks (scheduler-side)
  handle.result()  ◀──future──   sched.poll() -> resolve handles

Streaming rides the scheduler's per-token callback: each generated token is
pushed into the handle's queue the same iteration it was decoded, so
``for tok in handle.stream()`` yields tokens live while other requests keep
batching.  A consumer that stops reading loses nothing downstream — the
queue is unbounded and the terminal sentinel always arrives; a consumer
whose callback *throws* gets its request cancelled (scheduler policy),
never the loop killed.

Deadlines are wall-clock-relative at submit time (``deadline_s=2.0`` means
"2 seconds from now"), translated onto the scheduler's loop clock.
Rejections (validation failures, mid-flight prefill failures) resolve the
handle with a ``REJECTED`` result carrying the reason, so every submitted
request terminates exactly once — nothing hangs.

Tensor-parallel ranks (a scheduler over an engine with ``tp``, a
``TPGroup`` of more than one rank): every rank builds its own
``OnlineServer`` over its own scheduler, inside the function that
``runtime.spawn`` runs, and starts and stops it as on one device.  Rank 0
is the front end: ``submit()``, ``cancel()``, the handles, streaming and
the watchdog live there, and ``submit()`` / ``cancel()`` raise on the other
ranks.  Before every iteration rank 0 broadcasts one packet
(``TPGroup.broadcast_object``): the operations it drained (submissions
with their uid, prompt, ``max_new``, priority and relative deadline, and
cancellations), the cancellations its scheduler took from a throwing
stream callback (a callback runs on rank 0 only), the watchdog's recovery
flag and whether to stop; every rank applies the same packet, then steps,
or parks (rank 0 waits for work, the others for the next packet), or
stops.  The scheduler's loop clock is the group's (``TPGroup.clock``, a
collective), so a deadline is put on it where every rank applies the
submission, and a rejection's finish time is read on every rank; the
watchdog thread only flags, and the recovery runs at the same iteration on
every rank.  A loop error on any rank tears the group down
(``TPGroup.abort``): the others' next collective fails, rank 0's handles
resolve REJECTED, and ``stop()`` raises on every rank.  On a rank other
than 0, ``stop()`` waits for rank 0's stop (its ``drain`` is rank 0's).
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.serve.scheduler import (ContinuousBatchingScheduler, Request,
                                   RequestResult, RequestState)

__all__ = ["OnlineServer", "RequestHandle", "ServerClosed"]

_SENTINEL = object()


class ServerClosed(RuntimeError):
    """submit() after stop(): the loop thread is gone."""


class RequestHandle:
    """Caller-side view of one submitted request: a future for the terminal
    :class:`RequestResult` plus a live token stream."""

    def __init__(self, server: "OnlineServer", uid: int):
        self._server = server
        self.uid = uid
        self._done = threading.Event()
        self._result: Optional[RequestResult] = None
        self._tokens: "queue.Queue" = queue.Queue()

    # ---- loop-thread side -------------------------------------------------
    def _push_token(self, tok: int) -> None:
        self._tokens.put(tok)

    def _resolve(self, result: RequestResult) -> None:
        self._result = result
        self._tokens.put(_SENTINEL)
        self._done.set()

    # ---- caller side ------------------------------------------------------
    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> RequestResult:
        """Block until the request reaches a terminal state.  Raises
        ``TimeoutError`` if it hasn't within ``timeout`` seconds (the
        request keeps running — this is a wait bound, not a deadline)."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request uid={self.uid} not finished within {timeout}s")
        assert self._result is not None
        return self._result

    def cancel(self) -> None:
        """Ask the loop to cancel this request; its slot and pages are
        freed within one scheduler iteration.  The handle still resolves
        (state CANCELLED, or an earlier terminal state if it won the race)."""
        self._server._enqueue(("cancel", self.uid))

    def stream(self) -> Iterator[int]:
        """Yield generated tokens as they are decoded; ends when the
        request reaches a terminal state.  Safe to call once per handle."""
        while True:
            tok = self._tokens.get()
            if tok is _SENTINEL:
                return
            yield tok


class OnlineServer:
    """Thread-queue online server over a :class:`ContinuousBatchingScheduler`.

    The scheduler (and transitively the engine and its page pool) must not be driven by anyone else while the server is
    running.  Use as a context manager::

        with OnlineServer(sched) as srv:
            h = srv.submit(prompt, max_new=32, priority=1, deadline_s=5.0)
            for tok in h.stream():
                ...
            res = h.result()

    ``idle_wait_s`` is how long the loop parks when it has neither ops nor
    work (an op arrival wakes it immediately).

    ``watchdog_s`` arms the step heartbeat watchdog (DESIGN.md §12): the
    loop stamps a heartbeat every iteration, and a daemon thread trips when
    the heartbeat goes stale for ``watchdog_s`` seconds while requests are
    outstanding — a wedged decode dispatch.  The watchdog only *flags*; the
    recovery itself (``scheduler.recover()``) runs on the loop thread at
    its next safe point, because that thread is the sole owner of the
    scheduler and the engine's state.  Consecutive watchdog recoveries back off
    exponentially (``recover_backoff_s`` doubling up to
    ``recover_backoff_cap_s``) so a persistently sick device cannot spin
    the loop in rebuild storms.
    """

    def __init__(self, scheduler: ContinuousBatchingScheduler,
                 idle_wait_s: float = 0.001,
                 watchdog_s: Optional[float] = None,
                 recover_backoff_s: float = 0.05,
                 recover_backoff_cap_s: float = 2.0):
        self.scheduler = scheduler
        self.idle_wait_s = float(idle_wait_s)
        self.watchdog_s = None if watchdog_s is None else float(watchdog_s)
        self.recover_backoff_s = float(recover_backoff_s)
        self.recover_backoff_cap_s = float(recover_backoff_cap_s)
        self._ops: List[Tuple] = []
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._handles: Dict[int, RequestHandle] = {}
        self._uid = 0
        self._thread: Optional[threading.Thread] = None
        self._watchdog_thread: Optional[threading.Thread] = None
        self._loop_error: Optional[BaseException] = None
        self._heartbeat = time.monotonic()
        self._watchdog_trips = 0
        self._recover_flag = False
        self._recover_streak = 0
        self._recover_wait = 0.0
        self._last_recover_t = 0.0
        # tensor-parallel ranks: the group, and whether this is rank 0
        tp = getattr(scheduler.engine, "tp", None)
        self._tp = tp if tp is not None and tp.size > 1 else None
        self._front = self._tp is None or self._tp.rank == 0

    # ------------------------------------------------------------ lifecycle
    def start(self, warmup: bool = False) -> "OnlineServer":
        if self._thread is not None:
            raise RuntimeError("server already started")
        if warmup:
            # compile on the caller's thread, before the loop owns the
            # scheduler — keeps first-request latency honest
            self.scheduler.warmup()
        self.scheduler.begin()
        self._heartbeat = time.monotonic()
        self._thread = threading.Thread(target=self._loop,
                                        name="serve-loop", daemon=True)
        self._thread.start()
        if self.watchdog_s is not None and self._front:
            self._watchdog_thread = threading.Thread(
                target=self._watchdog, name="serve-watchdog", daemon=True)
            self._watchdog_thread.start()
        return self

    def stop(self, drain: bool = True, timeout: Optional[float] = None
             ) -> None:
        """Shut the loop down.  ``drain=True`` serves everything already
        submitted first; ``drain=False`` cancels all outstanding requests
        (handles resolve CANCELLED).  On a tensor-parallel rank other than
        0 it waits for rank 0's stop, whose ``drain`` holds."""
        if self._thread is None:
            return
        if not self._front:
            self._thread.join(timeout)
            self._thread = None
            if self._loop_error is not None:
                raise RuntimeError("serve loop died") from self._loop_error
            return
        if not drain:
            with self._lock:
                uids = list(self._handles)
            for uid in uids:
                self._enqueue(("cancel", uid))
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout)
        self._thread = None
        if self._watchdog_thread is not None:
            self._watchdog_thread.join(timeout=5.0)
            self._watchdog_thread = None
        if self._loop_error is not None:
            raise RuntimeError("serve loop died") from self._loop_error

    def __enter__(self) -> "OnlineServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=not any(exc))

    # ------------------------------------------------------------ submission
    def submit(self, prompt, max_new: int = 16, priority: int = 0,
               deadline_s: Optional[float] = None) -> RequestHandle:
        """Thread-safe submission.  ``deadline_s`` is relative to NOW
        (wall clock at submit); ``priority`` is the SLA class (higher wins
        admission and may preempt lower).  Returns immediately with a
        handle — validation happens on the loop thread, and a malformed
        request resolves its handle as REJECTED rather than raising here.
        Rank 0's alone on tensor-parallel ranks."""
        self._check_front("submit")
        if self._thread is None or self._stop.is_set():
            raise ServerClosed("submit() on a stopped server")
        with self._lock:
            uid = self._uid
            self._uid += 1
            handle = RequestHandle(self, uid)
            self._handles[uid] = handle
        self._enqueue(("submit", uid, np.asarray(prompt, np.int32),
                       int(max_new), int(priority),
                       None if deadline_s is None else float(deadline_s)))
        return handle

    def cancel(self, uid: int) -> None:
        """Thread-safe cancellation of request ``uid`` (as
        ``RequestHandle.cancel``).  Rank 0's alone on tensor-parallel
        ranks."""
        self._check_front("cancel")
        self._enqueue(("cancel", int(uid)))

    def _check_front(self, what: str) -> None:
        if not self._front:
            raise RuntimeError(
                f"{what}() on tensor-parallel rank {self._tp.rank}: rank 0 "
                f"is the front end, the other ranks follow its loop")

    def _enqueue(self, op: Tuple) -> None:
        with self._lock:
            self._ops.append(op)
        self._wake.set()

    # ------------------------------------------------------------- the loop
    def _next_packet(self) -> Tuple[List[Tuple], List[int], bool, bool]:
        """This iteration's (operations, cancellations taken by the
        scheduler from a throwing stream callback, recovery flag, stop):
        drained from the queue on one device or rank 0, broadcast from rank
        0 to every rank of a tensor-parallel group.  The stop flag is read
        before the drain, so every operation enqueued before ``stop()``
        rides this packet or an earlier one."""
        packet = None
        if self._front:
            self._heartbeat = time.monotonic()
            stop = self._stop.is_set()
            with self._lock:
                ops, self._ops = self._ops, []
            recover, self._recover_flag = self._recover_flag, False
            # a stream callback runs on rank 0 alone
            cancels = (sorted(self.scheduler._cancels)
                       if self._tp is not None else [])
            packet = (ops, cancels, recover, stop)
        if self._tp is None:
            return packet
        return self._tp.broadcast_object(packet)

    def _apply_ops(self, ops: List[Tuple], cancels: List[int]) -> None:
        """Apply one packet's operations in order, then its callback
        cancellations.  A submission's arrival and deadline are read on the
        scheduler's loop clock (a collective of a tensor-parallel group,
        read alike on every rank); its stream is the handle's, on the rank
        that holds it."""
        sched = self.scheduler
        for op in ops:
            if op[0] == "submit":
                _, uid, prompt, max_new, priority, deadline_s = op
                handle = self._handles.get(uid)
                now = sched.clock()
                req = Request(
                    uid=uid, prompt=prompt, max_new=max_new,
                    arrival_s=now, priority=priority,
                    deadline_s=None if deadline_s is None
                    else now + deadline_s,
                    stream=None if handle is None else handle._push_token)
                sched.submit(req)
            elif op[0] == "cancel":
                sched.cancel(op[1])
        for uid in cancels:
            sched.cancel(uid)

    def _publish_terminal(self) -> None:
        sched = self.scheduler
        for res in sched.poll():
            h = self._handles.pop(res.uid, None)
            if h is not None:
                h._resolve(res)
        for rej in sched.poll_rejected():
            # read on every rank: the loop clock may be a collective
            now = sched.clock()
            h = self._handles.pop(rej.uid, None)
            if h is not None:
                h._resolve(RequestResult(
                    uid=rej.uid, tokens=np.zeros((0,), np.int32),
                    gen_len=0, prompt_len=0, admitted_s=-1.0,
                    finished_s=now,
                    state=RequestState.REJECTED.value))
                h.reject_reason = rej.reason

    # ---------------------------------------------------------- the watchdog
    def _watchdog(self) -> None:
        """Heartbeat monitor: trips when the loop has outstanding requests
        but has not stamped a heartbeat for ``watchdog_s`` seconds.  Runs
        on its own daemon thread; never touches scheduler state — it only
        raises the recover flag and rearms."""
        interval = max(self.watchdog_s / 4.0, 0.005)
        while not self._stop.is_set():
            time.sleep(interval)
            if self._thread is None or not self._thread.is_alive():
                return
            with self._lock:
                busy = bool(self._handles)
            if not busy:
                # idle loop: nothing can be wedged, keep the clock fresh
                self._heartbeat = time.monotonic()
                continue
            if time.monotonic() - self._heartbeat > self.watchdog_s:
                self._watchdog_trips += 1
                self._recover_flag = True
                self._heartbeat = time.monotonic()   # rearm, don't re-trip
                self._wake.set()

    def _maybe_recover(self, flagged: bool) -> None:
        """Loop-thread half of the watchdog: apply the flagged recovery at
        a safe point (``flagged``: this iteration's packet says so, the
        same on every rank), with bounded exponential backoff between
        consecutive recoveries.  A quiet period of 2x the watchdog window
        resets the backoff streak."""
        if not flagged:
            return
        now = time.monotonic()
        if (self._recover_streak
                and now - self._last_recover_t
                > 2.0 * (self.watchdog_s or 0.0) + self._recover_wait):
            self._recover_streak = 0
            self._recover_wait = 0.0
        wait = self._recover_wait - (now - self._last_recover_t)
        if self._recover_streak and wait > 0:
            time.sleep(wait)
        self.scheduler.recover(reason="watchdog: step heartbeat lost")
        self._last_recover_t = time.monotonic()
        self._recover_streak += 1
        self._recover_wait = min(
            self.recover_backoff_s * (2 ** (self._recover_streak - 1)),
            self.recover_backoff_cap_s)

    def _device_scope(self):
        """The engine's CUDA device as the loop thread's current device (a
        CPU engine needs none)."""
        dev = getattr(self.scheduler.engine, "device", None)
        if dev is not None and torch.device(dev).type == "cuda":
            return torch.cuda.device(dev)
        return contextlib.nullcontext()

    def _loop(self) -> None:
        with self._device_scope():
            self._run_loop()

    def _run_loop(self) -> None:
        sched = self.scheduler
        try:
            while True:
                ops, cancels, recover, stop = self._next_packet()
                self._apply_ops(ops, cancels)
                self._maybe_recover(recover)
                if sched.has_work():
                    sched.step(realtime=False)
                    self._publish_terminal()
                    continue
                self._publish_terminal()
                if stop:
                    break
                if self._front:
                    self._wake.wait(self.idle_wait_s)
                    self._wake.clear()
        except BaseException as e:   # noqa: BLE001 — resolve waiters first
            self._loop_error = e
            if self._tp is not None:
                # the other ranks' next collective fails: the group ends
                self._tp.abort()
            with self._lock:
                handles = list(self._handles.values())
                self._handles.clear()
            for h in handles:
                h._resolve(RequestResult(
                    uid=h.uid, tokens=np.zeros((0,), np.int32),
                    gen_len=0, prompt_len=0, admitted_s=-1.0,
                    finished_s=0.0,
                    state=RequestState.REJECTED.value))

    # ------------------------------------------------------------- inspection
    def stats(self) -> Dict[str, Any]:
        """Point-in-time loop counters (reads scheduler attributes the loop
        thread also touches — informational, not transactional)."""
        s = self.scheduler
        return {
            "iterations": getattr(s, "_iterations", 0),
            "decoded_tokens": getattr(s, "_decoded_tokens", 0),
            "prefill_tokens": getattr(s, "_prefill_tokens", 0),
            "preemptions": getattr(s, "_preempt_count", 0),
            "quarantines": getattr(s, "_quarantines", 0),
            "failed": getattr(s, "_failed_count", 0),
            "recoveries": getattr(s, "_recoveries", 0),
            "last_recovery_s": getattr(s, "_last_recovery_s", 0.0),
            "watchdog_trips": self._watchdog_trips,
            "outstanding": len(self._handles),
        }
