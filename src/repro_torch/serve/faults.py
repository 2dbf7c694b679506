"""Deterministic fault injection for the online serving runtime.

Graceful degradation is a tested property, not a hope: a seeded
:class:`FaultInjector` plugs into ``ContinuousBatchingScheduler`` (the
``faults=`` knob) and perturbs the loop at four injection points, all
driven by one ``numpy`` PRNG so a (plan, seed) pair replays the exact same
fault sequence every run, and the same one as the JAX package's
``serve/faults.py``, of which this module is a copy:

  admission     — the next N admissions (or a Bernoulli rate) spuriously
                  report pool pressure: the scheduler must wait/preempt/
                  retry, never crash or wrongly reject.
  pool_squeeze  — a window of scheduler iterations during which EVERY
                  admission reports exhaustion (the pool "filled up"),
                  exercising queue growth and deadline timeouts under
                  sustained pressure.
  prefill       — a chunked-prefill job raises ``InjectedFault`` mid-chunk
                  (probabilistic or targeted by uid): the scheduler must
                  release the slot, reserved pages and radix refcounts and
                  degrade the one request to REJECTED; or a job STALLS for
                  k iterations (its chunks stop arriving), exercising the
                  deadline machinery against a wedged prefill.
  cancel_burst  — at a chosen iteration, a seeded fraction of the
                  requests currently DECODING are cancelled at once
                  (mid-decode cancellation burst); their pages must return
                  within one scheduler iteration.

and three *device-level* points that exercise the split-brain recovery
seam (the host must survive anything the stateless device does):

  step_error    — the persistent decode step raises ``StepError`` for a
                  window of iterations (a runtime fault / launch failure):
                  the scheduler must recover() and resume token-identical.
  step_corrupt  — a seeded subset of DECODING requests gets NaN logits
                  inside the decode step (via the ``corrupt`` mask input)
                  for a window of iterations: the finite-logits sentinel
                  must quarantine exactly those slots, batchmates unharmed.
  device_loss   — at one iteration the engine's device arrays are
                  invalidated wholesale (``DeviceLost``); everything is
                  rebuilt from host-authoritative state.
  step_stall    — one decode step blocks for ``step_stall_s`` seconds (a
                  wedged dispatch) so the OnlineServer watchdog has a real
                  hang to detect.

Every fired event is recorded in ``events`` (name, uid/iteration) so tests
can assert the fault actually happened — a chaos test that silently
injected nothing proves nothing.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serve.errors import DeviceLost, InjectedFault, StepError

__all__ = ["FaultPlan", "FaultInjector"]


@dataclasses.dataclass
class FaultPlan:
    """What to inject; all points default off so a plan enables only the
    failure modes a test targets."""
    # admission: first-N hard failures plus an ongoing Bernoulli rate
    admission_failures: int = 0
    admission_fail_rate: float = 0.0
    # pool exhaustion: every admission fails in [at, at + iters)
    pool_squeeze_at: Optional[int] = None
    pool_squeeze_iters: int = 0
    # prefill faults: raise InjectedFault for these uids / at this rate
    prefill_error_uids: Tuple[int, ...] = ()
    prefill_error_rate: float = 0.0
    # stalled prefill: with stall_rate, a job freezes for stall_iters
    stall_rate: float = 0.0
    stall_iters: int = 0
    stall_uids: Tuple[int, ...] = ()
    # mid-decode cancellation burst at one iteration
    cancel_burst_at: Optional[int] = None
    cancel_burst_frac: float = 0.5
    # device faults: starting at step_error_at, the next step_error_count
    # decode dispatches raise (counted on fires, not iterations — a
    # recovering scheduler spends iterations with nothing decoding)
    step_error_at: Optional[int] = None
    step_error_count: int = 1
    # per-slot logits corruption: a seeded fraction (or explicit uids) of
    # DECODING requests is NaN-corrupted while iteration is in
    # [at, at + iters) — a long window drives the strike/FAILED path, a
    # short one proves transient corruption retries token-identically
    step_corrupt_at: Optional[int] = None
    step_corrupt_iters: int = 1
    step_corrupt_frac: float = 0.5
    step_corrupt_uids: Tuple[int, ...] = ()
    # wholesale device-array invalidation at one iteration
    device_loss_at: Optional[int] = None
    # a wedged dispatch: one decode step blocks for step_stall_s seconds
    step_stall_at: Optional[int] = None
    step_stall_s: float = 0.0


class FaultInjector:
    """Seeded, replayable fault source consulted by the scheduler.

    The scheduler calls :meth:`on_step` once per loop iteration (bursts,
    window bookkeeping), :meth:`admission_fault` immediately before real
    admission (True = pretend the pool refused), :meth:`prefill_fault`
    before executing a chunk (may raise :class:`InjectedFault`), and
    :meth:`prefill_stalled` to decide whether a job's chunk is withheld
    this iteration.  All randomness comes from one ``default_rng(seed)``.
    """

    def __init__(self, plan: FaultPlan, seed: int = 0):
        self.plan = plan
        self.seed = int(seed)
        self.rng = np.random.default_rng(seed)
        self.iteration = 0
        self.events: List[Tuple] = []
        self._admission_budget = int(plan.admission_failures)
        self._stalls: Dict[int, int] = {}      # uid -> iterations remaining
        self._stall_decided: Dict[int, bool] = {}
        self._burst_fired = False
        self._device_lost = False
        self._step_errors_left = int(plan.step_error_count)
        self._step_stalled = False
        self._corrupt_picked: Optional[Tuple[int, ...]] = None

    # ------------------------------------------------------------ loop hooks
    def on_step(self, sched) -> None:
        """Called at the top of every scheduler iteration."""
        p = self.plan
        if (p.cancel_burst_at is not None and not self._burst_fired
                and self.iteration >= p.cancel_burst_at):
            # defer until requests are actually DECODING: firing the burst
            # into an empty batch would consume the one-shot and inject
            # nothing (a chaos test that injects nothing proves nothing)
            uids = sched.decoding_uids()
            if uids:
                self._burst_fired = True
                n = max(1, int(round(len(uids) * p.cancel_burst_frac)))
                picked = self.rng.choice(len(uids), size=min(n, len(uids)),
                                         replace=False)
                for i in sorted(int(j) for j in picked):
                    self.events.append(("cancel_burst", uids[i],
                                        self.iteration))
                    sched.cancel(uids[i])
        for uid in list(self._stalls):
            self._stalls[uid] -= 1
            if self._stalls[uid] <= 0:
                del self._stalls[uid]
        self.iteration += 1

    def _squeezed(self) -> bool:
        p = self.plan
        return (p.pool_squeeze_at is not None
                and p.pool_squeeze_at <= self.iteration
                < p.pool_squeeze_at + p.pool_squeeze_iters)

    def admission_fault(self, uid: int) -> bool:
        """True: report pool pressure for this admission attempt (no real
        resources are taken; the scheduler waits or preempts)."""
        if self._squeezed():
            self.events.append(("pool_squeeze", uid, self.iteration))
            return True
        if self._admission_budget > 0:
            self._admission_budget -= 1
            self.events.append(("admission_fault", uid, self.iteration))
            return True
        if (self.plan.admission_fail_rate > 0.0
                and self.rng.random() < self.plan.admission_fail_rate):
            self.events.append(("admission_fault", uid, self.iteration))
            return True
        return False

    # -------------------------------------------------------- prefill hooks
    def prefill_fault(self, uid: int) -> None:
        """Raise ``InjectedFault`` when this job is scheduled to fail."""
        p = self.plan
        hit = uid in p.prefill_error_uids or (
            p.prefill_error_rate > 0.0
            and self.rng.random() < p.prefill_error_rate)
        if hit:
            self.events.append(("prefill_fault", uid, self.iteration))
            raise InjectedFault(
                f"injected prefill failure for request uid={uid} "
                f"(seed={self.seed}, iteration={self.iteration})")

    def prefill_stalled(self, uid: int) -> bool:
        """True while this job's chunks are withheld (a wedged prefill)."""
        p = self.plan
        if uid not in self._stall_decided:
            stall = uid in p.stall_uids or (
                p.stall_rate > 0.0 and self.rng.random() < p.stall_rate)
            self._stall_decided[uid] = stall
            if stall and p.stall_iters > 0:
                self._stalls[uid] = int(p.stall_iters)
                self.events.append(("stall", uid, self.iteration))
        return uid in self._stalls

    # --------------------------------------------------------- device hooks
    def step_fault(self) -> None:
        """Consulted immediately before each decode dispatch; raises the
        planned device fault (``DeviceLost`` once, ``StepError`` for every
        iteration in its window).  The scheduler catches ``DeviceError``
        and recovers from host state."""
        p = self.plan
        it = self.iteration
        if (p.device_loss_at is not None and not self._device_lost
                and it >= p.device_loss_at):
            self._device_lost = True
            self.events.append(("device_loss", None, it))
            raise DeviceLost(
                f"injected device loss (seed={self.seed}, iteration={it})")
        if (p.step_error_at is not None and it >= p.step_error_at
                and self._step_errors_left > 0):
            self._step_errors_left -= 1
            self.events.append(("step_error", None, it))
            raise StepError(
                f"injected step error (seed={self.seed}, iteration={it})")

    def step_stall(self) -> None:
        """Wedge ONE decode step for ``step_stall_s`` wall seconds (the
        watchdog's quarry).  Blocks the loop thread, as a hung dispatch
        would."""
        p = self.plan
        if (p.step_stall_at is not None and not self._step_stalled
                and self.iteration >= p.step_stall_at
                and p.step_stall_s > 0.0):
            self._step_stalled = True
            self.events.append(("step_stall", None, self.iteration))
            time.sleep(p.step_stall_s)

    def corrupt_uids(self, decoding_uids: List[int]) -> Tuple[int, ...]:
        """Which of the currently-DECODING uids get NaN logits this
        iteration.  Explicit ``step_corrupt_uids`` are targeted directly;
        otherwise a seeded fraction is picked ONCE at the first iteration
        of the window that has a non-empty decode batch (deferred, like
        cancel_burst, so an empty batch can't consume the pick) and that
        same set is corrupted for the rest of the window — surviving
        quarantine/re-admission, which is what drives the strike counter.
        """
        p = self.plan
        if p.step_corrupt_at is None or not decoding_uids:
            return ()
        it = self.iteration
        if not (p.step_corrupt_at <= it
                < p.step_corrupt_at + p.step_corrupt_iters):
            return ()
        if p.step_corrupt_uids:
            hit = tuple(u for u in decoding_uids if u in p.step_corrupt_uids)
        else:
            if self._corrupt_picked is None:
                n = max(1, int(round(len(decoding_uids)
                                     * p.step_corrupt_frac)))
                idx = self.rng.choice(len(decoding_uids),
                                      size=min(n, len(decoding_uids)),
                                      replace=False)
                self._corrupt_picked = tuple(
                    decoding_uids[int(i)]
                    for i in sorted(int(j) for j in idx))
            hit = tuple(u for u in self._corrupt_picked
                        if u in decoding_uids)
        for uid in hit:
            self.events.append(("step_corrupt", uid, it))
        return hit

    def fired(self, kind: str) -> int:
        """How many events of ``kind`` actually fired (tests assert > 0)."""
        return sum(1 for e in self.events if e[0] == kind)
