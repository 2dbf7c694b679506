"""Typed, recoverable serving errors: the ``SchedulerError`` hierarchy.

The serve hot path must never die for one bad request: every failure a
single request can cause — malformed input, a reservation bug surfacing on
its pages, a prefill job throwing mid-chunk, an injected fault — raises a
``SchedulerError`` subclass, and the scheduler degrades that ONE request to
a ``REJECTED`` terminal result (releasing its slot, reserved pages and
radix refcounts) while every other stream keeps decoding.  Anything that is
NOT a ``SchedulerError`` still propagates after the same resource cleanup:
an unknown exception means the loop's own state may be suspect, and hiding
it would trade a crash for silent corruption.

``PageLifecycleError`` doubles as a ``ValueError`` so pre-existing callers
(and tests) that treat pool misuse as ``ValueError`` keep working.
"""
from __future__ import annotations

__all__ = [
    "SchedulerError",
    "InvalidRequestError",
    "AdmissionError",
    "PrefillError",
    "InjectedFault",
    "ReservationError",
    "PageLifecycleError",
    "DeviceError",
    "StepError",
    "StepCorruption",
    "DeviceLost",
]


class SchedulerError(Exception):
    """Base of every recoverable per-request serving failure."""


class InvalidRequestError(SchedulerError):
    """The request itself is malformed (empty prompt, bad shape/dtype,
    non-positive max_new): rejectable before any resource is taken."""


class AdmissionError(SchedulerError):
    """The request can never be admitted (exceeds the pool or the slot
    table even when idle) — rejected instead of head-of-line blocking."""


class PrefillError(SchedulerError):
    """A prefill job failed mid-flight; the slot, reserved pages and any
    radix-admission refcounts have been released by the scheduler."""


class InjectedFault(PrefillError):
    """A deterministic fault-injection event (serve/faults.py): behaves
    exactly like a real prefill failure so graceful degradation is a
    tested property, not a hope."""


class ReservationError(SchedulerError):
    """A page-pool reservation invariant broke on this slot's lifecycle
    (drew past its worst-case reservation, no CoW headroom).  Raised — not
    asserted — so ``python -O`` cannot strip the check and the scheduler
    can quarantine the one request instead of dying."""


class PageLifecycleError(SchedulerError, ValueError):
    """Pool lifecycle misuse (double free, reserve-after-reserve).  Also a
    ``ValueError`` for callers that predate the hierarchy."""


class DeviceError(SchedulerError):
    """Base of device-side failures the host can recover from.  The
    split-brain contract makes the device stateless: every byte of dynamic
    state has a host-authoritative copy, so a device failure is survivable
    by rebuilding device arrays from host state (``scheduler.recover()``)
    rather than fatal."""


class StepError(DeviceError):
    """The persistent decode step raised (driver fault, launch failure).
    The slot cache that was donated into the failed dispatch is suspect;
    recovery rebuilds it from host state."""


class StepCorruption(DeviceError):
    """A slot produced non-finite logits (flipped bits, bad accumulate).
    Detected by the in-step finite-logits sentinel; the affected request is
    quarantined and retried, degrading to FAILED after N strikes."""


class DeviceLost(DeviceError):
    """The engine's device arrays were invalidated wholesale (device
    reset, OOM-kill, preempted accelerator).  Everything device-side —
    params, page pool, slot cache — must be re-materialised from host
    copies before serving can continue."""
