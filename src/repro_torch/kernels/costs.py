"""The work of each CUDA kernel, from its shapes: the bytes it must move and
the operations it must do, and the least time an H100 could take for them.

These are the formulas behind the bound column of ``PERF.md``'s kernel
table: ``chip_smoke.py`` prints its bounds through them, and a kernel
entry of ``kernels/ops.py`` called on ``meta`` tensors records them to the
active tally (:func:`record`) instead of launching anything, which is how
the dry run (``launch/dryrun.py``) counts a step's kernels.  The ``meta_*``
functions below are those entries' meta branches: the record and empty
outputs of the kernel's shapes, the card's autograd Function where a
gradient is wanted (its backward, the plain version's gradient, traced),
and the plain functions that loop over time in Python counted as one
traced iteration times their trip count (:func:`repeat`).

Bytes count each input read once and each output written once; operations
count what the function needs (for attention, the visible query-key pairs
only).  The peaks are the H100 SXM data sheet's dense rates at its 700 W
power limit.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterator, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rwkv_scan as _rwkv

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet (dense peaks below too)
INT8_OPS_PER_S = 1979e12           # dense int8 tensor-core peak
F32_FLOPS_PER_S = 67e12            # float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12          # dense bf16 tensor-core peak


def bound_ms(nbytes: float, ops: float, ops_per_s: float
             ) -> Tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of ``nbytes`` at the HBM
    rate and ``ops`` at ``ops_per_s``, and which of the two it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                        else "operations")


def w4a8(M: int, K: int, N: int, code_bytes: float = 0.5,
         out_bytes: int = 2) -> Tuple[float, int]:
    """(bytes, int8 operations) of one (M, K) x (K, N) W4A8 launch: the
    codes at ``code_bytes`` each (0.5: two per byte, as the kernel reads
    them; 1: one int8 per code), the f32 weight scales, the int8
    activations and their f32 scales read once, the output written once."""
    return (code_bytes * K * N + 4 * N + M * K + 4 * M + out_bytes * M * N,
            2 * M * K * N)


def attention_pairs(Tq: int, Tk: int, causal: bool = True,
                    window: Optional[int] = None, kv_offset: int = 0) -> int:
    """Visible query-key pairs of one head: every pair without ``causal``;
    with it, query i sees the keys j with i + kv_offset - window < j <= i +
    kv_offset (no lower limit without a window), within [0, Tk)."""
    if not causal:
        return Tq * Tk
    if kv_offset == 0 and Tk >= Tq:
        if window is None or window >= Tq:
            return Tq * (Tq + 1) // 2
        return window * (window + 1) // 2 + (Tq - window) * window
    pairs = 0
    for i in range(Tq):
        hi = min(Tk - 1, i + kv_offset)
        lo = 0 if window is None else max(0, i + kv_offset - window + 1)
        pairs += max(0, hi - lo + 1)
    return pairs


def flash(B: int, Hq: int, Hkv: int, Tq: int, Tk: int, D: int, itemsize: int,
          causal: bool = True, window: Optional[int] = None,
          kv_offset: int = 0) -> Tuple[int, int]:
    """(bytes, flops) of one flash-attention launch: q, out, k and v each
    moved once, 4 D flops per visible query-key pair and query head."""
    return (itemsize * (2 * B * Hq * Tq + 2 * B * Hkv * Tk) * D,
            4 * B * Hq * D * attention_pairs(Tq, Tk, causal, window,
                                             kv_offset))


def rwkv(B: int, H: int, T: int, D: int, itemsize: int) -> Tuple[int, int]:
    """(bytes, f32 operations) of one WKV-scan launch: r, k, v, w read once,
    out written once, the f32 final state written once, and 5 D^2 per (b,
    h, t): 3 D^2 for the update w S + k v, 2 D^2 for sum_i r_i S_ij (the
    bonus term's O(D) left out)."""
    return 5 * B * H * T * D * itemsize + 4 * B * H * D * D, 5 * D * D * B * H * T


def paged(B: int, Hq: int, Hkv: int, D: int, rows: int,
          P: Optional[int] = None, live_pages: int = 0,
          quantized: bool = False) -> Tuple[int, int]:
    """(bytes, f32 operations) of one paged-decode launch over ``rows``
    live (slot, position) rows of a bf16 pool (``quantized``: 1-byte codes
    plus the live pages' two f32 scale entries per KV head): each live K
    and V row read once, q read and out written once (bf16), and with
    ``P`` the (B, P) int32 table and the (B,) lengths; 2 x 2 D operations
    per live row and query head (q.k and p.v)."""
    kv = (2 * rows * Hkv * D * 2 if not quantized
          else 2 * rows * Hkv * D + 2 * live_pages * Hkv * 4)
    nbytes = kv + 2 * B * Hq * D * 2
    if P is not None:
        nbytes += B * P * 4 + B * 4
    return nbytes, 2 * 2 * rows * Hq * D


# ----------------------------------------------------------------------------
# The tallies that kernel entries on meta tensors record to
# ----------------------------------------------------------------------------
_SINKS: List = []


@contextlib.contextmanager
def recording(sink) -> Iterator[None]:
    """Make ``sink`` the tally that :func:`record` reports to while the
    block runs (the innermost one wins).  ``sink`` has ``kernel(name,
    flops, nbytes)`` and a ``weight``."""
    _SINKS.append(sink)
    try:
        yield
    finally:
        _SINKS.remove(sink)


def active():
    """The tally that records go to, or None outside a dry run."""
    return _SINKS[-1] if _SINKS else None


def record(name: str, flops: float, nbytes: float) -> None:
    """One launch of kernel ``name`` with its work, to the active tally (a
    no-op where none is active: a meta tensor outside a dry run)."""
    if _SINKS:
        _SINKS[-1].kernel(name, flops, nbytes)


@contextlib.contextmanager
def repeat(n: int) -> Iterator[None]:
    """Weight what the active tally counts in the block by ``n``: one traced
    iteration of a loop that runs ``n`` times (``hlo_analysis``'s
    ``known_trip_count`` weighting of a while body)."""
    sink = active()
    if sink is None:
        yield
        return
    saved = sink.weight
    sink.weight = saved * n
    try:
        yield
    finally:
        sink.weight = saved


# ----------------------------------------------------------------------------
# A kernel entry on meta tensors: its record and its empty outputs
# ----------------------------------------------------------------------------
def _empty(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def meta_w4a8(qx, x_scale, codes, w_scale, out_dtype):
    """The W4A8 kernel's count for meta operands: its record (the codes
    packed, two per byte) and an empty (M, N) output.  The operands' shapes
    are checked as the kernel's wrapper checks them, so that a trace does
    not pass a step the card would refuse."""
    (M, K), N = qx.shape, codes.shape[-1]
    if (codes.dim() != 2 or codes.shape[0] != K
            or tuple(x_scale.shape) != (M, 1)
            or tuple(w_scale.shape) != (N,)):
        raise ValueError(f"w4a8_matmul: qx {tuple(qx.shape)}, x_scale "
                         f"{tuple(x_scale.shape)}, codes "
                         f"{tuple(codes.shape)}, w_scale "
                         f"{tuple(w_scale.shape)} do not fit")
    nbytes, ops = w4a8(M, K, N, out_bytes=out_dtype.itemsize)
    record("w4a8_matmul", ops, nbytes)
    return _empty((M, N), out_dtype)


def _flash_record(q, k, v, *, causal=True, window=None, softcap=None,
                  scale=None, kv_offset=0):
    B, Hq, Tq, D = q.shape
    _fa.body(q.dtype, D)                 # the kernel's dtype / head-dim rule
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D or (
            Hq % k.shape[1]):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    nbytes, flops = flash(B, Hq, k.shape[1], Tq, k.shape[2], D,
                          q.element_size(), causal, window, int(kv_offset))
    record("flash_attention", flops, nbytes)
    return _empty(q.shape, q.dtype)


class _MetaFlashFn(_fa.FlashAttentionFn):
    """``FlashAttentionFn`` on meta tensors: the forward is the kernel's
    record, the backward the plain gradient the card recomputes."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        ctx.save_for_backward(q, k, v)
        ctx.kw = kw
        return _flash_record(q, k, v, **kw)


def meta_attention(q, k, v, kw):
    """The flash kernel's count for contiguous meta operands (``kw`` the
    kernel's options; ``softcap`` and ``scale`` change no count) and an
    empty output like q; where a gradient is wanted, through the card's
    autograd Function with the record as its forward."""
    if build.wants_grad(q, k, v):
        return _MetaFlashFn.apply(q, k, v, kw)
    return _flash_record(q, k, v, **kw)


def meta_paged(q, k_pool, page_table, *, quantized=False, return_lse=False):
    """The paged kernel's count for meta operands, over every (slot, page)
    of the table (the lengths live on the device), and its empty outputs."""
    B, Hq, _, D = q.shape
    ps, Hkv = k_pool.shape[1], k_pool.shape[2]
    P = page_table.shape[1]
    nbytes, ops = paged(B, Hq, Hkv, D, B * P * ps, P, B * P, quantized)
    record("paged_decode_attention", ops, nbytes)
    out = _empty(q.shape, q.dtype)
    if return_lse:
        return out, _empty((B, Hkv, Hq // Hkv), torch.float32)
    return out


def _rwkv_record(xs):
    r = xs[0]
    B, H, T, D = r.shape
    if D not in _rwkv.HEAD_DIMS or any(x.shape != r.shape for x in xs[1:4]):
        raise ValueError(f"rwkv6_scan: head dim {D} not in "
                         f"{_rwkv.HEAD_DIMS}, or r, k, v, w differ")
    nbytes, ops = rwkv(B, H, T, D, r.element_size())
    record("rwkv6_scan", ops, nbytes)
    return _empty(r.shape, r.dtype), _empty((B, H, D, D), torch.float32)


# ----------------------------------------------------------------------------
# Plain functions that loop over time in Python, on meta tensors
# ----------------------------------------------------------------------------
class _Loop(NamedTuple):
    """``fn`` (the plain version) looping over ``axis`` of the inputs at
    ``timed`` in steps of ``step``; ``outs(xs)`` the (shape, dtype) of each
    output; ``forward`` what the forward counts (None: one iteration of
    ``fn`` per trip; else a kernel's record returning its outputs)."""
    fn: Callable
    axis: int
    timed: tuple
    outs: Callable
    step: int = 1
    forward: Optional[Callable] = None

    def trips(self, xs) -> int:
        return xs[0].shape[self.axis] // self.step

    def one(self, xs):
        return [x.narrow(self.axis, 0, self.step)
                if i in self.timed and x is not None else x
                for i, x in enumerate(xs)]


def _wkv_outs(xs):
    B, H, T, D = xs[0].shape
    return [(xs[0].shape, xs[0].dtype), ((B, H, D, D), torch.float32)]


def _loop(name: str, chunk: int = 0) -> _Loop:
    if name == "selective_scan":
        return _Loop(ref.selective_scan, 1, (0, 1, 3, 4), lambda xs: [
            (xs[0].shape, xs[0].dtype),
            ((xs[0].shape[0], xs[0].shape[2], xs[2].shape[1]),
             torch.float32)])
    if name == "rwkv6_chunked":
        return _Loop(lambda *xs: ref.rwkv6_scan_chunked(*xs, chunk=chunk),
                     2, (0, 1, 2, 3), _wkv_outs, step=chunk)
    # the WKV scan's plain version; with a record, the kernel whose
    # gradient is the plain version's
    return _Loop(ref.rwkv6_scan, 2, (0, 1, 2, 3), _wkv_outs,
                 forward=_rwkv_record if name == "rwkv6_kernel" else None)


def _count_forward(loop: _Loop, xs):
    if loop.forward is not None:
        return loop.forward(xs)
    with repeat(loop.trips(xs)):
        loop.fn(*loop.one(xs))
    return tuple(_empty(shape, dt) for shape, dt in loop.outs(xs))


class _MetaLoopFn(torch.autograd.Function):
    """A time loop's count with a gradient: the forward as
    :func:`_count_forward`, the backward one iteration's plain gradient
    times the trip count; the gradients are empty meta tensors."""

    @staticmethod
    def forward(ctx, loop, *xs):
        ctx.set_materialize_grads(False)
        ctx.loop = loop
        ctx.save_for_backward(*xs)
        return _count_forward(loop, xs)

    @staticmethod
    def backward(ctx, *douts):
        loop, xs = ctx.loop, ctx.saved_tensors
        needs = ctx.needs_input_grad[1:]
        with torch.enable_grad(), repeat(loop.trips(xs)):
            one = [None if x is None else x.detach().requires_grad_(n)
                   for x, n in zip(loop.one(xs), needs)]
            outs = loop.fn(*one)
            pairs = [(o, torch.empty_like(o)) for o, d in zip(outs, douts)
                     if d is not None]
            torch.autograd.grad([o for o, _ in pairs],
                                [x for x, n in zip(one, needs) if n],
                                [g for _, g in pairs], allow_unused=True)
        return (None,) + tuple(torch.empty_like(x) if n else None
                               for x, n in zip(xs, needs))


def meta_loop(name: str, *xs, chunk: int = 0):
    """The count of a plain function that loops over time in Python on
    meta inputs ``xs`` ("selective_scan", "rwkv6_chunked" with ``chunk``,
    "rwkv6_scan"): one traced iteration times the trip count, and empty
    outputs; where a gradient is wanted, the backward one iteration's plain
    gradient times the trip count."""
    loop = _loop(name, chunk)
    if build.wants_grad(*xs):
        return _MetaLoopFn.apply(loop, *xs)
    return _count_forward(loop, xs)


def meta_rwkv6(r, k, v, w, u):
    """The scan kernel's count for contiguous meta operands from a zero
    state and its empty (out, final state); where a gradient is wanted,
    the backward is the plain version's, counted as :func:`meta_loop`
    does (as the card's ``RWKV6ScanFn`` recomputes it)."""
    xs = (r, k, v, w, u)
    if build.wants_grad(*xs):
        return _MetaLoopFn.apply(_loop("rwkv6_kernel"), *xs)
    return _rwkv_record(xs)
