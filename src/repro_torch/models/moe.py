"""Mixture-of-Experts FFN in torch: top-k routing, sort-based capacity
dispatch into dense ``(E, C, d)`` expert buffers, the grouped expert
products (float, or LAQ W4A8 per expert), and the combine.

The counterpart of the JAX package's ``models/moe.py``, with its routing,
capacity, dispatch order and load-balancing ``aux``.  Numerics follow the
JAX package's compiled programs on the CPU (XLA's exp in the softmax, its
sum orders, the bf16 roundings it keeps and drops), so ``out`` and ``aux``
are bit-identical to the jitted reference there; each place is named where
it is computed.

Rows are coupled: the capacity ``C = ceil(n k / E * capacity_factor)``
depends on every row ``n`` of the call, and the stable sort gives an
expert's capacity to earlier rows first.  A caller that must reproduce the
reference's tokens feeds exactly the reference's rows (its padding
included; ``serve/engine.py``).

The combine does not scatter-add: each token gathers its ``k``
contributions and sums them in the reference's scatter order (its experts
in ascending id), one bf16 add at a time, so the result does not depend on
atomics and two runs on the card give the same bits.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.core import quant
from repro_torch.distributed.collectives import copy_to, gather_from
from repro_torch.kernels import build, costs, ops, ref


def moe_init(d_model: int, d_ff: int, cfg: MoEConfig,
             generator: torch.Generator, *, lead=(), device=None,
             dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Random MoE params of shape ``lead + ...`` drawn from ``generator``:
    the router ``(d, E)`` as ``layers.dense_init`` (uniform in
    +-1/sqrt(d)), ``w1`` and ``w3`` ``(E, d, f)`` uniform in +-1/sqrt(d),
    ``w2`` ``(E, f, d)`` uniform in +-1/sqrt(f), as in the JAX package
    (whose random bits differ).

    Each ``(in, out)`` slice is drawn in float32 and rounded into a leaf
    of ``dtype``, so no more than one expert matrix's float32 draw exists
    at once: at full width a layer's experts are never held twice."""
    E = cfg.num_experts
    lead = tuple(lead)

    def uniform(shape, bound):
        w = torch.empty(lead + shape, dtype=dtype, device=device)
        flat = w.reshape((-1,) + shape[-2:])
        for i in range(flat.shape[0]):
            flat[i] = torch.empty(shape[-2:], dtype=torch.float32,
                                  device=device).uniform_(
                                      -bound, bound, generator=generator)
        return w

    s1, s2 = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
    return {"router": uniform((d_model, E), s1),
            "w1": uniform((E, d_model, d_ff), s1),
            "w3": uniform((E, d_model, d_ff), s1),
            "w2": uniform((E, d_ff, d_model), s2)}


# ----------------------------------------------------------------------------
# Routing and dispatch
# ----------------------------------------------------------------------------
def capacity(n: int, cfg: MoEConfig) -> int:
    """Slots per expert for a call of ``n`` rows (the reference's float
    expression, evaluated in Python as there)."""
    return max(1, int(math.ceil(n * cfg.top_k / cfg.num_experts
                                * cfg.capacity_factor)))


def _xla_sum(a: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the order of XLA's CPU row reduction:
    windows of at most 32 summed in order, recursively on the partial sums
    (``tests/test_torch_rmsnorm_xla.py`` holds this order to XLA's).
    float32, keeps the axis."""
    acc = a
    while acc.shape[-1] > 1:
        m = -(-acc.shape[-1] // 32)
        w = -(-acc.shape[-1] // m)
        pad = m * w - acc.shape[-1]
        if pad:
            acc = torch.nn.functional.pad(acc, (0, pad))
        acc = acc.reshape(acc.shape[:-1] + (m, w))
        s = acc[..., 0]
        for i in range(1, w):
            s = s + acc[..., i]
        acc = s
    return acc


def _router_dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(n, K) x (K, E) float32 product of compute-dtype values, summed in
    the order of XLA's CPU dot emitters (found against the jitted
    reference at the reduced width, d_model 64; every product is exact, so
    only the order of the adds matters):

    * one row (XLA's vectorised GEMV): four vectors of 8 lanes, ``k = 32 b
      + 8 a + l``, each lane summed over b in order, the four vectors added
      in order, then the 8 lanes by halving;
    * more rows and at most 16 experts: four accumulators over ``k mod 4``,
      each in order, added as ``(a0 + a1) + (a2 + a3)``;
    * otherwise in order over k (``torch.matmul`` sums so at these sizes).

    The same op sequence on the card, where each partial product is
    cuBLAS's."""
    n, K = a.shape
    E = w.shape[1]
    if n == 1 and E >= 16 and K % 32 == 0:
        part = [a[:, j::32] @ w[j::32] for j in range(32)]      # j = 8a + l
        vec = [part[l] for l in range(8)]
        for blk in range(1, 4):
            vec = [vec[l] + part[8 * blk + l] for l in range(8)]
        while len(vec) > 1:
            h = len(vec) // 2
            vec = [vec[l] + vec[l + h] for l in range(h)]
        return vec[0]
    if n > 1 and E <= 16 and K % 4 == 0:
        acc = [a[:, j::4] @ w[j::4] for j in range(4)]
        return (acc[0] + acc[1]) + (acc[2] + acc[3])
    return a @ w


def route(p, xt: torch.Tensor, cfg: MoEConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router of ``xt`` (n, d): (probs (n, E) f32, gate (n, k) f32, ids
    (n, k) int64).

    The router product takes the compute-dtype operands into float32
    without rounding its result (XLA folds the bf16 round trip of
    ``(xt @ router).astype(f32)``); the softmax is XLA's: the row max,
    XLA's exp (``kernels/ref.py::exp``), its row-sum order and a true
    division.  Top-k takes the lower index first among equal
    probabilities (``lax.top_k``): a stable descending sort."""
    k = cfg.top_k
    logits = _router_dot(xt.to(torch.float32),
                         p["router"].to(xt.dtype).to(torch.float32))
    z = ref.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = z / _xla_sum(z)
    gate, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, ids = gate[:, :k], ids[:, :k]
    gate = gate / torch.clamp_min(_xla_sum(gate), 1e-9)
    return probs, gate, ids


def _counts(flat: torch.Tensor, E: int) -> torch.Tensor:
    """Assignments per expert, (E,) int64, by a scatter-add (``bincount``
    on the card reads its input's maximum back to the host)."""
    return torch.zeros((E,), dtype=torch.int64, device=flat.device
                       ).scatter_add_(0, flat, torch.ones_like(flat))


def dispatch(ids: torch.Tensor, C: int, E: int):
    """Sort-based capacity dispatch of ``ids`` (n, k): (order (S,), tok
    (S,), keep (S,) bool, dest (S,)), S = n k, over the flat assignments in
    expert order (a stable sort: within an expert, earlier rows first).
    ``dest`` is the assignment's row of the ``(E C, d)`` buffer, or the
    overflow row ``E C`` for a dropped one."""
    k = ids.shape[1]
    flat = ids.reshape(-1)
    S = flat.shape[0]
    order = torch.argsort(flat, stable=True)
    sorted_ids = flat[order]
    tok = order // k
    counts = _counts(flat, E)
    offsets = torch.cumsum(counts, 0) - counts
    rank = torch.arange(S, device=ids.device) - offsets[sorted_ids]
    keep = rank < C
    dest = torch.where(keep, sorted_ids * C + rank,
                       torch.full_like(rank, E * C))
    return order, tok, keep, dest


def aux_loss(probs: torch.Tensor, ids: torch.Tensor, E: int) -> torch.Tensor:
    """The load-balancing loss ``E * sum(mean(probs) * frac(ids))``
    (Shazeer et al.) in the reference's compiled order: the column sums in
    XLA's reduction order (:func:`_xla_sum`) times 1/n, the assignment
    fractions as counts times 1/(n k), and their products summed as XLA's
    fused reduction does at these widths: over at most 16 experts in order
    for one row, else in 4 lanes (``e mod 4``) added by halving; over more
    experts by :func:`_xla_sum`."""
    n, k = ids.shape
    me = _xla_sum(probs.T)[:, 0] * (1.0 / n)
    ce = _counts(ids.reshape(-1), E).to(torch.float32) * (1.0 / (n * k))
    pr = me * ce
    if E > 16 or E % 4 or n == 1:
        return E * _xla_sum(pr)[0]
    lanes = _xla_sum(pr.reshape(E // 4, 4).T)[:, 0]
    return E * ((lanes[0] + lanes[2]) + (lanes[1] + lanes[3]))


# the per-call drop counts of moe_apply while a log is open (device
# tensors; nothing syncs): see :func:`drop_log`
_DROP_LOG: Optional[List[Dict[str, object]]] = None


def drop_log(enable: bool = True) -> Optional[List[Dict[str, object]]]:
    """Open (``enable``) or close a log of every :func:`moe_apply` call's
    capacity drops and router margin: a list of ``{"rows": n, "capacity":
    C, "assignments": n k, "dropped": 0-d device tensor, "dropped_rows":
    (n,) device tensor of each row's dropped assignments, "min_gap": 0-d
    device tensor}`` (``min_gap``: the smallest difference between a row's
    k-th and (k+1)-th router probability, where a near-tie could change the
    experts), appended without a host sync.  Returns the log (None when
    closing)."""
    global _DROP_LOG
    _DROP_LOG = [] if enable else None
    return _DROP_LOG


# ----------------------------------------------------------------------------
# Expert products
# ----------------------------------------------------------------------------
def _expert_matmul(eb: torch.Tensor, w) -> torch.Tensor:
    """(E, C, d) x (E, d, f) grouped product in eb's dtype.

    float: ``torch.bmm`` (the reference's einsum, outside any Pallas
    kernel): on the card the bf16 GEMM with float32 accumulation, on the
    CPU in float32 operands, in XLA's order, rounded once.
    ``QuantizedLinear`` (W4A8, the ITA datapath per expert): per-row int8
    activations with the compiled program's reciprocal scale, exact int32
    products with the INT4 codes, ``acc * x_scale * w_scale`` rounded once;
    one ``ops.w4a8_matmul`` per expert (the kernel on its packed codes on
    the card, the plain version on the CPU).  On ``meta`` (the dry run)
    the E launches of one shape are traced as one, weighted by E, and the
    stack reads E outputs of its shape."""
    if isinstance(w, quant.QuantizedLinear):
        E, C, d = eb.shape
        qx, xs = quant.quantize_activations_int8(eb.reshape(E * C, d),
                                                 reciprocal=True)
        qx, xs = qx.reshape(E, C, d), xs.reshape(E, C, 1)
        if build.is_meta(eb):
            with costs.repeat(E):
                y = ops.w4a8_matmul(qx[0], xs[0], w.codes[0], w.scales[0],
                                    out_dtype=eb.dtype)
            rest = torch.empty((E - 1,) + tuple(y.shape), dtype=y.dtype,
                               device=y.device)
            return torch.stack([y, *rest.unbind(0)])
        return torch.stack([
            ops.w4a8_matmul(qx[e], xs[e], w.codes[e], w.scales[e],
                            out_dtype=eb.dtype,
                            packed=None if w.packed is None else w.packed[e])
            for e in range(E)])
    w = w.to(eb.dtype)
    if build.on_card(eb):
        return torch.bmm(eb, w)
    # XLA's batched dot sums each output in order over d, in float32, and
    # rounds once; torch's float32 bmm does so from two rows up (one row
    # takes a GEMV that sums otherwise), its bf16 bmm does not
    E, C, _ = eb.shape
    a = eb.to(torch.float32)
    if C == 1:
        a = torch.nn.functional.pad(a, (0, 0, 0, 1))
    return torch.bmm(a, w.to(torch.float32))[:, :C].to(eb.dtype)


def _silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x), one op at a time in x's dtype as ``layers.silu``,
    with XLA's exp (``kernels/ref.py::exp``) rounded to x's dtype: the
    compiled expert SwiGLU rounds every step, and ``torch.exp``'s float32
    value rounds otherwise on a few entries."""
    e = ref.exp(-x).to(x.dtype)
    return x * (1.0 / (1.0 + e))


def moe_apply(p, x: torch.Tensor, cfg: MoEConfig, need_aux: bool = True,
              model=None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x: (B, T, d) -> (out (B, T, d) in x's dtype, aux f32 scalar, or None
    with ``need_aux=False``: the block tail discards it, as the compiled
    reference's dead-code elimination does).

    Every one of the ``B T`` rows is routed (:func:`route`) and dispatched
    (:func:`dispatch`) into zeroed ``(E C + 1, d)`` buffers (the last row
    takes every dropped assignment and is never read); each expert's
    SwiGLU runs on its ``C`` rows; the combine sums each token's kept
    outputs, weighted by its gates and rounded to x's dtype one by one,
    in the reference's scatter order.

    ``model`` (a training grid's "model" group) with expert stacks cut on
    their expert dim (``w1`` / ``w3`` / ``w2`` holding ``E / tp`` experts,
    the training rules' "expert" cut): expert parallelism.  Every rank
    routes and dispatches the whole of ``x`` (the same rows on every rank,
    so the same capacity, drops and ``aux``), runs its own experts' rows
    of the ``(E, C, d)`` buffer, and the ``(E / tp, C, d)`` outputs are
    gathered over the group (``gather_from``) before the combine, which
    every rank runs alike.  Only the dispatch reads ``x`` through
    ``copy_to`` (each rank's gradient covers its experts' rows, summed over
    the group); the router reads it as it is (its gradient is the same on
    every rank)."""
    B, T, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    ep = model is not None and model.size > 1 and p["w1"].shape[0] != E
    xt = x.reshape(-1, d)
    n = xt.shape[0]
    C = capacity(n, cfg)
    probs, gate, ids = route(p, xt, cfg)
    aux = aux_loss(probs, ids, E) if need_aux else None
    order, tok, keep, dest = dispatch(ids, C, E)
    if _DROP_LOG is not None:
        top = torch.topk(probs, min(k + 1, E), dim=-1).values
        lost = (~keep).to(torch.int64)
        _DROP_LOG.append({"rows": n, "capacity": C, "assignments": n * k,
                          "dropped": lost.sum(),
                          "dropped_rows": torch.zeros_like(tok).scatter_add_(
                              0, tok, lost)[:n],
                          "min_gap": (top[:, k - 1] - top[:, -1]).min()})

    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    buf[dest] = (copy_to(xt, model) if ep else xt)[tok]
    eb = buf[:-1].reshape(E, C, d)
    if ep:
        n_local = p["w1"].shape[0]
        eb = eb.narrow(0, model.rank * n_local, n_local)
    h = _expert_matmul(eb, p["w1"])
    g = _expert_matmul(eb, p["w3"])
    y = _expert_matmul(_silu(h) * g, p["w2"])
    if ep:
        y = gather_from(y, model, 0)
    y = y.reshape(E * C, d)

    # combine: contributions in sorted (expert) order, then each token's k
    # of them added in that order
    gathered = torch.where(keep[:, None],
                           y[torch.clamp(dest, max=E * C - 1)],
                           torch.zeros((), dtype=y.dtype, device=y.device))
    w_sorted = gate.reshape(-1)[order]
    contrib = (gathered.to(torch.float32) * w_sorted[:, None]).to(x.dtype)
    slots = torch.argsort(order).reshape(n, k).sort(dim=1).values
    out = torch.zeros((n, d), dtype=x.dtype, device=x.device)
    for i in range(k):
        out = out + contrib[slots[:, i]]
    return out.reshape(B, T, d), aux
