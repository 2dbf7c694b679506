"""Roofline terms of one rank's step, counted while the step runs on the
``meta`` device: the port's counterpart of the JAX package's
``launch/hlo_analysis.py``.

The JAX package parses the HLO of a compiled SPMD program.  PyTorch
produces no HLO, so the port runs one rank's step eagerly on meta tensors
(shapes and dtypes, no data, nothing allocated on any device) under
:class:`Tally`, a ``TorchDispatchMode`` that sees every aten op the card
would run:

  * FLOPs: every matmul-family op (``mm``, ``addmm``, ``bmm``,
    ``baddbmm``, ``mv``, ``dot``) = 2 x output elements x the contracted
    size, the rule of ``hlo_analysis``'s ``dot``; plus each CUDA kernel's
    own record (``kernels/costs.py``: a kernel entry of ``kernels/ops.py``
    on meta tensors records the work of its launch and returns empty
    outputs);
  * HBM bytes under the eager convention, the program the card runs with
    no fusion: an op reads its operands and writes its result; views and
    metadata ops are free; an in-place write into a slice (``copy_``,
    ``index_put_``, the scatters) counts the update twice, like
    ``dynamic-update-slice``; ``index_select``, ``gather``, ``embedding``
    and advanced indexing count their result twice.  This is NOT XLA's
    fusion-aware convention, so the bytes are not comparable with the JAX
    package's; the FLOPs are;
  * ``mem_by_kind``: bytes by aten op family (and by kernel name);
  * collectives: the stand-in groups (:class:`StandInGroup`) record each
    call's per-chip wire bytes and count by kind with ``hlo_analysis``'s
    factors: all-reduce 2x, all-gather the result once, reduce-scatter
    (g - 1) x the result, broadcast once;
  * memory: the step's argument bytes (the rank's params, optimizer state,
    cache and inputs, summed exactly by storage), its output bytes, and the
    high-water mark of the storages made during the step (each tracked
    until it dies, ``weakref.finalize``).

A value read to the host (``.item()``, ``int(t)``, ``bool(t)``) has no
data on meta: :class:`Tally` (and :func:`host_reads` around set-up code)
answers it with 0 and records where it was read.

The loops that the port runs in Python over time, and over alike steps
(a MoE layer's experts under LAQ, the sequence-cut decode's combine over
ranks), are traced once and weighted by their trip count
(``costs.repeat``), as ``hlo_analysis`` weights a ``while`` body by
``known_trip_count``.
"""
from __future__ import annotations

import traceback
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import costs

aten = torch.ops.aten

_COLL_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute", "broadcast")
# metadata ops that move no bytes besides the views
_FREE = {aten.empty.memory_format, aten.empty_strided.default,
         aten.empty_like.default, aten.new_empty.default,
         aten.new_empty_strided.default, aten._unsafe_view.default,
         aten._local_scalar_dense.default, aten.lift_fresh.default,
         aten.detach.default, aten.alias.default,
         aten.set_.source_Storage_storage_offset}
_GATHERS = {aten.index_select.default, aten.gather.default,
            aten.embedding.default, aten.index.Tensor}
# in-place writes of an update into part of a tensor: (update argument)
_UPDATES = {aten.copy_.default: 1, aten.index_put_.default: 2,
            aten._index_put_impl_.default: 2, aten.scatter_.src: 3,
            aten.scatter_add_.default: 3, aten.index_add_.default: 3,
            aten.index_copy_.default: 3}


def nbytes(t: torch.Tensor) -> int:
    """The bytes a tensor (or view) spans: a broadcast (stride 0) dim is
    read once."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def tree_tensors(tree) -> List[torch.Tensor]:
    """Every tensor of a params / state / cache tree (dicts, lists, tuples,
    named tuples and objects with tensor fields, such as QuantizedLinear)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_tensors(v)]
    if hasattr(tree, "__dict__") and not isinstance(tree, type):
        return [t for v in vars(tree).values()
                if isinstance(v, (torch.Tensor, dict, list, tuple))
                for t in tree_tensors(v)]
    return []


def storage_bytes(tree) -> int:
    """The bytes of the distinct storages that ``tree``'s tensors use."""
    seen = {}
    for t in tree_tensors(tree):
        st = t.untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _matmul_flops(func, args, out) -> float:
    if func in (aten.mm.default, aten.bmm.default, aten.mv.default,
                aten.dot.default):
        a = args[0]
    elif func in (aten.addmm.default, aten.baddbmm.default):
        a = args[1]
    else:
        return 0.0
    return 2.0 * out.numel() * a.shape[-1]


def _site() -> str:
    """The first frame outside torch and this module: where a host read
    happened."""
    for fr in reversed(traceback.extract_stack()[:-3]):
        if "/torch/" not in fr.filename and not fr.filename.endswith(
                "op_analysis.py"):
            return f"{fr.filename.rsplit('/src/', 1)[-1]}:{fr.lineno}"
    return "?"


class _HostReads(TorchDispatchMode):
    """Answers a host read of a meta tensor with 0 and records its site."""

    def __init__(self):
        super().__init__()
        self.host_reads: Dict[str, int] = {}

    def _host_read(self, func, args) -> bool:
        if func is aten._local_scalar_dense.default and args[0].is_meta:
            site = _site()
            self.host_reads[site] = self.host_reads.get(site, 0) + 1
            return True
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self._host_read(func, args):
            return 0
        return func(*args, **(kwargs or {}))


def host_reads() -> _HostReads:
    """A dispatch mode for set-up code on meta tensors (building a rank's
    params): host reads answered with 0, nothing counted."""
    return _HostReads()


class Tally(_HostReads):
    """Counts one traced step (module docstring).  Use as a context
    manager around the step; :meth:`hold` the step's arguments first."""

    def __init__(self):
        super().__init__()
        self.weight = 1.0
        self.flops = 0.0
        self.mem_bytes = 0.0
        self.mem_by_kind: Dict[str, float] = {}
        self.kernel_calls: Dict[str, float] = {}
        self.kernel_flops = 0.0
        self.coll: Dict[str, float] = {k: 0.0 for k in _COLL_KINDS}
        self.coll_counts: Dict[str, float] = {k: 0.0 for k in _COLL_KINDS}
        self.live = 0
        self.peak = 0
        self._known: Dict[int, int] = {}
        self._rec = None

    # -- the step's arguments and outputs -----------------------------------
    def hold(self, *trees) -> None:
        """Mark ``trees`` (the step's params, state, cache and inputs) as
        its arguments: their storages are not temporaries."""
        for t in tree_tensors(trees):
            st = t.untyped_storage()
            if id(st) not in self._known:
                self._known[id(st)] = 0
                weakref.finalize(st, self._free, id(st))

    # -- what kernels and groups report ----------------------------------------
    def kernel(self, name: str, flops: float, nbytes_: float) -> None:
        w = self.weight
        self.kernel_calls[name] = self.kernel_calls.get(name, 0) + w
        self.kernel_flops += w * flops
        self.flops += w * flops
        self._bytes(name, w * nbytes_)

    def collective(self, kind: str, wire_bytes: float) -> None:
        self.coll[kind] += self.weight * wire_bytes
        self.coll_counts[kind] += self.weight

    def _bytes(self, kind: str, b: float) -> None:
        self.mem_bytes += b
        self.mem_by_kind[kind] = self.mem_by_kind.get(kind, 0.0) + b

    # -- the dispatch mode ---------------------------------------------------
    def __enter__(self):
        self._rec = costs.recording(self)
        self._rec.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._rec.__exit__(*exc)

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in self._known:
                continue
            n = st.nbytes()
            self._known[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._known.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._host_read(func, args):
            return 0
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        self._track(out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        w = self.weight
        kind = func.overloadpacket.__name__
        outs = _tensors(out)
        if outs:
            self.flops += w * _matmul_flops(func, args, outs[0])
        if func in _FREE or _is_view(func):
            return
        if func in _UPDATES:
            upd = args[_UPDATES[func]] if len(args) > _UPDATES[func] else None
            b = 2 * nbytes(upd) if isinstance(upd, torch.Tensor) else 0
            if func in (aten.index_put_.default,
                        aten._index_put_impl_.default):
                b += sum(nbytes(t) for t in _tensors(args[1]))
            self._bytes(kind, w * b)
            return
        if func in _GATHERS:
            self._bytes(kind, w * 2 * sum(nbytes(t) for t in outs))
            return
        ins = _tensors(list(args) + list(kwargs.values()))
        if func in (aten.fill_.Scalar, aten.fill_.Tensor, aten.zero_.default):
            ins = []
        self._bytes(kind, w * (sum(nbytes(t) for t in ins)
                               + sum(nbytes(t) for t in outs)))

    # -- the result ----------------------------------------------------------
    def totals(self) -> "Totals":
        return Totals(
            flops_per_chip=self.flops, mem_bytes_per_chip=self.mem_bytes,
            coll_bytes_per_chip=sum(self.coll.values()),
            coll_by_kind=dict(self.coll), coll_counts=dict(self.coll_counts),
            mem_by_kind=dict(self.mem_by_kind))


@dataclass
class Totals:
    """``hlo_analysis.HloTotals``' fields, per rank (chip)."""
    flops_per_chip: float
    mem_bytes_per_chip: float
    coll_bytes_per_chip: float
    coll_by_kind: Dict[str, float]
    coll_counts: Dict[str, float]
    mem_by_kind: Dict[str, float] = field(default_factory=dict)


# ----------------------------------------------------------------------------
# Stand-in groups: a rank's collectives on meta tensors, counted
# ----------------------------------------------------------------------------
def _tally() -> Optional[Tally]:
    sink = costs.active()
    return sink if isinstance(sink, Tally) else None


class StandInGroup:
    """One rank's view of a group of ``size`` ranks with
    ``runtime.TPGroup``'s methods, for a step traced on one process: a
    collective returns tensors of the right shapes (empty, for meta
    inputs; ``x`` itself where the real group's result would be ``x``)
    and records its per-chip wire bytes to the active :class:`Tally`.  A
    group of one rank is the identity, as ``TPGroup``'s, on any device."""

    backend = "stand-in"

    def __init__(self, size: int, rank: int = 0, device="meta"):
        self.group = None
        self.size = int(size)
        self.rank = int(rank)
        self.device = torch.device(device)

    def _record(self, kind: str, wire: float) -> None:
        t = _tally()
        if t is not None:
            t.collective(kind, wire)

    def all_gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = x.contiguous()
        if self.size == 1:
            return [x]
        self._record("all-gather", self.size * nbytes(x))
        return [x] + [torch.empty_like(x) for _ in range(self.size - 1)]

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        x = x.contiguous()
        if self.size > 1:
            self._record("all-reduce", 2 * nbytes(x))
        return x

    def reduce_scatter(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        if self.size == 1:
            return x
        xm = x.movedim(dim, 0).contiguous()
        out = torch.empty((xm.shape[0] // self.size,) + tuple(xm.shape[1:]),
                          dtype=x.dtype, device=x.device)
        self._record("reduce-scatter", (self.size - 1) * nbytes(out))
        return out.movedim(0, dim)

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        x = x.contiguous()
        if self.size > 1:
            self._record("broadcast", nbytes(x))
        return x

    def broadcast_object(self, obj: Any = None, src: int = 0) -> Any:
        return obj

    def clock(self, source=None) -> float:
        return 0.0

    def barrier(self) -> None:
        pass

    def abort(self) -> None:
        pass

    def close(self) -> None:
        pass


def stand_in_grid(shape, device="meta"):
    """Rank 0 of a ``(dp, tp)`` grid of stand-in groups: a
    ``runtime.Grid`` whose world, "data" and "model" groups are
    :class:`StandInGroup`."""
    from repro_torch.distributed.runtime import Grid
    dp, tp = (int(n) for n in shape)
    return Grid(world=StandInGroup(dp * tp, 0, device),
                data=StandInGroup(dp, 0, device),
                model=StandInGroup(tp, 0, device))


# ----------------------------------------------------------------------------
# The roofline
# ----------------------------------------------------------------------------
PEAK_FLOPS = costs.BF16_FLOPS_PER_S   # H100 SXM, dense bf16
HBM_BW = costs.HBM_BYTES_PER_S        # H100 SXM HBM3
LINK_BW = 50e9    # bytes/s per card (400 Gb/s NDR InfiniBand, conservative)


@dataclass
class Roofline:
    """The JAX package's ``hlo_analysis.Roofline``: the same fields,
    properties and ``as_dict`` keys, with the peaks as fields (an H100's by
    default; a test can give the TPU v5e's)."""
    hlo_flops: float              # whole-program FLOPs (global = per-chip x chips)
    hlo_bytes: float              # whole-program HBM bytes (global)
    coll_bytes_per_chip: float    # per-chip wire bytes
    chips: int
    model_flops: float            # 6*N*D (train) / 2*N_active*D (inference)
    model_bytes: float = 0.0      # minimum necessary HBM traffic (global)
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    link_bw: float = LINK_BW

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * self.peak_flops)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * self.hbm_bw)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_chip / self.link_bw

    @property
    def bottleneck(self) -> str:
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_collective}
        return max(ts, key=ts.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_frac(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def t_ideal(self) -> float:
        """The slower of (useful FLOPs at peak) and (minimum-necessary
        bytes at full HBM bandwidth)."""
        t_c = self.model_flops / (self.chips * self.peak_flops)
        t_m = self.model_bytes / (self.chips * self.hbm_bw)
        return max(t_c, t_m)

    @property
    def roofline_frac(self) -> float:
        """t_ideal / t_bound."""
        return self.t_ideal / self.t_bound if self.t_bound else 0.0

    def as_dict(self) -> Dict[str, float]:
        return {
            "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "coll_bytes_per_chip": self.coll_bytes_per_chip,
            "chips": self.chips,
            "model_flops": self.model_flops,
            "model_bytes": self.model_bytes,
            "t_ideal_s": self.t_ideal,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_frac": self.useful_flops_frac,
            "roofline_frac": self.roofline_frac,
        }
