"""The process groups of the port (a tensor-parallel group, and the
``(data, model)`` grid of distributed training), and the launcher that runs
one process per rank.

The JAX package is single-controller: one engine over a device mesh, which
its ops find as the ambient mesh (``jax``'s ``with mesh:``) and whose
gathers GSPMD inserts.  The port runs SPMD instead, one process per shard:
every rank builds the same engine over its own shard of the weights and KV
state, runs the same host scheduler and page allocator on the same
requests, and picks each token from the same all-gathered logits, so the
ranks stay in lockstep without control traffic.  The group is an explicit
:class:`TPGroup` handed to the engines as ``tp=``; nothing here is
ambient.

Every run of ranks is a :class:`Grid`: ``dp x tp`` ranks in the JAX
mesh's order, row-major over ``(data, model)`` (rank ``d tp + m`` is data
index ``d``, model index ``m``), each with its world group and the
``"data"`` and ``"model"`` subgroups it belongs to.  Serving runs on the
``(1, tp)`` grid and hands its engines ``grid.model``.

Devices and backends: with at least as many cards as ranks, rank r runs on
``cuda:r`` over NCCL; with fewer, the ranks share ``cuda:0`` over gloo,
which takes CUDA tensors for its collectives by staging them through
pinned host memory (NCCL refuses two ranks on one device); on the CPU,
gloo.  :func:`plan` makes that choice from the card count, and
:func:`spawn` starts the ranks (gloo's ranks on a card with
:data:`GLOO_CUDA_ALLOC_CONF`).  Every
collective's host time is added to :data:`COLLECTIVES` (the seconds a rank
spends inside gloo or NCCL calls, read by ``chip_smoke.py``).
"""
from __future__ import annotations

import contextlib
import datetime
import math
import multiprocessing as mp
import os
import pickle
import socket
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# a rank blocked in a collective gives up after this long (the launcher
# ends every rank as soon as one fails, well before)
GROUP_TIMEOUT_S = 600

# the pinned-memory settings of gloo's ranks on a card: a CUDA tensor's
# collective is staged through pinned host memory, and registering those
# buffers from 8 threads took a granite-8b (2, 2) grid step on one H100
# from 7.9 to 6.2 s
GLOO_CUDA_ALLOC_CONF = ("pinned_use_cuda_host_register:True",
                        "pinned_num_register_threads:8")

# host seconds and calls inside this process's collectives (all groups)
COLLECTIVES = {"seconds": 0.0, "calls": 0}


def collective_stats(reset: bool = False) -> dict:
    """A copy of :data:`COLLECTIVES`; ``reset`` sets it to 0 after."""
    out = dict(COLLECTIVES)
    if reset:
        COLLECTIVES.update(seconds=0.0, calls=0)
    return out


class _timed:
    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        COLLECTIVES["seconds"] += time.perf_counter() - self.t0
        COLLECTIVES["calls"] += 1


@dataclass
class TPGroup:
    """One rank's view of a tensor-parallel group: the process group, this
    rank, the group's size, the backend and this rank's device."""

    group: Any
    rank: int
    size: int
    backend: str
    device: torch.device

    @classmethod
    def init(cls, tp: int, rank: int, backend: str, device,
             init_method: str) -> "TPGroup":
        """Join the group of ``tp`` ranks at ``init_method`` (for example
        ``tcp://127.0.0.1:<port>``) as ``rank``, over ``backend`` ("gloo"
        or "nccl"), computing on ``device``."""
        device = torch.device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(
            backend, init_method=init_method, world_size=int(tp),
            rank=int(rank),
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        return cls(dist.group.WORLD, int(rank), int(tp), backend, device)

    def close(self) -> None:
        """Leave the group (every rank calls it once, at the end)."""
        if dist.is_initialized():
            dist.destroy_process_group()

    def all_gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``x`` (same shape on every rank), in rank order."""
        x = x.contiguous()
        if self.size == 1:
            return [x]
        parts = [torch.empty_like(x) for _ in range(self.size)]
        with _timed():
            dist.all_gather(parts, x, group=self.group)
        return parts

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The elementwise ``op`` ("sum" or "max") of every rank's ``x``, on
        every rank (in place on a contiguous ``x``, which is returned)."""
        x = x.contiguous()
        if self.size == 1:
            return x
        with _timed():
            dist.all_reduce(x, op={"sum": dist.ReduceOp.SUM,
                                   "max": dist.ReduceOp.MAX}[op],
                            group=self.group)
        return x

    def reduce_scatter(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's block along ``dim`` of the elementwise sum of every
        rank's ``x`` (``x.shape[dim]`` divisible by the group's size)."""
        if self.size == 1:
            return x
        xm = x.movedim(dim, 0).contiguous()
        out = torch.empty((xm.shape[0] // self.size,) + tuple(xm.shape[1:]),
                          dtype=x.dtype, device=x.device)
        with _timed():
            dist.reduce_scatter_tensor(out, xm, group=self.group)
        return out.movedim(0, dim)

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``x`` (its rank in this group) on every rank, in
        place on a contiguous ``x``, which is returned."""
        x = x.contiguous()
        if self.size == 1:
            return x
        with _timed():
            dist.broadcast(x, src=dist.get_global_rank(self.group, src),
                           group=self.group)
        return x

    def broadcast_object(self, obj: Any = None, src: int = 0) -> Any:
        """Rank ``src``'s ``obj`` (anything that pickles) on every rank: its
        pickled length, then its bytes, in two broadcasts (on the card for
        NCCL, else through host memory).  The other ranks pass nothing."""
        if self.size == 1:
            return obj
        dev = self.device if self.backend == "nccl" else "cpu"
        data = pickle.dumps(obj) if self.rank == src else b""
        n = self.broadcast(torch.tensor([len(data)], dtype=torch.int64,
                                        device=dev), src)
        buf = (torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)
               if self.rank == src
               else torch.empty((int(n[0]),), dtype=torch.uint8, device=dev))
        return pickle.loads(self.broadcast(buf, src).cpu().numpy().tobytes())

    def abort(self) -> None:
        """Tear this rank's group down after a failure: a peer blocked in a
        collective of the group gets an error (gloo sees the closed
        connection) instead of waiting out :data:`GROUP_TIMEOUT_S`.  The
        group is unusable afterwards on every rank."""
        if dist.is_initialized():
            world = self.group is None or self.group == dist.group.WORLD
            dist.destroy_process_group(None if world else self.group)

    def clock(self, source: Optional[Callable[[], float]] = None) -> float:
        """Rank 0's reading of ``source`` (default ``time.perf_counter``),
        the same on every rank: the loop clock of a scheduler that the ranks
        run in lockstep (every rank calls it at the same point of the
        loop)."""
        dev = self.device if self.backend == "nccl" else "cpu"
        t = torch.tensor([(source or time.perf_counter)()],
                         dtype=torch.float64, device=dev)
        return float(self.broadcast(t)[0])

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier(group=self.group)


@dataclass
class Grid:
    """One rank's view of a ``(data, model)`` grid of ``dp x tp`` ranks:
    the world group (rank ``d tp + m``), its ``"data"`` subgroup (the ``dp``
    ranks of model index ``m``, ranked by ``d``) and its ``"model"``
    subgroup (the ``tp`` ranks of data index ``d``, ranked by ``m``)."""

    world: TPGroup
    data: TPGroup
    model: TPGroup

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.data.size, self.model.size)

    @property
    def rank(self) -> int:
        return self.world.rank

    @property
    def device(self) -> torch.device:
        return self.world.device

    @classmethod
    def init(cls, shape: Sequence[int], rank: int, backend: str, device,
             init_method: str) -> "Grid":
        """Join the world group of ``dp x tp`` ranks as ``rank`` (as
        :meth:`TPGroup.init`), then make every data and model subgroup:
        each rank makes all of them, in the same order, as
        ``torch.distributed.new_group`` requires.  A subgroup of the whole
        world is the world group, and one of a single rank has none (its
        collectives are the identity)."""
        dp, tp = (int(n) for n in shape)
        world = TPGroup.init(dp * tp, rank, backend, device, init_method)
        d, m = divmod(world.rank, tp)
        timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)

        def subgroup(members, mine, index):
            if len(members) == world.size:
                g = world.group
            elif len(members) == 1:
                g = None
            else:
                g = dist.new_group(members, timeout=timeout, backend=backend)
            return TPGroup(g, index, len(members), backend, world.device) \
                if mine else None

        data = [subgroup([j * tp + i for j in range(dp)], i == m, d)
                for i in range(tp)][m]
        model = [subgroup([j * tp + i for i in range(tp)], j == d, m)
                 for j in range(dp)][d]
        return cls(world, data, model)

    def close(self) -> None:
        self.world.close()


def size_of(tp: Optional[TPGroup]) -> int:
    """The group's size, 1 for ``None``."""
    return 1 if tp is None else tp.size


def plan(shape: Sequence[int], device) -> Tuple[str, List[str]]:
    """(backend, the device of each rank) for a grid of ``shape``
    ``(dp, tp)`` on ``device``'s type: NCCL over one card per rank when the
    host has that many cards, else gloo, with every rank on ``cuda:0`` (the
    card shared) or on the CPU."""
    n = math.prod(shape)
    device = torch.device(device)
    if device.type != "cuda":
        return "gloo", ["cpu"] * n
    if torch.cuda.device_count() >= n:
        return "nccl", [f"cuda:{r}" for r in range(n)]
    return "gloo", ["cuda:0"] * n


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, shape, backend, device, init_method, args, queue):
    grid = None
    try:
        grid = Grid.init(shape, rank, backend, device, init_method)
        out = fn(grid, *args)
        queue.put((rank, True, out))
    except BaseException:                         # reported to the parent
        queue.put((rank, False, traceback.format_exc()))
    finally:
        if grid is not None:
            grid.close()


@contextlib.contextmanager
def _rank_env(backend: str, devices: Sequence) -> Iterator[None]:
    """The environment the ranks start with: gloo's ranks on a card get
    :data:`GLOO_CUDA_ALLOC_CONF` added to ``PYTORCH_CUDA_ALLOC_CONF``
    (read when a rank's CUDA allocator starts); the caller's own is
    restored after."""
    key = "PYTORCH_CUDA_ALLOC_CONF"
    conf = os.environ.get(key)
    if backend == "gloo" and any(torch.device(d).type == "cuda"
                                 for d in devices):
        os.environ[key] = ",".join(([conf] if conf else [])
                                   + list(GLOO_CUDA_ALLOC_CONF))
    try:
        yield
    finally:
        if conf is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = conf


def spawn(fn: Callable, shape: Sequence[int], args: Sequence = (), *,
          backend: str, devices: Sequence,
          timeout: Optional[float] = None) -> List[Any]:
    """Run ``fn(grid, *args)`` on ``dp x tp`` new processes, one per rank of
    a :class:`Grid` of ``shape`` ``(dp, tp)``, and return their results in
    rank order.

    ``fn`` and ``args`` must pickle (a module-level function; tensors are
    better passed as numpy arrays).  Rank r computes on ``devices[r]``.  If
    any rank raises or dies, or ``timeout`` seconds pass, every rank still
    running is ended and this raises ``RuntimeError`` with the failing
    rank's traceback: nothing goes on with the remaining ranks."""
    shape = tuple(int(n) for n in shape)
    n = math.prod(shape)
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    init_method = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, shape, backend, str(devices[r]),
                               init_method, tuple(args), queue))
             for r in range(n)]
    with _rank_env(backend, devices):
        for p in procs:
            p.start()
    results: dict = {}
    failure = None
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while len(results) < n and failure is None:
            while not queue.empty():
                rank, ok, out = queue.get()
                if not ok:
                    failure = f"rank {rank} raised:\n{out}"
                    break
                results[rank] = out
            if failure is not None or len(results) == n:
                break
            dead = [r for r, p in enumerate(procs)
                    if p.exitcode not in (None, 0) and r not in results]
            if dead and queue.empty():
                failure = (f"rank {dead[0]} exited with code "
                           f"{procs[dead[0]].exitcode} without a result")
            elif deadline is not None and time.monotonic() > deadline:
                failure = f"the ranks did not finish within {timeout} s"
            else:
                time.sleep(0.01)
    finally:
        for p in procs:
            if failure is not None and p.is_alive():
                p.terminate()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    if failure is not None:
        raise RuntimeError(f"distributed run failed: {failure}")
    return [results[r] for r in range(n)]
