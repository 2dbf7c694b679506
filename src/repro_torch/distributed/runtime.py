"""The tensor-parallel process group of the port, and the launcher that
runs one process per rank.

The JAX package is single-controller: one engine over a device mesh, which
its ops find as the ambient mesh (``jax``'s ``with mesh:``) and whose
gathers GSPMD inserts.  The port runs SPMD instead, one process per shard:
every rank builds the same engine over its own shard of the weights and KV
state, runs the same host scheduler and page allocator on the same
requests, and picks each token from the same all-gathered logits, so the
ranks stay in lockstep without control traffic.  The group is an explicit
:class:`TPGroup` handed to the engines as ``tp=``; nothing here is
ambient.

Devices and backends: with at least ``tp`` cards, rank r runs on ``cuda:r``
over NCCL; with fewer, the ranks share ``cuda:0`` over gloo, which takes
CUDA tensors for its all-gather and all-reduce (NCCL refuses two ranks on
one device); on the CPU, gloo.  :func:`plan` makes that choice from the
card count, and :func:`spawn` starts the ranks.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import socket
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# a rank blocked in a collective gives up after this long (the launcher
# ends every rank as soon as one fails, well before)
GROUP_TIMEOUT_S = 600


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
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        return parts

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The elementwise ``op`` ("sum" or "max") of every rank's ``x``, on
        every rank (in place on a contiguous ``x``, which is returned)."""
        x = x.contiguous()
        dist.all_reduce(x, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX}[op],
                        group=self.group)
        return x

    def barrier(self) -> None:
        dist.barrier(group=self.group)


def size_of(tp: Optional[TPGroup]) -> int:
    """The group's size, 1 for ``None``."""
    return 1 if tp is None else tp.size


def plan(tp: int, device) -> Tuple[str, List[str]]:
    """(backend, the device of each rank) for ``tp`` ranks on ``device``'s
    type: NCCL over one card per rank when the host has ``tp`` cards, else
    gloo, with every rank on ``cuda:0`` (the card shared) or on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return "gloo", ["cpu"] * tp
    if torch.cuda.device_count() >= tp:
        return "nccl", [f"cuda:{r}" for r in range(tp)]
    return "gloo", ["cuda:0"] * tp


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, tp, backend, device, init_method, args, queue):
    group = None
    try:
        group = TPGroup.init(tp, rank, backend, device, init_method)
        out = fn(group, *args)
        queue.put((rank, True, out))
    except BaseException:                         # reported to the parent
        queue.put((rank, False, traceback.format_exc()))
    finally:
        if group is not None:
            group.close()


def spawn(fn: Callable, tp: int, args: Sequence = (), *, backend: str,
          devices: Sequence, timeout: Optional[float] = None) -> List[Any]:
    """Run ``fn(group, *args)`` on ``tp`` new processes, one per rank, and
    return their results in rank order.

    ``fn`` and ``args`` must pickle (a module-level function; tensors are
    better passed as numpy arrays).  Rank r computes on ``devices[r]``.  If
    any rank raises or dies, or ``timeout`` seconds pass, every rank still
    running is ended and this raises ``RuntimeError`` with the failing
    rank's traceback: nothing goes on with the remaining ranks."""
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    init_method = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, tp, backend, str(devices[r]),
                               init_method, tuple(args), queue))
             for r in range(tp)]
    for p in procs:
        p.start()
    results: dict = {}
    failure = None
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while len(results) < tp and failure is None:
            while not queue.empty():
                rank, ok, out = queue.get()
                if not ok:
                    failure = f"rank {rank} raised:\n{out}"
                    break
                results[rank] = out
            if failure is not None or len(results) == tp:
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
        raise RuntimeError(f"tensor-parallel run failed: {failure}")
    return [results[r] for r in range(tp)]
