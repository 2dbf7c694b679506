"""Fault-tolerant checkpoints in the JAX package's on-disk layout.

The JAX package's ``ckpt/manager.py`` for trees of tensors, with the same
guarantees and files, so that each package reads the other's checkpoints:

  * **Atomicity**: a save writes ``<dir>/tmp.<step>.<pid>/arrays.npz`` (one
    array per leaf, keyed by its path string) and an fsync'd
    ``manifest.json``, then renames the directory to ``<dir>/step_<step>``;
    a crash mid-write never leaves a ``step_<n>`` without its manifest,
    and only a directory with a manifest counts as a checkpoint.
  * **Keep-k**: older checkpoints are removed after a successful save,
    never before.
  * **Restore onto the like tree's device**: ``restore(like)`` rebuilds
    ``like``'s structure with each leaf on that leaf's device.
  * **Preemption hook**: ``save_on_signal`` installs a SIGTERM handler that
    writes a final checkpoint synchronously.
  * **Async**: the device-to-host copy is synchronous, the write runs on a
    background thread (one in flight; ``wait()`` joins it).

Leaf keys are the JAX package's ``_flatten_with_paths`` strings: dict keys
(sorted), list indices, and ``.q`` / ``.scale`` for an int8 moment
(``train/optimizer.py::QMoment``).  Training state is float32, int8 and
int32; any other leaf dtype raises (numpy has no bfloat16).

A checkpoint of a training grid is layout-free, as the JAX package's is:
``save(..., layout=, cuts=)`` gathers every leaf whole (every rank calls
it) and rank 0 writes, and ``restore(..., layout=, cuts=)`` reads the
whole leaves and keeps each rank's block.  So a state saved at ``(2, 2)``
restores at ``(1, 1)``, and the reverse, bit for bit.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import signal
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import flat_cuts
from repro_torch.train.optimizer import leaves, rebuild

_DTYPES = (torch.float32, torch.int8, torch.int32)


def _host(key: str, t) -> np.ndarray:
    """A leaf copied to a host numpy array (a copy: the params change in
    place while an async save writes)."""
    if not torch.is_tensor(t):
        raise TypeError(f"checkpoint leaf {key} is not a tensor: {type(t)}")
    if t.dtype not in _DTYPES:
        raise TypeError(
            f"checkpoint leaf {key} is {t.dtype}: the training state is "
            f"float32, int8 and int32, and numpy has no bfloat16; cast it "
            "first")
    return t.detach().to("cpu", copy=True).numpy()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = False):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Dict[str, Any],
             metadata: Optional[Dict[str, Any]] = None, layout=None,
             cuts=None) -> str:
        """Write ``tree`` as step ``step``.  ``layout`` / ``cuts`` (a
        training grid's ``sharding.Layout`` and the cut tree of ``tree``):
        the leaves are a rank's blocks; every rank calls this, the whole
        leaves are gathered and rank 0 writes them."""
        if layout is not None:
            with torch.no_grad():
                tree = layout.gather_tree(tree, cuts)
            if layout.grid.rank != 0:
                return os.path.join(self.directory, f"step_{step}")
        host = {k: _host(k, t) for k, t in leaves(tree)}
        if self.async_save:
            self.wait()  # one in-flight save at a time
            self._thread = threading.Thread(
                target=self._write_async, args=(step, host, metadata or {}))
            self._thread.start()
        else:
            self._write(step, host, metadata or {})
        return os.path.join(self.directory, f"step_{step}")

    def wait(self) -> None:
        """Join the in-flight save; re-raise its error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("the background checkpoint save failed"
                               ) from err

    def _write_async(self, step, host, metadata) -> None:
        try:
            self._write(step, host, metadata)
        except BaseException as e:      # surfaced by the next wait()
            self._error = e

    def _write(self, step: int, host: Dict[str, np.ndarray],
               metadata: Dict[str, Any]) -> None:
        final = os.path.join(self.directory, f"step_{step}")
        tmp = os.path.join(self.directory, f"tmp.{step}.{os.getpid()}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        manifest = {"step": step, "keys": sorted(host), "metadata": metadata}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.directory, name,
                                                 "manifest.json")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Dict[str, Any], step: Optional[int] = None,
                layout=None, cuts=None
                ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Restore into the structure of ``like``: each leaf a new tensor
        with the like leaf's dtype and device (a dtype that differs
        raises).  Returns (tree, the save's metadata).  ``layout`` /
        ``cuts``: ``like`` holds a grid rank's blocks, and each leaf is
        read whole and cut to the rank's block."""
        where = {} if layout is None else flat_cuts(cuts)
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        values = {}
        with np.load(os.path.join(d, "arrays.npz")) as data:
            for key, t in leaves(like):
                if key not in data:
                    raise KeyError(f"checkpoint missing leaf {key}")
                got = torch.from_numpy(data[key])
                if layout is not None:
                    got = layout.block(got, where[key])
                if got.dtype != t.dtype or tuple(got.shape) != tuple(t.shape):
                    raise ValueError(
                        f"checkpoint leaf {key} is {got.dtype} "
                        f"{tuple(got.shape)}, the like tree's {t.dtype} "
                        f"{tuple(t.shape)}")
                values[key] = got.to(t.device)
        return rebuild(like, values), manifest["metadata"]

    # ------------------------------------------------------------ preemption
    def save_on_signal(self, get_state: Callable[[], Tuple[int, Dict[str, Any]]],
                       sig=signal.SIGTERM) -> None:
        """Install a preemption handler: on ``sig``, write a final checkpoint
        synchronously and exit with code 143."""

        def handler(signum, frame):
            step, tree = get_state()
            self.wait()
            self.async_save = False
            self.save(step, tree, metadata={"preempted": True})
            raise SystemExit(143)

        signal.signal(sig, handler)
