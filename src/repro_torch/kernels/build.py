"""Build and load the port's CUDA kernels: ``csrc/*.cu`` -> one shared library.

Each source is compiled by its own ``nvcc`` process, all started together,
for ``sm_90a`` (``-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3``,
with ``-Xptxas -v`` so the registers, shared memory and spills of every
kernel are kept in a log), then linked into one library with a plain C
interface and loaded with ``ctypes``.  No ``--use_fast_math``: the W4A8
epilogue must round exactly like the plain version.

The build happens at first use, into ``build/`` beside the sources (listed
in ``.gitignore``), under a name keyed on the sources' hash, so a changed
source rebuilds and an unchanged one is loaded as it is.  A missing
``nvcc`` or a failed compile raises: nothing falls back to the plain
versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib: Optional[ctypes.CDLL] = None


def is_cuda(t: torch.Tensor) -> bool:
    """Whether ``t`` lies on a CUDA device — the one rule the dispatcher
    and the kernel wrappers use to choose between kernel and plain version."""
    return t.device.type == "cuda"


def is_meta(t: torch.Tensor) -> bool:
    """Whether ``t`` is a ``meta`` tensor (shape and dtype only): the dry
    run's, which the dispatcher counts instead of computing."""
    return t.device.type == "meta"


def on_card(t: torch.Tensor) -> bool:
    """Whether a plain op with a device-dependent form takes the card's
    form for ``t``: on a CUDA device, or on ``meta``, which the dry run
    counts as the card."""
    return t.device.type in ("cuda", "meta")


def wants_grad(*tensors) -> bool:
    """Whether grad mode is on and an operand (None: absent) requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors) -> None:
    """Raise if :func:`wants_grad`: a kernel wrapper's output has no
    autograd history, so returning it would silently drop the operands'
    gradients.  The differentiable forms are in ``kernels/ops.py`` (flash
    attention and the RWKV6 scan); the other kernels serve inference
    only."""
    if wants_grad(*tensors):
        raise RuntimeError(
            f"{name} kernel: an operand requires grad and the kernel has no "
            "backward; call it under torch.no_grad(), or through "
            "kernels/ops.py where the op has a differentiable form")


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on the PATH, or
    the toolkit's default location; raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked at $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the repro_torch CUDA kernels cannot be built, and a CUDA tensor has "
        "no other path")


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest(srcs: List[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(force: bool = False) -> Dict[str, Any]:
    """Compile (or find already compiled) the kernel library.

    Returns ``{"path", "seconds", "cached", "log"}``: ``log`` is the
    compiler's output, ``-Xptxas -v`` report included."""
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    tag = _digest(srcs)
    lib_path = BUILD_DIR / f"librepro_torch_kernels_{tag}.so"
    log_path = lib_path.with_suffix(".log")
    if lib_path.exists() and log_path.exists() and not force:
        return {"path": str(lib_path), "seconds": 0.0, "cached": True,
                "log": log_path.read_text()}
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    uniq = f"{os.getpid()}_{tag}"
    objs = [BUILD_DIR / f"{p.stem}_{uniq}.o" for p in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for src, obj in zip(srcs, objs)]
    logs, failed = [], []
    for src, proc in zip(srcs, procs):
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = BUILD_DIR / f"tmp_{uniq}.so"
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernel library failed:\n"
                           f"{link.stdout}{link.stderr}")
    log = "\n".join(logs)
    log_path.write_text(log)
    os.replace(tmp, lib_path)
    return {"path": str(lib_path), "seconds": time.perf_counter() - t0,
            "cached": False, "log": log}


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use (raises on failure)."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(build()["path"])
    return _lib


def function(name: str, argtypes) -> Any:
    """A C entry point of the library with its ctypes signature set; every
    entry point returns the ``cudaError_t`` of its launches as an int."""
    fn = getattr(library(), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``, as the C launchers take it."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
