"""Wrapper of the W4A8 CUDA kernel (``csrc/w4a8_matmul.cu``).

Replaces the TPU kernel ``repro/kernels/w4a8_matmul.py::w4a8_matmul``.  The
kernel computes ``(qx . codes) * x_scale * w_scale`` with exact int32
accumulation and one round to bf16, bit-identical to
``kernels/ref.py::w4a8_matmul`` on the card.  It is bound by reading the
``K * N`` code bytes once (decode M is 1..8); see the source for the design.
Ragged M, N and K are masked in the kernel (the TPU kernel asserted tile
divisibility instead).

This wrapper takes CUDA tensors only and launches the kernel or raises;
``kernels/ops.py`` routes a CPU tensor to the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]
COLS_PER_BLOCK = 128     # csrc/w4a8_matmul.cu kColsPerBlock
MAX_KSLICE = 4096        # bounds the staged activation slice (MT * kslice bytes)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_shape(M: int, N: int, K: int, sm_count: int):
    """(m_tile, kslice, ksplit): the M tile is the smallest power of two
    >= min(M, 8); K is split so that about two blocks land on every SM."""
    m_tile = next(t for t in (1, 2, 4, 8) if t >= min(M, 8))
    nbx = -(-N // COLS_PER_BLOCK)
    ksplit = max(1, min(-(-2 * sm_count // nbx), -(-K // 16)))
    kslice = -(-(-(-K // ksplit)) // 16) * 16
    kslice = min(kslice, MAX_KSLICE)
    ksplit = -(-K // kslice)
    return m_tile, kslice, ksplit


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"w4a8_matmul kernel: {msg}")


def w4a8_matmul(qx: torch.Tensor, x_scale: torch.Tensor, codes: torch.Tensor,
                w_scale: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """qx (M,K) int8, x_scale (M,1) f32, codes (K,N) int8 in [-7,7],
    w_scale (N,) f32, all contiguous on one CUDA device -> (M,N) out_dtype
    (bf16 or f32)."""
    for name, t in (("qx", qx), ("x_scale", x_scale), ("codes", codes),
                    ("w_scale", w_scale)):
        _require(build.is_cuda(t), f"{name} must be a CUDA tensor, got "
                 f"{t.device} (CPU tensors take the plain version in ops)")
        _require(t.is_contiguous(), f"{name} must be contiguous")
        _require(t.device == qx.device, f"{name} is on {t.device}, qx on "
                 f"{qx.device}")
    _require(qx.dtype == torch.int8 and codes.dtype == torch.int8,
             f"qx/codes must be int8, got {qx.dtype}/{codes.dtype}")
    _require(x_scale.dtype == torch.float32 and w_scale.dtype == torch.float32,
             "scales must be float32")
    _require(qx.dim() == 2 and codes.dim() == 2, "qx and codes must be 2-D")
    M, K = qx.shape
    _require(codes.shape[0] == K, f"contraction mismatch {qx.shape} x "
             f"{tuple(codes.shape)}")
    N = codes.shape[1]
    _require(tuple(x_scale.shape) == (M, 1), f"x_scale must be ({M}, 1), got "
             f"{tuple(x_scale.shape)}")
    _require(tuple(w_scale.shape) == (N,), f"w_scale must be ({N},), got "
             f"{tuple(w_scale.shape)}")
    _require(out_dtype in (torch.bfloat16, torch.float32),
             f"out_dtype must be bfloat16 or float32, got {out_dtype}")
    _require(M > 0 and N > 0 and K > 0, f"empty operand {M}x{K}x{N}")
    fn = build.function("w4a8_matmul_launch", _ARGTYPES)
    dev = qx.device
    m_tile, kslice, ksplit = launch_shape(M, N, K, _sm_count(dev.index or 0))
    acc = torch.zeros((M, N), dtype=torch.int32, device=dev)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    vec4 = int(N % 4 == 0 and codes.data_ptr() % 4 == 0)
    rc = fn(qx.data_ptr(), x_scale.data_ptr(), codes.data_ptr(),
            w_scale.data_ptr(), acc.data_ptr(), out.data_ptr(), M, N, K,
            m_tile, kslice, ksplit, vec4, int(out_dtype == torch.float32),
            build.stream_handle(dev))
    build.check(rc, "w4a8_matmul")
    w4a8_matmul.launches += 1
    return out


w4a8_matmul.launches = 0
