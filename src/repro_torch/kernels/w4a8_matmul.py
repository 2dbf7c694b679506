"""Wrapper of the W4A8 CUDA kernel (``csrc/w4a8_matmul.cu``) and the
kernel's own weight layout.

Replaces the TPU kernel ``repro/kernels/w4a8_matmul.py::w4a8_matmul``.  The
kernel computes ``(qx . codes) * x_scale * w_scale`` with exact int32
accumulation on the int8 tensor cores and one round to bf16, bit-identical
to ``kernels/ref.py::w4a8_matmul`` on the card.  At decode M (1..8) it is
bound by reading the INT4 codes once, which :func:`pack_codes` stores two
per byte in the order the kernel's MMA fragments want them; most launches
are small enough that a launch's fixed cost sets much of the rest.  One
launch per call: the K split meets inside a thread-block cluster, with no
workspace and no memset.  See the source for the design.  Ragged M, N and K
are masked in the kernel (the TPU kernel asserted tile divisibility).

The weights are immutable, so the packed layout is made once, beside the
``(K, N)`` int8 codes that the plain version and the CPU path keep using
(``core/quant.py::QuantizedLinear.packed``); this wrapper raises when a call
has none and never packs per call.  It takes CUDA tensors only and launches
the kernel or raises; ``kernels/ops.py`` routes a CPU tensor to the plain
version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]
TILE_N = 16           # csrc/w4a8_matmul.cu kTileN: weight rows of one MMA tile
TILE_K = 64           # kTileK: K of one packed tile (two k32 MMAs)
TILE_M = 8            # kTileM: activation rows per block (the MMA's n = 8)
WARPS = 8             # kWarps
MAX_CLUSTER = 8       # the portable cluster size
MAX_K = 65536         # keeps 16 * sum |qx * code| below 2^31
WARPS_PER_SM = 16     # the split aims at two blocks of 8 warps per SM


def packed_shape(K: int, N: int):
    """The packed layout of a (K, N) code matrix: (n tiles of 16, k tiles of
    64, 32 lanes, 16 bytes) uint8."""
    return (-(-N // TILE_N), -(-K // TILE_K), 32, 16)


def pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """(..., K, N) int8 INT4 codes in [-8, 7] -> the kernel's layout,
    ``(...,) + packed_shape(K, N)`` uint8, on the codes' device.

    Two codes per byte; K padded to 64 and N to 16 with zero codes.  In the
    (16 n x 64 k) tile of n tile ``a`` and k tile ``c``, lane ``4g + t``
    holds 16 bytes; byte ``4j + b`` carries code(k = 64c + 16t + 4j + b,
    n = 16a + g) in its low nibble and code(same k, n = 16a + g + 8) in its
    high nibble, two's complement -- the A fragments of the lane's two
    m16n8k32 MMAs in one 16-byte load, in the k order in which the lane
    reads its activations (bytes 16t .. 16t + 15 of the tile).  Called once per weight matrix when
    the device weights are built (``pack_codes.calls`` counts the calls)."""
    if codes.dtype != torch.int8 or codes.dim() < 2:
        raise ValueError(f"pack_codes: (..., K, N) int8 codes, got "
                         f"{codes.dtype} {tuple(codes.shape)}")
    if codes.numel() and (int(codes.min()) < -8 or int(codes.max()) > 7):
        raise ValueError("pack_codes: a code outside the INT4 range [-8, 7]")
    pack_codes.calls += 1
    *lead, K, N = codes.shape
    nt, kt, _, _ = packed_shape(K, N)
    c = torch.zeros((*lead, kt * TILE_K, nt * TILE_N), dtype=torch.int8,
                    device=codes.device)
    c[..., :K, :N] = codes
    nd = len(lead)
    # k = 64c + 16t + 8s + 4h + b (word j = 2s + h); n = 16a + 8hi + g
    c = c.reshape(*lead, kt, 4, 2, 2, 4, nt, 2, 8)
    c = c.permute(*range(nd), *(nd + i for i in (5, 0, 7, 1, 2, 3, 4, 6)))
    nib = (c & 0xF).to(torch.uint8)
    return (nib[..., 0] | (nib[..., 1] << 4)).reshape(
        *lead, nt, kt, 32, 16).contiguous()


pack_codes.calls = 0


def unpack_codes(packed: torch.Tensor, K: int, N: int) -> torch.Tensor:
    """The inverse of :func:`pack_codes`: (..., n tiles, k tiles, 32, 16)
    uint8 -> (..., K, N) int8 codes."""
    *lead, nt, kt, lanes, nbytes = packed.shape
    if (nt, kt, lanes, nbytes) != packed_shape(K, N) or packed.dtype != torch.uint8:
        raise ValueError(f"unpack_codes: {packed.dtype} {tuple(packed.shape)} "
                         f"is not the packed layout of ({K}, {N}) codes")
    nib = torch.stack([packed & 0xF, packed >> 4], dim=-1).to(torch.int8)
    nib = (nib ^ 8) - 8                                  # sign-extend 4 bits
    nd = len(lead)
    c = nib.reshape(*lead, nt, kt, 8, 4, 2, 2, 4, 2)     # (a, c, g, t, s, h, b, hi)
    c = c.permute(*range(nd), *(nd + i for i in (1, 3, 4, 5, 6, 0, 7, 2)))
    return c.reshape(*lead, kt * TILE_K, nt * TILE_N)[..., :K, :N].contiguous()


class Plan(NamedTuple):
    """How one call is cut: ``wn`` n tiles x ``wk`` K ranges per block of 8
    warps, ``ck`` blocks per cluster along K; the grid follows."""
    wn: int
    wk: int
    ck: int
    grid: tuple


@functools.lru_cache(maxsize=256)
def launch_plan(M: int, N: int, K: int, sm_count: int) -> Plan:
    """The launch plan of an (M, K) x (K, N) call, from shapes only.

    The K split per n tile aims at ``WARPS_PER_SM * sm_count`` warps over the
    call's (16 x 64) tiles: inside a block first (``wk``, a power of two,
    the rest of the 8 warps taking neighbouring n tiles), then over the
    blocks of a cluster (``ck``)."""
    if not 0 < K <= MAX_K:
        raise ValueError(f"w4a8_matmul kernel: K {K} outside 1..{MAX_K}")
    n_tiles, k_tiles = packed_shape(K, N)[:2]
    per_warp = max(1, -(-n_tiles * k_tiles // (WARPS_PER_SM * sm_count)))
    split = max(1, -(-k_tiles // per_warp))
    wk = min(WARPS, 1 << (split.bit_length() - 1))
    ck = min(MAX_CLUSTER, -(-split // wk))
    wn = WARPS // wk
    return Plan(wn, wk, ck, (-(-n_tiles // wn), ck, -(-M // TILE_M)))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"w4a8_matmul kernel: {msg}")


def w4a8_matmul(qx: torch.Tensor, x_scale: torch.Tensor, codes: torch.Tensor,
                w_scale: torch.Tensor, out_dtype=torch.bfloat16,
                packed: torch.Tensor = None) -> torch.Tensor:
    """qx (M,K) int8, x_scale (M,1) f32, codes (K,N) int8 in [-7,7],
    w_scale (N,) f32, packed = ``pack_codes(codes)``, all contiguous on one
    CUDA device -> (M,N) out_dtype (bf16 or f32).  The kernel reads the
    codes from ``packed`` only; ``codes`` gives the shape and stays for the
    plain version."""
    build.refuse_grad("w4a8_matmul", qx, x_scale, codes, w_scale)
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
    _require(packed is not None, "a CUDA call needs the packed codes "
             "(pack_codes, made once with the weights; "
             "core/quant.py::QuantizedLinear.packed): none given")
    _require(packed.dtype == torch.uint8
             and tuple(packed.shape) == packed_shape(K, N),
             f"packed must be uint8 {packed_shape(K, N)}, got {packed.dtype} "
             f"{tuple(packed.shape)}")
    _require(packed.is_contiguous() and packed.device == qx.device
             and packed.data_ptr() % 16 == 0,
             "packed must be contiguous, 16-byte aligned and on qx's device")
    fn = build.function("w4a8_matmul_launch", _ARGTYPES)
    dev = qx.device
    plan = launch_plan(M, N, K, _sm_count(dev.index or 0))
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    vec16 = int(K % 16 == 0 and qx.data_ptr() % 16 == 0)
    rc = fn(qx.data_ptr(), x_scale.data_ptr(), packed.data_ptr(),
            w_scale.data_ptr(), out.data_ptr(), M, N, K, plan.wn, plan.wk,
            plan.ck, vec16, int(out_dtype == torch.float32),
            build.stream_handle(dev))
    build.check(rc, "w4a8_matmul")
    w4a8_matmul.launches += 1
    return out


w4a8_matmul.launches = 0
