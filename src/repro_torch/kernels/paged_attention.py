"""Wrapper of the paged flash-decode CUDA kernel (``csrc/paged_attention.cu``).

Replaces the TPU kernel ``repro/kernels/paged_attention.py::
paged_decode_attention``: one decode query per slot attends to its KV
through the page table, with GQA, optional window and softcap, and optional
per-(page, KV head) dequant scales for int8 / fp8-e4m3 pools.  The kernel
walks only the pages a slot needs; at serving sizes one launch is its cost
(see the source).  The LSE output of the TPU kernel (used only by tensor
parallelism) is not ported yet.

This wrapper takes CUDA tensors only and launches the kernel or raises;
``kernels/ops.py`` routes a CPU tensor to the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
             _F, _I, _I, _P]
Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
             torch.float8_e4m3fn: 3}
MAX_SMEM = 227 * 1024
TILE = 32                 # csrc/paged_attention.cu kTile
WARPS = 4                 # csrc/paged_attention.cu kWarps


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_decode_attention kernel: {msg}")


def smem_bytes(group: int, D: int, ps: int) -> int:
    ts = min(ps, TILE)
    return 4 * (2 * group * D + 2 * group + WARPS * 32 + ts * (D + 1) + ts * D)


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           cache_len: torch.Tensor, *,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None,
                           scale: Optional[float] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           return_lse: bool = False) -> torch.Tensor:
    """q (B, Hq, 1, D) bf16/f32; pools (num_pages, ps, Hkv, D) bf16, f32,
    int8 or fp8-e4m3; page_table (B, P) int32; cache_len (B,) int32;
    k_scale/v_scale (num_pages, Hkv) f32 or None.  All contiguous on one
    CUDA device.  Returns (B, Hq, 1, D) in q's dtype."""
    if return_lse:
        raise NotImplementedError(
            "return_lse (the tensor-parallel LSE merge) is not ported yet")
    named = [("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
             ("page_table", page_table), ("cache_len", cache_len)]
    if k_scale is not None or v_scale is not None:
        _require(k_scale is not None and v_scale is not None,
                 "k_scale and v_scale come together")
        named += [("k_scale", k_scale), ("v_scale", v_scale)]
    for name, t in named:
        _require(build.is_cuda(t), f"{name} must be a CUDA tensor, got "
                 f"{t.device} (CPU tensors take the plain version in ops)")
        _require(t.is_contiguous(), f"{name} must be contiguous")
        _require(t.device == q.device, f"{name} is on {t.device}, q on "
                 f"{q.device}")
    _require(q.dim() == 4 and q.shape[2] == 1, f"q must be (B, Hq, 1, D), got "
             f"{tuple(q.shape)}")
    B, Hq, _, D = q.shape
    _require(k_pool.dim() == 4 and k_pool.shape == v_pool.shape,
             f"pools must share one (num_pages, ps, Hkv, D) shape, got "
             f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    num_pages, ps, Hkv, Dk = k_pool.shape
    _require(Dk == D, f"head dim {Dk} of the pools != {D} of q")
    _require(Hq % Hkv == 0, f"Hq={Hq} not a multiple of Hkv={Hkv}")
    _require(q.dtype in Q_DTYPES, f"q dtype {q.dtype} not in bf16/f32")
    _require(k_pool.dtype in KV_DTYPES and v_pool.dtype == k_pool.dtype,
             f"pool dtypes {k_pool.dtype}/{v_pool.dtype}")
    _require(page_table.dtype == torch.int32 and page_table.dim() == 2
             and page_table.shape[0] == B, "page_table must be (B, P) int32")
    _require(cache_len.dtype == torch.int32 and tuple(cache_len.shape) == (B,),
             "cache_len must be (B,) int32")
    if k_scale is not None:
        for t in (k_scale, v_scale):
            _require(t.dtype == torch.float32
                     and tuple(t.shape) == (num_pages, Hkv),
                     f"scales must be ({num_pages}, {Hkv}) float32")
    group = Hq // Hkv
    _require(smem_bytes(group, D, ps) <= MAX_SMEM,
             f"group={group}, D={D}, ps={ps} need more shared memory than a "
             f"block has")
    fn = build.function("paged_decode_attention_launch", _ARGTYPES)
    out = torch.empty_like(q)
    rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), cache_len.data_ptr(),
            k_scale.data_ptr() if k_scale is not None else None,
            v_scale.data_ptr() if v_scale is not None else None,
            out.data_ptr(), B, Hkv, group, D, ps, page_table.shape[1],
            -1 if window is None else int(window),
            float(scale if scale is not None else D ** -0.5),
            0.0 if softcap is None else float(softcap),
            Q_DTYPES[q.dtype], KV_DTYPES[k_pool.dtype],
            build.stream_handle(q.device))
    build.check(rc, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
