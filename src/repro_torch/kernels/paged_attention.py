"""Wrapper of the paged flash-decode CUDA kernel (``csrc/paged_attention.cu``).

Replaces the TPU kernel ``repro/kernels/paged_attention.py::
paged_decode_attention``: one decode query per slot attends to its KV
through the page table, with GQA, optional window and softcap, optional
per-(page, KV head) dequant scales for int8 / fp8-e4m3 pools, and with
``return_lse=True`` the (B, Hkv, group) log-sum-exp that a split of the page
axis across tensor-parallel shards merges by.  The kernel splits each slot's
pages into chunks of :func:`split_plan`'s size across blocks and merges the
chunks by log-sum-exp in the same launch (see the source).

This wrapper takes CUDA tensors only and launches the kernel or raises;
``kernels/ops.py`` routes a CPU tensor to the plain version.  It never reads
``cache_len`` on the host, so a call never synchronises and captures in a
CUDA graph.  The chunks' merge counters are the tail of the call's own
workspace, which the launcher zeroes on the call's stream before the kernel
(a memset node in a captured graph): nothing carries from one call, replay
or stream to another.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = [_P] * 11 + [_I] * 11 + [_F, _F, _I, _I, _P]
Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
             torch.float8_e4m3fn: 3}
HEAD_DIMS = (16, 32, 64, 128, 256)
SM_COUNT = 132            # H100 SXM
CHUNK_BYTES = 65536       # K bytes of bf16 rows a chunk aims at
ROWS_PER_BLOCK = 8        # csrc/paged_attention.cu: G for any group > 1
MAX_CHUNKS = 64           # csrc/paged_attention.cu kMaxChunks


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_decode_attention kernel: {msg}")


def split_plan(ps: int, P: int, bh: int, D: int) -> Tuple[int, int]:
    """(pages per chunk, chunks per slot) for a table of P pages of ps
    positions, over bh = B * Hkv (slot, KV head) pairs at head dim D.

    A chunk aims at ``CHUNK_BYTES`` of bf16 K rows (256 positions at D 128,
    512 at D 64), at least one page; it is halved, down to one page, while
    the grid would give fewer than two blocks per SM, and grown until a slot
    has at most ``MAX_CHUNKS`` chunks (the merge's shared memory).  Chosen
    from the shapes alone -- never from the lengths, which live on the
    card."""
    cp = max(1, min(P, CHUNK_BYTES // (2 * D) // ps))
    while cp > 1 and bh * -(-P // cp) < 2 * SM_COUNT:
        cp //= 2
    cp = max(cp, -(-P // MAX_CHUNKS))
    return cp, -(-P // cp)


def lane_elements(kv_dtype: torch.dtype, D: int, rows: int) -> int:
    """Elements of a pool row per lane (D / that many lanes share a row):
    in a block of one query row 32 bytes of f32 or bf16 and 16 of int8 /
    fp8; in a block of 8 rows, whose q and sums take 16 registers a row,
    16 bytes of f32 (32 at D 256) or bf16 and 8 of int8 / fp8."""
    if rows == 1:
        return 8 if kv_dtype == torch.float32 else 16
    return 4 if kv_dtype == torch.float32 and D <= 128 else 8


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           cache_len: torch.Tensor, *,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None,
                           scale: Optional[float] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           return_lse: bool = False,
                           plan: Optional[Tuple[int, int]] = None):
    """q (B, Hq, 1, D) bf16/f32; pools (num_pages, ps, Hkv, D) bf16, f32,
    int8 or fp8-e4m3, D in ``HEAD_DIMS``; page_table (B, P) int32;
    cache_len (B,) int32; k_scale/v_scale (num_pages, Hkv) f32 or None.  All
    contiguous on one CUDA device.  Returns (B, Hq, 1, D) in q's dtype, and
    with ``return_lse`` also the (B, Hkv, group) f32 log-sum-exp.

    ``plan`` (pages per chunk, chunks per slot) overrides
    :func:`split_plan` of these shapes: a rank of a head-cut pool passes the
    plan of the whole pool, so that each head's chunks and their merge do
    not depend on how many heads the call holds."""
    named = [("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
             ("page_table", page_table), ("cache_len", cache_len)]
    if k_scale is not None or v_scale is not None:
        _require(k_scale is not None and v_scale is not None,
                 "k_scale and v_scale come together")
        named += [("k_scale", k_scale), ("v_scale", v_scale)]
    build.refuse_grad("paged_decode_attention", q, k_pool, v_pool, k_scale,
                      v_scale)
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
    _require(D in HEAD_DIMS, f"head dim {D} not in {HEAD_DIMS}")
    _require(Hq % Hkv == 0, f"Hq={Hq} not a multiple of Hkv={Hkv}")
    _require(q.dtype in Q_DTYPES, f"q dtype {q.dtype} not in bf16/f32")
    _require(k_pool.dtype in KV_DTYPES and v_pool.dtype == k_pool.dtype,
             f"pool dtypes {k_pool.dtype}/{v_pool.dtype}")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        _require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
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
    P = page_table.shape[1]
    rows = 1 if group == 1 else ROWS_PER_BLOCK
    chunk_pages, n_chunks = (split_plan(ps, P, B * Hkv, D) if plan is None
                             else plan)
    _require(chunk_pages >= 1 and n_chunks <= MAX_CHUNKS
             and chunk_pages * n_chunks >= P > chunk_pages * (n_chunks - 1),
             f"plan {plan} does not tile {P} pages in at most {MAX_CHUNKS} "
             f"chunks")
    fn = build.function("paged_decode_attention_launch", _ARGTYPES)
    out = torch.empty_like(q)
    lse = (torch.empty((B, Hkv, group), dtype=torch.float32, device=q.device)
           if return_lse else None)
    # the chunks' (acc, m, l), then one int32 merge counter per (slot, KV
    # head, row slice), which the launcher zeroes
    n_ws = B * Hq * n_chunks * (D + 2)
    ws = torch.empty(n_ws + B * Hkv * -(-group // rows), dtype=torch.float32,
                     device=q.device)
    rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), cache_len.data_ptr(),
            k_scale.data_ptr() if k_scale is not None else None,
            v_scale.data_ptr() if v_scale is not None else None,
            out.data_ptr(), lse.data_ptr() if lse is not None else None,
            ws.data_ptr(), ws.data_ptr() + 4 * n_ws,
            B, Hkv, group, D, ps, P, chunk_pages, n_chunks,
            lane_elements(k_pool.dtype, D, rows), rows,
            -1 if window is None else int(window),
            float(scale if scale is not None else D ** -0.5),
            0.0 if softcap is None else float(softcap),
            Q_DTYPES[q.dtype], KV_DTYPES[k_pool.dtype],
            build.stream_handle(q.device))
    build.check(rc, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return (out, lse) if return_lse else out


paged_decode_attention.launches = 0
