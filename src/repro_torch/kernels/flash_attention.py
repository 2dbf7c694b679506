"""Wrapper of the flash-attention CUDA kernel (``csrc/flash_attention.cu``).

Replaces the TPU kernel ``repro/kernels/flash_attention.py::
flash_attention``: blocked online-softmax attention in float32 with causal
masking, sliding window, softcap, ``kv_offset``, ``scale`` and GQA by index
(query head h reads KV head ``h // group``).  It is the prefill attention of
the float ``ServeEngine``: one launch per layer per prompt.  The kernel
masks ragged Tq and Tk itself and skips the K/V tiles that causality or the
window mask wholly; see the source for its design and bound.

The source has two bodies, and :func:`body` picks one from dtype and head
dim: bf16 at D in ``TENSOR_CORE_HEAD_DIMS`` runs on the tensor cores
(mma.sync, p split into two bf16 halves so that it stays f32-accurate), f32
at any multiple of 16 up to 256 on the CUDA cores; bf16 at another D is
refused.

This wrapper takes CUDA tensors only and launches the kernel or raises;
``kernels/ops.py`` routes a CPU tensor to the plain version.  The kernel
has no backward: called in grad mode on an operand that requires grad, the
wrapper raises rather than return an output without autograd history.
:class:`FlashAttentionFn` is the differentiable form (``ops.attention``
takes it for training): the kernel runs the forward, and the backward is
the gradient of the plain version recomputed on the saved inputs.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _I,
             _P]
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
TENSOR_CORE_HEAD_DIMS = (16, 32, 48, 64, 128)
BODIES = {"cuda-core": 0, "tensor-core": 1}   # csrc/flash_attention.cu Body


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention kernel: {msg}")


def body(dtype: torch.dtype, D: int) -> str:
    """The kernel body that takes (dtype, head dim): "tensor-core" for bf16
    at D in ``TENSOR_CORE_HEAD_DIMS``, "cuda-core" for f32 at any multiple of
    16 up to ``MAX_HEAD_DIM``; raises for anything else."""
    _require(dtype in DTYPES, f"q dtype {dtype} not in bf16/f32")
    _require(D % 16 == 0 and 0 < D <= MAX_HEAD_DIM,
             f"head dim {D} is not a multiple of 16 up to {MAX_HEAD_DIM}")
    if dtype == torch.bfloat16:
        _require(D in TENSOR_CORE_HEAD_DIMS, f"bf16 head dim {D} not in "
                 f"{TENSOR_CORE_HEAD_DIMS} (the CUDA-core body takes f32 only)")
        return "tensor-core"
    return "cuda-core"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None,
                    kv_offset: int = 0) -> torch.Tensor:
    """q (B, Hq, Tq, D), k and v (B, Hkv, Tk, D), one dtype (bf16 or f32),
    contiguous on one CUDA device; Hq % Hkv == 0; D in
    ``TENSOR_CORE_HEAD_DIMS`` for bf16, a multiple of 16 up to 256 for f32;
    ``kv_offset >= 0``.  Returns (B, Hq, Tq, D) in q's dtype."""
    build.refuse_grad("flash_attention", q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _require(build.is_cuda(t), f"{name} must be a CUDA tensor, got "
                 f"{t.device} (CPU tensors take the plain version in ops)")
        _require(t.is_contiguous(), f"{name} must be contiguous")
        _require(t.device == q.device, f"{name} is on {t.device}, q on "
                 f"{q.device}")
        _require(t.dim() == 4, f"{name} must be 4-D (B, H, T, D), got "
                 f"{tuple(t.shape)}")
        _require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned "
                 "(the kernel copies 16-byte chunks)")
    _require(q.dtype in DTYPES, f"q dtype {q.dtype} not in bf16/f32")
    _require(k.dtype == q.dtype and v.dtype == q.dtype,
             f"q, k, v dtypes differ: {q.dtype}/{k.dtype}/{v.dtype}")
    B, Hq, Tq, D = q.shape
    _require(k.shape == v.shape, f"k {tuple(k.shape)} and v "
             f"{tuple(v.shape)} differ")
    _, Hkv, Tk, Dk = k.shape
    _require(k.shape[0] == B and Dk == D, f"k/v {tuple(k.shape)} do not fit "
             f"q {tuple(q.shape)}")
    _require(Hkv > 0 and Hq % Hkv == 0, f"Hq={Hq} not a multiple of "
             f"Hkv={Hkv}")
    which = body(q.dtype, D)
    _require(B > 0 and Tq > 0 and Tk > 0, f"empty operand {tuple(q.shape)} "
             f"x {tuple(k.shape)}")
    _require(int(kv_offset) >= 0, f"kv_offset={kv_offset} < 0 leaves rows "
             "that see no key")
    fn = build.function("flash_attention_launch", _ARGTYPES)
    out = torch.empty_like(q)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Hq, Hkv, Tq, Tk, D, int(bool(causal)),
            -1 if window is None else int(window), int(kv_offset),
            float(scale if scale is not None else D ** -0.5),
            0.0 if softcap is None else float(softcap),
            DTYPES[q.dtype], BODIES[which], build.stream_handle(q.device))
    build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with a gradient: the kernel computes the forward
    (one launch, counted), and the backward recomputes the plain version
    (``ref.flash_attention``) on the saved q, k, v and returns its
    gradients.  The gradient is therefore the plain function's, the one
    the JAX package's training differentiates (through its plain attention:
    its Pallas kernel has no gradient either).  ``kw`` holds the keyword
    arguments of :func:`flash_attention`."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        ctx.save_for_backward(q, k, v)
        ctx.kw = kw
        return flash_attention(q, k, v, **kw)

    @staticmethod
    def backward(ctx, dout):
        return ref_backward(ref.flash_attention, ctx, (dout,)) + (None,)


def ref_backward(fn, ctx, douts):
    """The gradients of the plain version ``fn`` at the saved inputs for the
    output gradients ``douts`` (None for an output that got none), one per
    saved input (None where it needs none)."""
    saved = ctx.saved_tensors     # unpacked once (a checkpoint allows one)
    needs = ctx.needs_input_grad[:len(saved)]
    with torch.enable_grad():
        xs = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
        outs = fn(*xs, **ctx.kw)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, d) for o, d in zip(outs, douts) if d is not None]
        wrt = [x for x, n in zip(xs, needs) if n]
        got = iter(torch.autograd.grad([o for o, _ in pairs],
                                       wrt, [d for _, d in pairs],
                                       allow_unused=True))
    return tuple(next(got) if n else None for n in needs)
