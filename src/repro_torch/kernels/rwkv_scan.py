"""Wrapper of the RWKV6 WKV-scan CUDA kernel (``csrc/rwkv_scan.cu``).

Replaces the TPU kernel ``repro/kernels/rwkv_scan.py::rwkv6_scan``: the
RWKV6 recurrence ``S_t = diag(w_t) S_{t-1} + k_t v_t^T``, ``out_t = r_t
(S_{t-1} + diag(u) k_t v_t^T)`` from a zero initial state, with the (D, D)
float32 state held on chip across the whole sequence.  It is the WKV step of
the rwkv family's whole-sequence ``forward``: one launch per layer.  The
kernel takes any T >= 1 (the TPU kernel needed a multiple of its time
block).  It is bound by its f32 operations (5 D^2 per (b, h, t)); to give
the card enough warps it splits each head's state by columns over blocks,
32 per block (grid (B * H, D / 32); one block per head at D < 32), and
each block's k-dim rows over groups of 16 threads holding 8 rows x 2
columns each, whose partial outputs meet in shared memory once per staged
chunk of steps; see the source.  The final state is the plain version's bit
for bit.

This wrapper takes CUDA tensors only and launches the kernel or raises;
``kernels/ops.py`` routes a CPU tensor, or a call that carries a state, to
the plain version.  The kernel has no backward: called in grad mode on an
operand that requires grad, the wrapper raises.  :class:`RWKV6ScanFn` is
the differentiable form (``ops.rwkv6`` takes it for training): the kernel
runs the forward, the backward is the plain version's gradient.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_attention import ref_backward

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"rwkv6_scan kernel: {msg}")


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor):
    """r, k, v, w (B, H, T, D) in one dtype (bf16 or f32), 16-byte aligned,
    u (H, D) f32, all contiguous on one CUDA device; D in {16, 32, 64};
    T >= 1.  Returns (out (B, H, T, D) in r's dtype, final state (B, H, D,
    D) f32)."""
    build.refuse_grad("rwkv6_scan", r, k, v, w, u)
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u)):
        _require(build.is_cuda(t), f"{name} must be a CUDA tensor, got "
                 f"{t.device} (CPU tensors take the plain version in ops)")
        _require(t.is_contiguous(), f"{name} must be contiguous")
        _require(t.device == r.device, f"{name} is on {t.device}, r on "
                 f"{r.device}")
    _require(r.dim() == 4, f"r must be 4-D (B, H, T, D), got "
             f"{tuple(r.shape)}")
    _require(r.dtype in DTYPES, f"r dtype {r.dtype} not in bf16/f32")
    for name, t in (("k", k), ("v", v), ("w", w)):
        _require(t.shape == r.shape and t.dtype == r.dtype,
                 f"{name} {tuple(t.shape)} {t.dtype} does not match r "
                 f"{tuple(r.shape)} {r.dtype}")
    B, H, T, D = r.shape
    _require(D in HEAD_DIMS, f"head dim {D} not in {HEAD_DIMS}")
    _require(B > 0 and H > 0 and T > 0, f"empty operand {tuple(r.shape)}")
    _require(u.dtype == torch.float32 and tuple(u.shape) == (H, D),
             f"u must be float32 ({H}, {D}), got {u.dtype} "
             f"{tuple(u.shape)}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        _require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned "
                 "(the kernel stages it with 16-byte copies)")
    fn = build.function("rwkv6_scan_launch", _ARGTYPES)
    out = torch.empty_like(r)
    state = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
    rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), out.data_ptr(), state.data_ptr(), B, H, T, D,
            DTYPES[r.dtype], build.stream_handle(r.device))
    build.check(rc, "rwkv6_scan")
    rwkv6_scan.launches += 1
    return out, state


rwkv6_scan.launches = 0


class RWKV6ScanFn(torch.autograd.Function):
    """The RWKV6 scan with a gradient: the kernel computes the forward (one
    launch, counted), and the backward recomputes the plain version
    (``ref.rwkv6_scan`` from a zero state) on the saved r, k, v, w, u and
    returns its gradients, for the output and the final state alike."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u)
        ctx.kw = {}
        return rwkv6_scan(r, k, v, w, u)

    @staticmethod
    def backward(ctx, dout, dstate):
        return ref_backward(ref.rwkv6_scan, ctx, (dout, dstate))
