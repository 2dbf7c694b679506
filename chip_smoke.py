#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and hold every
kernel of those paths against its plain PyTorch version.

    python3 chip_smoke.py            # from the root of a checkout, one card

Phases, each printed as one JSON line; any failure raises and the script
exits non-zero (without a card, or without the repository's ``src/``, it
fails before printing any result):

  device     the card's name and count, ``nvidia-smi`` name and power limit,
             and the matmul precision settings (TF32 off, no reduced-
             precision bf16 reductions)
  build      the four CUDA kernels compiled from ``src/repro_torch/csrc``
             for sm_90a, one nvcc per source in parallel, with the
             ``-Xptxas -v`` register / spill report; the instantiations of
             each kernel counted, and the tensor-core MMAs (HMMA / HGMMA)
             of each bf16 flash instantiation counted in ``cuobjdump
             -sass``: none is a failure
  w4a8       the W4A8 kernel against the plain version at every main-path
             (K, N) of tinyllama-1.1b for M in {1, 8} plus ragged shapes:
             bit-identical
  paged      the paged flash-decode kernel against the plain version at
             tinyllama's and llama2-7b's attention shapes, with window,
             softcap, int8 and fp8 pools, with return_lse: bf16 within one
             bf16 ulp of the plain value, f32 within 1e-5, the LSE within
             1e-5 (at most -1e29 for an empty slot)
  flash      the flash-attention kernel against the plain version at
             llama2-7b's prefill shapes (T in {1, 37, 512}), tinyllama's
             (GQA 32/4, D 64, T 300), non-causal with kv_offset, window 64
             with softcap 30, in f32 and bf16: f32 within 1e-5, bf16
             within one bf16 ulp of the plain value plus that 1e-5 (an
             output near zero has a bf16 ulp below the f32 sum-order error)
  rwkv       the RWKV6 WKV-scan kernel against the plain version at
             rwkv6-7b's forward shape (B 4, H 64, D 64, bf16, T in {1, 37,
             512}), at the JAX kernel tests' shapes in f32 and at a bf16
             H 64 case with B 1: the final state and f32 outputs within
             1e-4, bf16 outputs within one bf16 ulp of the plain value plus
             the f32 bound of two orders of out's D-term sum (its terms
             reach hundreds at T = 512)
  reference  reduced tinyllama split-brain engine served on the card
             (kernels) and on the CPU (plain versions) from the same
             weights: identical tokens
  reference_serve  reduced llama2-7b and tinyllama ServeEngine on the card
             and on the CPU, under the scheduler and generate(): identical
             tokens
  reference_rwkv  reduced rwkv6-7b on the card and on the CPU from the
             same weights, over four weight seeds: forward logits within one
             bf16 ulp of the largest; the tokens the card's ServeEngine chose
             under the scheduler and generate(), fed back teacher-forced
             through the decode steps on both devices, give logits within
             two ulps, and any token the CPU would not choose is a near-tie
  main_path  full-width tinyllama-1.1b (22 layers, random seeded weights,
             LAQ W4A8 on the card), SplitBrainEngine(page_size=16,
             max_len=256) under the continuous-batching scheduler with 8
             slots: a warm-up run, then 16 seeded requests (prompts of 8-64
             tokens, 32 new tokens each) with the launch counts set to 0
             just before and read just after; every request DONE, launches
             = 155 W4A8 per token step and 22 paged attentions per decode
             step, eq. 7-10 meter exact, a second run token-identical
  serve_path full-width llama2-7b (32 layers, d_model 4096, bf16 weights
             from a seeded generator on the card), the float ServeEngine
             (page_size=16, max_len=1024) under the scheduler with 8 slots:
             a warm-up run, then 16 seeded requests (prompts of 64-512
             tokens, 32 new tokens each), counts set to 0 just before and
             read just after: every request DONE, 32 flash launches per
             prefill, 32 paged launches per decode step, no W4A8 launch,
             meter exact, a second run token-identical; then generate() on
             4 prompts of 128 tokens (32 flash launches, the same tokens on a
             second call)
  rwkv_path  full-width rwkv6-7b (32 layers, d_model 4096, 64 heads of 64,
             d_ff 14336, vocab 65536; bf16 weights from a seeded generator
             on the card): api.forward on 4 x 512 tokens twice, counts set
             to 0 just before and read just after (32 scan launches per
             call, finite logits, the second call bit-identical); then the
             float ServeEngine (max_len 128, dense slot cache) under the
             scheduler with 8 slots: a warm-up run, then 8 seeded requests
             (prompts of 16-64 tokens, 32 new tokens each), counts set to 0
             just before and read just after: every request DONE, no kernel
             launch (each decode step carries the WKV state, which the
             kernel does not take, as in the JAX package), meter exact, a
             second run token-identical
  profile    torch.profiler over decode steps of each path: device time by
             kernel and the device's busy share
  times      CUDA-event times of each kernel at its path's shapes, replayed
             from a CUDA graph so the host's launch overhead is out (the
             eager time is kept beside it), with its bound, its plain
             version and a library yardstick; the paged kernel's outputs
             at each timed step's own geometry are first held against the
             plain version's

The line before the last two is ``{"kernels": [...]}``, then the
``nvidia-smi`` line, then ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]

from repro_torch.configs import get_config
from repro_torch.core.device import exact_matmuls
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import paged_attention as kpa
from repro_torch.models import api
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import (
    ContinuousBatchingScheduler, Request)
from repro_torch.serve.splitbrain_engine import (
    SplitBrainEngine, traffic_model_for)
from torch_cases import bf16_ulp_of, pick_report, teacher_forced_logits

SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet (dense peaks below too)
INT8_OPS_PER_S = 1979e12           # dense int8 tensor-core peak
F32_FLOPS_PER_S = 67e12            # float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12          # dense bf16 tensor-core peak
W4A8_SRC = ("src/repro_torch/csrc/w4a8_matmul.cu",
            "src/repro/kernels/w4a8_matmul.py:30")
PAGED_SRC = ("src/repro_torch/csrc/paged_attention.cu",
             "src/repro/kernels/paged_attention.py:48")
FLASH_SRC = ("src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:31")
RWKV_SRC = ("src/repro_torch/csrc/rwkv_scan.cu",
            "src/repro/kernels/rwkv_scan.py:25")
# For the reader only, printed on a labelled line of their own that no check
# reads and kept out of the kernels line: the two redesigned kernels' times
# at the times phases' units before the redesign, as PERF.md records them
# (CUDA-graph replay on an H100 80GB HBM3 at 700.00 W).  Not measured by
# this run.
BEFORE_REDESIGN = {"paged_tinyllama_step_ms": 0.531,
                   "paged_llama2_step_ms": 5.519,
                   "flash_512_prefill_ms": 6.943,
                   "flash_T_us": {64: 23.4, 128: 39.8, 256: 69.5, 512: 210.8}}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn()`` over ``iters`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ----------------------------------------------------------------- phases
def phase_device():
    check(torch.cuda.is_available(), "no CUDA device")
    # full-precision float matmuls on the card, as on the CPU: no TF32, and
    # no bf16 reduction inside cuBLAS's bf16 products (ServeEngine sets the
    # same for a CUDA device); reported as torch reads them back
    matmul = exact_matmuls()
    check(not any(matmul.values()), f"reduced-precision matmuls on: {matmul}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    info = {"phase": "device", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi_line,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "matmul": matmul}
    emit(info)
    return info


KERNEL_NAME = re.compile(r"(w4a8_\w+?_kernel|paged_decode_kernel|"
                         r"flash_attention_tc_kernel|flash_attention_core_kernel|"
                         r"rwkv6_scan_kernel)I(.*?)EEv")


def short_name(mangled: str) -> str:
    m = KERNEL_NAME.search(mangled)
    return m.group(1) + "<" + m.group(2) + ">" if m else mangled


def sass_counts(lib_path: str, opcodes=("HMMA", "HGMMA")):
    """{kernel: {opcode: count}} from ``cuobjdump -sass`` of the built
    library, with the cuobjdump of the toolkit whose nvcc built it."""
    tool = Path(build.find_nvcc()).parent / "cuobjdump"
    res = subprocess.run([str(tool), "-sass", lib_path], capture_output=True,
                         text=True, timeout=300)
    check(res.returncode == 0, f"cuobjdump failed: {res.stderr[:500]}")
    counts, name = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = short_name(m.group(1))
            counts[name] = {op: 0 for op in opcodes}
        elif name:
            for op in opcodes:
                if re.search(rf"\b{op}\.", line):
                    counts[name][op] += 1
    return counts


def phase_build():
    info = build.build()
    build.library()
    kernels, name = [], None
    for line in info["log"].splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            kernels.append({"kernel": short_name(name),
                            "registers": int(m.group(1))})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and kernels and int(m.group(1)) + int(m.group(2)):
            kernels[-1]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
    spills = sum(k.get("spill_bytes", 0) for k in kernels)
    sass = sass_counts(info["path"])
    tc = {k: c for k, c in sass.items()
          if k.startswith("flash_attention_tc_kernel")}
    redesigned = [dict(k, **sass.get(k["kernel"], {})) for k in kernels
                  if k["kernel"].startswith(("flash_attention_tc_kernel",
                                             "paged_decode_kernel"))]
    emit({"phase": "build", "seconds": round(info["seconds"], 3),
          "cached": info["cached"], "sources": [p.name for p in build.sources()],
          "ptxas": kernels, "spill_bytes": spills,
          "redesigned": redesigned,
          "flash_tensor_core_mma": {k: c["HMMA"] + c["HGMMA"]
                                    for k, c in tc.items()},
          "note": "shared memory is dynamic (sized per launch); HMMA = "
                  "mma.sync, HGMMA = wgmma, counted in cuobjdump -sass"})

    def count(prefix):
        return sum(k["kernel"].startswith(prefix) for k in kernels)
    check(count("flash_attention_tc_kernel") == 5,
          "ptxas report lacks the 5 tensor-core flash instantiations")
    check(count("flash_attention_core_kernel") == 4,
          "ptxas report lacks the 4 CUDA-core (f32) flash instantiations")
    check(count("paged_decode_kernel") == 18,
          "ptxas report lacks the 18 paged-decode instantiations")
    check(count("rwkv6_scan_kernel") == 6,
          "ptxas report lacks the 6 rwkv-scan instantiations")
    check(count("w4a8_") >= 5, "ptxas report lacks the W4A8 kernels")
    check(len(tc) == 5 and all(c["HMMA"] + c["HGMMA"] > 0 for c in tc.values()),
          f"a bf16 flash instantiation runs no tensor-core MMA: {tc}")


W4A8_SHAPES = [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048),
               (2048, 32000)]


def w4a8_inputs(M, K, N, gen, dev):
    qx = torch.randint(-127, 128, (M, K), generator=gen, device=dev,
                       dtype=torch.int8)
    xs = torch.rand((M, 1), generator=gen, device=dev) * 0.02 + 1e-3
    codes = torch.randint(-7, 8, (K, N), generator=gen, device=dev,
                          dtype=torch.int8)
    ws = torch.rand((N,), generator=gen, device=dev) * 0.05 + 1e-3
    return qx, xs, codes, ws


def phase_w4a8(dev):
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cases = [(M, K, N) for (K, N) in W4A8_SHAPES for M in (1, 8)]
    cases += [(5, 2048, 1003), (3, 100, 37), (13, 5632, 130)]
    worst = 0.0
    for M, K, N in cases:
        args = w4a8_inputs(M, K, N, gen, dev)
        out = ops.w4a8_matmul(*args)
        plain = ref.w4a8_matmul(*args)
        torch.cuda.synchronize()
        err = (out.float() - plain.float()).abs().max().item()
        worst = max(worst, err)
        check(torch.equal(out, plain), f"W4A8 {M}x{K}x{N} differs from the "
              f"plain version (max abs err {err})")
    emit({"phase": "w4a8", "cases": len(cases), "tolerance": "bit-identical",
          "max_abs_err": worst})
    return worst


def paged_inputs(gen, dev, *, B, Hq, Hkv, D, ps, P, lens, qdtype, kv=None):
    N = B * P + 1
    q = torch.randn((B, Hq, 1, D), generator=gen, device=dev).to(qdtype)
    kf = torch.randn((N, ps, Hkv, D), generator=gen, device=dev)
    vf = torch.randn((N, ps, Hkv, D), generator=gen, device=dev)
    perm = torch.randperm(N - 1, generator=gen, device=dev)[:B * P] + 1
    table = perm.reshape(B, P).to(torch.int32)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    used = (lens_t[:, None] + ps - 1) // ps
    table = torch.where(torch.arange(P, device=dev)[None, :] < used, table, 0)
    case = dict(q=q, table=table.contiguous(), lens=lens_t, k_scale=None,
                v_scale=None)
    if kv is None:
        case.update(k=kf.to(qdtype), v=vf.to(qdtype))
    else:
        e = torch.randint(-9, -5, (2, N, Hkv), generator=gen, device=dev)
        case.update(k_scale=torch.exp2(e[0].float()), v_scale=torch.exp2(e[1].float()))
        if kv == "int8":
            case.update(k=(kf * 40).round().clamp(-127, 127).to(torch.int8),
                        v=(vf * 40).round().clamp(-127, 127).to(torch.int8))
        else:
            case.update(k=(kf * 60).clamp(-440, 440).to(torch.float8_e4m3fn),
                        v=(vf * 60).clamp(-440, 440).to(torch.float8_e4m3fn))
    return case


def run_paged(case, fn, **kw):
    return fn(case["q"], case["k"], case["v"], case["table"], case["lens"],
              k_scale=case["k_scale"], v_scale=case["v_scale"], **kw)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    e = torch.floor(torch.log2(torch.clamp_min(x.abs(), 2.0 ** -126)))
    return torch.exp2(e - 7)


def paged_error(case, out, **opts):
    """(max |out - plain|, max error in bf16 ulps or None, within the
    tolerance) of the kernel's output against the plain version's on the
    same case: for bf16 one bf16 ulp of the plain value plus the f32 bound
    of two sum orders (``ref.paged_decode_order_bound``, which matters only
    for outputs near zero), for f32 1e-5."""
    plain = run_paged(case, ref.paged_decode_attention, **opts)
    diff = (out.float() - plain.float()).abs()
    if out.dtype == torch.bfloat16:
        ulp = bf16_ulp(plain.float()) + 2.0 ** -133
        tol = ulp + run_paged(case, ref.paged_decode_order_bound, **opts)
        ulps, ok = (diff / ulp).max().item(), bool((diff <= tol).all())
    else:
        ulps, ok = None, bool((diff <= 1e-5).all())
    return diff.max().item(), ulps, ok


TINY = dict(B=8, Hq=32, Hkv=4, D=64, ps=16, P=16,
            lens=[0, 1, 15, 16, 17, 63, 130, 256])
LLAMA2 = dict(B=8, Hq=32, Hkv=32, D=128, ps=16, P=16,
              lens=[0, 3, 16, 40, 64, 100, 200, 255])
# the serve path's table (max_len 1024): split_plan's 16-page chunks
LLAMA2_SERVE = dict(LLAMA2, P=64, lens=[0, 1, 143, 208, 300, 431, 527, 1024])


def phase_paged(dev):
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    bf, f32 = torch.bfloat16, torch.float32
    cases = [("tinyllama", TINY, bf, None, {}),
             ("tinyllama", TINY, bf, None, dict(window=40, softcap=30.0)),
             ("tinyllama", TINY, bf, "int8", {}),
             ("tinyllama", TINY, bf, "fp8", dict(softcap=30.0)),
             ("tinyllama", TINY, f32, "int8", dict(window=20)),
             ("llama2-7b", LLAMA2, bf, None, {}),
             ("llama2-7b", LLAMA2, f32, None, dict(window=50, softcap=20.0)),
             ("llama2-7b", LLAMA2, bf, "fp8", dict(window=7)),
             ("llama2-7b serve", LLAMA2_SERVE, bf, None, {}),
             ("llama2-7b serve", LLAMA2_SERVE, bf, None,
              dict(window=300, softcap=30.0))]
    worst, rows = 0.0, []
    for name, geom, qd, kv, opts in cases:
        case = paged_inputs(gen, dev, qdtype=qd, kv=kv, **geom)
        out, lse = run_paged(case, ops.paged_decode_attention,
                             return_lse=True, **opts)
        _, p_lse = run_paged(case, ref.paged_decode_attention,
                             return_lse=True, **opts)
        torch.cuda.synchronize()
        err, ulps, ok = paged_error(case, out, **opts)
        live = case["lens"] > 0
        lse_err = (lse[live] - p_lse[live]).abs().max().item()
        worst = max(worst, err)
        rows.append({"shape": name, "P": geom["P"],
                     "q": str(qd).split(".")[-1],
                     "pool": kv or str(qd).split(".")[-1], **opts,
                     "max_abs_err": err, "lse_max_abs_err": lse_err,
                     "max_err_bf16_ulps": ulps})
        check(ok, f"paged attention {rows[-1]} outside tolerance")
        check(not out[0].any().item(), "an empty slot must return zeros")
        check(lse_err <= 1e-5 and bool((lse[~live] <= -1e29).all()),
              f"paged attention LSE {rows[-1]} outside tolerance")
    emit({"phase": "paged", "cases": rows,
          "tolerance": "bf16: 1 bf16 ulp of the plain value + "
                       "ref.paged_decode_order_bound (8 * 2^-24 * "
                       "sum p|v| / l); f32: 1e-5; LSE: 1e-5 (live slots), "
                       "<= -1e29 (empty)",
          "max_abs_err": worst})
    return worst


def flash_inputs(gen, dev, B, Hq, Hkv, Tq, Tk, D, dtype):
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in ((B, Hq, Tq, D), (B, Hkv, Tk, D), (B, Hkv, Tk, D))]


def phase_flash(dev):
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    bf, f32 = torch.bfloat16, torch.float32
    llama = [("llama2-7b", (1, 32, 32, T, T, 128), dict(causal=True))
             for T in (1, 37, 512)]
    other = [("tinyllama", (1, 32, 4, 300, 300, 64), dict(causal=True)),
             ("llama2-7b", (1, 32, 32, 64, 300, 128),
              dict(causal=False, kv_offset=236)),
             ("tinyllama", (1, 32, 4, 300, 300, 64),
              dict(causal=True, window=64, softcap=30.0))]
    worst, rows = 0.0, []
    for name, shape, opts in llama + other:
        for qd in (bf, f32):
            q, k, v = flash_inputs(gen, dev, *shape, qd)
            out = ops.attention(q, k, v, **opts)
            plain = ref.flash_attention(q, k, v, **opts)
            torch.cuda.synchronize()
            diff = (out.float() - plain.float()).abs()
            # bf16: one bf16 ulp of the plain value on top of the f32
            # tolerance -- an output near zero after cancellation has a
            # bf16 ulp below the f32 sum-order error of its 512 terms
            tol = (bf16_ulp(plain.float()) + 1e-5 if qd == bf
                   else torch.full_like(diff, 1e-5))
            err = diff.max().item()
            worst = max(worst, err)
            rows.append({"shape": name, "B_Hq_Hkv_Tq_Tk_D": shape,
                         "dtype": str(qd).split(".")[-1], **opts,
                         "body": kfa.body(qd, shape[-1]),
                         "max_abs_err": err})
            check(out.dtype == qd and out.shape == q.shape,
                  f"flash attention {rows[-1]}: dtype or shape")
            over = (diff - tol).flatten().argmax()
            check(bool((diff <= tol).all()), f"flash attention {rows[-1]} "
                  f"outside tolerance: kernel {out.flatten()[over].item()} "
                  f"vs plain {plain.flatten()[over].item()}")
    emit({"phase": "flash", "cases": rows,
          "tolerance": "bf16: 1 bf16 ulp of the plain value + 1e-5; "
                       "f32: 1e-5",
          "max_abs_err": worst})
    return worst


def rwkv_inputs(gen, dev, B, H, T, D, dtype, decay):
    """r, k, v standard normal and u (H, D) N(0, 1) * 0.3; decays w as
    rwkv6-7b's init makes them, exp(-exp(U(-8, -5))) (``"model"``), or
    U(0.8, 0.999) as the JAX kernel tests draw them (``"jax"``)."""
    r, k, v = (torch.randn((B, H, T, D), generator=gen, device=dev)
               for _ in range(3))
    w = torch.empty((B, H, T, D), device=dev)
    if decay == "model":
        w = torch.exp(-torch.exp(w.uniform_(-8.0, -5.0, generator=gen)))
    else:
        w.uniform_(0.8, 0.999, generator=gen)
    u = torch.randn((H, D), generator=gen, device=dev) * 0.3
    return [t.to(dtype) for t in (r, k, v, w)] + [u]


RWKV_FWD = (4, 64, 512, 64)        # rwkv6-7b's forward: B 4, H 64, T 512, D 64


def phase_rwkv(dev):
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    bf, f32 = torch.bfloat16, torch.float32
    B, H, _, D = RWKV_FWD
    cases = ([("rwkv6-7b forward", (B, H, T, D), bf, "model")
              for T in (1, 37, 512)]
             + [("jax kernel test", shape, f32, "jax")
                for shape in ((2, 3, 64, 16), (1, 2, 128, 32), (1, 1, 32, 64))]
             + [("rwkv6-7b, B 1", (1, H, 100, D), bf, "model")])
    worst, rows = 0.0, []
    for name, shape, dt, decay in cases:
        r, k, v, w, u = rwkv_inputs(gen, dev, *shape, dt, decay)
        out, state = ops.rwkv6(r, k, v, w, u)
        p_out, p_state = ref.rwkv6_scan(r, k, v, w, u)
        torch.cuda.synchronize()
        diff = (out.float() - p_out.float()).abs()
        # bf16: one bf16 ulp of the plain value on top of the f32 sum-order
        # bound (the flash phase's rule, with its 1e-5 computed here)
        tol = (bf16_ulp(p_out.float())
               + ref.rwkv6_scan_order_bound(r, k, v, w, u).float()
               if dt == bf else torch.full_like(diff, 1e-4))
        s_err = (state - p_state).abs().max().item()
        err = diff.max().item()
        worst = max(worst, err, s_err)
        rows.append({"shape": name, "B_H_T_D": shape,
                     "dtype": str(dt).split(".")[-1], "decay": decay,
                     "max_abs_err": err, "state_max_abs_err": s_err,
                     "state_bit_identical": bool(torch.equal(state, p_state))})
        check(out.dtype == dt and out.shape == r.shape
              and state.shape == (shape[0], shape[1], shape[3], shape[3]),
              f"rwkv scan {rows[-1]}: dtype or shape")
        check(bool((diff <= tol).all()) and s_err <= 1e-4,
              f"rwkv scan {rows[-1]} outside tolerance")
    emit({"phase": "rwkv", "cases": rows,
          "tolerance": "state and f32 out: 1e-4; bf16 out: 1 bf16 ulp of "
                       "the plain value + 2 D 2^-24 sum_i |r_i (S_ij + u_i "
                       "k_i v_j)| (two f32 orders of the D-term sum)",
          "max_abs_err": worst})
    return worst


def reduced_requests(vocab):
    return [Request(uid=i, prompt=np.arange(1, 6 + 2 * i, dtype=np.int32) % vocab,
                    max_new=6) for i in range(5)]


def phase_reference(dev):
    cfg = get_config("tinyllama-1.1b").reduced()
    params = api.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    toks = {}
    for d in ("cpu", dev):
        eng = SplitBrainEngine(cfg, params, max_len=32, page_size=8, device=d)
        out = ContinuousBatchingScheduler(eng, max_slots=2).run(
            reduced_requests(cfg.vocab_size))
        toks[str(d)] = [r.tokens.tolist() for r in out["results"]]
    check(toks["cpu"] == toks[str(dev)],
          f"reduced tinyllama: card tokens {toks[str(dev)]} != CPU tokens "
          f"{toks['cpu']}")
    emit({"phase": "reference", "config": cfg.name, "requests": len(toks["cpu"]),
          "tokens_identical_card_vs_cpu": True})


def phase_reference_serve(dev):
    """Reduced ServeEngine on the card (flash prefill, paged decode) and on
    the CPU (plain versions) from the same weights: identical tokens under
    the scheduler (paged pool) and generate()."""
    rows = []
    for arch in ("llama2-7b", "tinyllama-1.1b"):
        cfg = get_config(arch).reduced()
        params = api.init_params(cfg, torch.Generator().manual_seed(SEED),
                                 "cpu")
        prompts = np.stack([(np.arange(1, 10) * (3 + i)) % cfg.vocab_size
                            for i in range(3)]).astype(np.int32)
        toks = {}
        for d in ("cpu", dev):
            eng = ServeEngine(cfg, params, max_len=64, page_size=8, device=d)
            out = ContinuousBatchingScheduler(eng, max_slots=2).run(
                reduced_requests(cfg.vocab_size))
            gen = eng.generate(prompts, max_new=6)
            toks[str(d)] = ([r.tokens.tolist() for r in out["results"]],
                            gen["tokens"].tolist())
        check(toks["cpu"] == toks[str(dev)],
              f"reduced {arch} ServeEngine: card tokens {toks[str(dev)]} != "
              f"CPU tokens {toks['cpu']}")
        rows.append({"config": cfg.name, "requests": len(toks["cpu"][0]),
                     "generate_rows": len(toks["cpu"][1])})
    emit({"phase": "reference_serve", "configs": rows,
          "tokens_identical_card_vs_cpu": True})


RWKV_SEEDS = (0, 1, 2, 3)   # weight seeds of reduced rwkv6-7b, card vs CPU
RWKV_FWD_ULPS = 1           # forward logits: bf16 ulps of the largest |logit|
RWKV_SERVE_ULPS = 2         # the serve path's float32 decode logits


def phase_reference_rwkv(dev):
    """Reduced rwkv6-7b on the card (the scan kernel in forward) and on the
    CPU (plain versions) from the same weights, over RWKV_SEEDS.

    forward: logits within RWKV_FWD_ULPS bf16 ulps of the largest |logit|
    (the logits are rounded to bf16, and one changed rounding moves a logit
    by one ulp at its magnitude).  ServeEngine: the tokens the card chose
    under the scheduler and generate() are fed back, teacher-forced, through
    the serve path's decode steps on both devices; those float32 logits
    agree within RWKV_SERVE_ULPS ulps (the decays near 1 carry last-bit
    GEMM and exp differences along the sequence), and wherever the CPU
    would choose another token, the card's is a near-tie: its CPU logit
    falls short of the CPU's largest by at most twice the tolerance.  Exact
    cross-device token identity holds only where no such tie falls, so it
    is reported, not required."""
    cfg = get_config("rwkv6-7b").reduced()
    prompts = np.stack([(np.arange(1, 10) * (3 + i)) % cfg.vocab_size
                        for i in range(3)]).astype(np.int32)
    reqs = reduced_requests(cfg.vocab_size)
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32))
    rows = []
    for seed in RWKV_SEEDS:
        params = api.init_params(cfg, torch.Generator().manual_seed(seed),
                                 "cpu")
        engs = {d: ServeEngine(cfg, params, max_len=64, device=d)
                for d in ("cpu", dev)}
        out = ContinuousBatchingScheduler(engs[dev], max_slots=2).run(reqs)
        gen = engs[dev].generate(prompts, max_new=6)
        check([r.state for r in out["results"]] == ["DONE"] * len(reqs)
              and all(len(r.tokens) == q.max_new
                      for q, r in zip(reqs, out["results"])),
              f"reduced rwkv6-7b seed {seed}: a request did not finish")
        seqs = ([(q.prompt, r.tokens) for q, r in zip(reqs, out["results"])]
                + [(p, t) for p, t in zip(prompts, gen["tokens"])])
        tf = {d: torch.cat([teacher_forced_logits(engs[d].params, cfg, p, t, d)
                            for p, t in seqs]) for d in engs}
        picks = np.concatenate([t for _, t in seqs])
        serve = pick_report(tf["cpu"], tf[dev], picks)
        fwd = {d: api.forward(engs[d].params, toks.to(d), cfg)[0]
               .reshape(-1, cfg.vocab_size).cpu() for d in engs}
        fwd_rep = pick_report(fwd["cpu"], fwd[dev], fwd[dev].argmax(-1))
        for name, rep, ulps in (("forward", fwd_rep, RWKV_FWD_ULPS),
                                ("serve", serve, RWKV_SERVE_ULPS)):
            rep["tolerance"] = ulps * bf16_ulp_of(rep["max_abs_logit"])
            check(rep["max_abs_err"] <= rep["tolerance"]
                  and rep["shortfall"] <= 2 * rep["tolerance"],
                  f"reduced rwkv6-7b seed {seed} {name}: card vs CPU {rep}")
        rows.append({"seed": seed, "forward": fwd_rep, "serve": serve})
    emit({"phase": "reference_rwkv", "config": cfg.name,
          "requests": len(reqs), "generate_rows": len(prompts),
          "forward_tokens": list(toks.shape),
          "tolerance": f"forward: {RWKV_FWD_ULPS} bf16 ulp of the largest "
                       f"|logit|; serve, teacher-forced: {RWKV_SERVE_ULPS}; "
                       "a pick the CPU would not make falls short of the "
                       "CPU's largest logit by at most twice the tolerance",
          "seeds": rows})


def main_requests(vocab, n=16, max_new=32):
    rng = np.random.default_rng(SEED)
    return [Request(uid=i,
                    prompt=rng.integers(1, vocab, int(rng.integers(8, 65)))
                    .astype(np.int32),
                    max_new=max_new) for i in range(n)]


class PhaseClock:
    """Host seconds spent in the engine's decode steps and admissions
    (prefill + insert; the insert's length read waits for the prefill)."""

    def __init__(self, eng):
        self.decode_s = self.admit_s = 0.0
        self.eng = eng
        self._decode, self._prefill, self._insert = (
            eng.decode_slots, eng.prefill_slot, eng.insert_slot)
        eng.decode_slots = self.decode_slots
        eng.prefill_slot = self.prefill_slot
        eng.insert_slot = self.insert_slot

    def decode_slots(self, *a, **k):
        t0 = time.perf_counter()
        out = self._decode(*a, **k)
        self.decode_s += time.perf_counter() - t0
        return out

    def prefill_slot(self, *a, **k):
        t0 = time.perf_counter()
        out = self._prefill(*a, **k)
        self.admit_s += time.perf_counter() - t0
        return out

    def insert_slot(self, *a, **k):
        t0 = time.perf_counter()
        out = self._insert(*a, **k)
        self.admit_s += time.perf_counter() - t0
        return out

    def reset(self):
        self.decode_s = self.admit_s = 0.0


def phase_main_path(dev, smi_line):
    cfg = get_config("tinyllama-1.1b")
    t0 = time.perf_counter()
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                             device=dev)
    eng = SplitBrainEngine(cfg, params, max_len=256, page_size=16,
                           quantize=True, device=dev)
    del params
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    sched = ContinuousBatchingScheduler(eng, max_slots=8)
    clock = PhaseClock(eng)
    sched.warmup(prompt_len=8, max_new=4)
    reqs = main_requests(cfg.vocab_size)
    clock.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = sched.run(reqs)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    decode_s, admit_s = clock.decode_s, clock.admit_s
    res = out["results"]
    check(len(res) == len(reqs) and all(r.state == "DONE" for r in res),
          f"not every request DONE: {out['by_state']}")
    check(all(r.gen_len == 32 for r in res), "a request stopped short")
    check(all(0 <= t < cfg.vocab_size for r in res for t in r.tokens),
          "token out of range")
    check(out["quarantines"] == 0 and out["failed"] == 0,
          "the finite-logits sentinel flagged a step")
    steps, prefill = out["steps"], out["prefill_tokens"]
    check(prefill == sum(len(r.prompt) - 1 for r in reqs), "prefill tokens")
    L = cfg.num_layers
    want = {"w4a8_matmul": (7 * L + 1) * (prefill + steps),
            "paged_decode_attention": L * steps, "flash_attention": 0,
            "rwkv6_scan": 0}
    check(counts == want, f"launch counts {counts} != {want}")
    tokens = prefill + out["decoded_tokens"]
    meter = eng.meter.measured_bytes()["total"]
    check(meter == traffic_model_for(cfg).bytes_per_token() * tokens,
          f"meter {meter} != eq. 7-10 x {tokens} tokens")
    first = [r.tokens.tolist() for r in res]
    again = sched.run(reqs)
    check([r.tokens.tolist() for r in again["results"]] == first,
          "a second identical run gave other tokens")
    info = {"phase": "main_path", "config": cfg.name, "layers": L,
            "d_model": cfg.d_model, "max_slots": 8, "page_size": 16,
            "max_len": 256, "requests": len(reqs), "all_done": True,
            "setup_s": round(setup_s, 3), "prefill_tokens": prefill,
            "decode_steps": steps, "decoded_tokens": out["decoded_tokens"],
            "launches": counts, "launches_expected": want,
            "meter_bytes": meter, "second_run_identical": True,
            "wall_s": out["wall_s"], "decode_s": decode_s,
            "admit_s": admit_s,
            "decode_steps_per_s": steps / decode_s,
            "decode_tokens_per_s": out["decoded_tokens"] / decode_s,
            "tokens_per_s_wall": out["tokens_per_s"],
            "peak_memory_bytes": peak, "card": smi_line}
    emit(info)
    return eng, info


def serve_requests(vocab, n=16, max_new=32):
    rng = np.random.default_rng(SEED + 4)
    return [Request(uid=i,
                    prompt=rng.integers(1, vocab, int(rng.integers(64, 513)))
                    .astype(np.int32),
                    max_new=max_new) for i in range(n)]


def phase_serve_path(dev, smi_line):
    """Full-width llama2-7b through the float ServeEngine: the scheduler
    over a paged pool, then generate()."""
    cfg = get_config("llama2-7b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                             device=dev)
    eng = ServeEngine(cfg, params, max_len=1024, page_size=16, device=dev)
    del params                      # the f32 tree: the engine keeps bf16
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated()
    sched = ContinuousBatchingScheduler(eng, max_slots=8)
    clock = PhaseClock(eng)
    sched.warmup(prompt_len=64, max_new=4)
    reqs = serve_requests(cfg.vocab_size)
    clock.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = sched.run(reqs)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    decode_s, admit_s = clock.decode_s, clock.admit_s
    res = out["results"]
    check(len(res) == len(reqs) and all(r.state == "DONE" for r in res),
          f"not every request DONE: {out['by_state']}")
    check(all(r.gen_len == 32 for r in res), "a request stopped short")
    check(all(0 <= t < cfg.vocab_size for r in res for t in r.tokens),
          "token out of range")
    check(out["quarantines"] == 0 and out["failed"] == 0,
          "the finite-logits sentinel flagged a step")
    steps, prefill = out["steps"], out["prefill_tokens"]
    check(prefill == sum(len(r.prompt) - 1 for r in reqs), "prefill tokens")
    L = cfg.num_layers
    want = {"w4a8_matmul": 0, "flash_attention": L * len(reqs),
            "paged_decode_attention": L * steps, "rwkv6_scan": 0}
    check(counts == want, f"launch counts {counts} != {want}")
    tokens = prefill + out["decoded_tokens"]
    meter = eng.measured_bytes()["total"]
    check(meter == traffic_model_for(cfg).bytes_per_token() * tokens,
          f"meter {meter} != eq. 7-10 x {tokens} tokens")
    first = [r.tokens.tolist() for r in res]
    again = sched.run(reqs)
    check([r.tokens.tolist() for r in again["results"]] == first,
          "a second identical run gave other tokens")
    # generate(): one block prefill of 4 x 127 tokens, then 16 lockstep steps
    rng = np.random.default_rng(SEED + 5)
    prompts = rng.integers(1, cfg.vocab_size, (4, 128)).astype(np.int32)
    ops.reset_launch_counts()
    g1 = eng.generate(prompts, max_new=16)
    gen_counts = ops.launch_counts()
    g2 = eng.generate(prompts, max_new=16)
    check(gen_counts == {"w4a8_matmul": 0, "flash_attention": L,
                         "paged_decode_attention": 0, "rwkv6_scan": 0},
          f"generate() launch counts {gen_counts}")
    check(np.array_equal(g1["tokens"], g2["tokens"])
          and g1["tokens"].shape == (4, 16)
          and bool(((g1["tokens"] >= 0) & (g1["tokens"] < cfg.vocab_size)).all()),
          "generate() tokens out of range or not repeatable")
    info = {"phase": "serve_path", "config": cfg.name, "layers": L,
            "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads],
            "head_dim": cfg.resolved_head_dim, "dtype": cfg.dtype,
            "max_slots": 8, "page_size": 16, "max_len": 1024,
            "num_pages": eng._pager.pool.num_pages,
            "requests": len(reqs), "all_done": True,
            "setup_s": setup_s, "prefill_tokens": prefill,
            "prompt_lens": [len(r.prompt) for r in reqs],
            "decode_steps": steps, "decoded_tokens": out["decoded_tokens"],
            "launches": counts, "launches_expected": want,
            "meter_bytes": meter, "second_run_identical": True,
            "wall_s": out["wall_s"], "decode_s": decode_s,
            "admit_s": admit_s,
            "decode_steps_per_s": steps / decode_s,
            "decode_tokens_per_s": out["decoded_tokens"] / decode_s,
            "prefill_tokens_per_s": prefill / admit_s,
            "tokens_per_s_wall": out["tokens_per_s"],
            "generate": {"batch": 4, "prompt_len": 128, "max_new": 16,
                         "launches": gen_counts, "repeatable": True,
                         "prefill_s": g1["prefill_s"],
                         "decode_s": g1["decode_s"],
                         "decode_tokens_per_s": g1["tokens_per_s"]},
            "peak_memory_bytes": peak, "setup_peak_memory_bytes": setup_peak,
            "card": smi_line}
    emit(info)
    return eng, info


def rwkv_requests(vocab, n=8, max_new=32):
    rng = np.random.default_rng(SEED + 8)
    return [Request(uid=i,
                    prompt=rng.integers(1, vocab, int(rng.integers(16, 65)))
                    .astype(np.int32),
                    max_new=max_new) for i in range(n)]


def phase_rwkv_path(dev, smi_line):
    """Full-width rwkv6-7b: the whole-sequence forward (the scan kernel, one
    launch per layer), then the float ServeEngine under the scheduler."""
    cfg = get_config("rwkv6-7b")
    L = cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                             device=dev)
    eng = ServeEngine(cfg, params, max_len=128, device=dev)
    del params                      # the f32 tree: the engine keeps bf16
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated()
    # --- forward on 4 x 512 tokens, twice
    toks = torch.randint(0, cfg.vocab_size, (4, 512), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(SEED + 9))
    torch.cuda.reset_peak_memory_stats()
    zero = {name: 0 for name in ops.KERNELS}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    runs = []
    for _ in range(2):
        before = ops.launch_counts()
        t = time.perf_counter()
        logits, _ = api.forward(eng.params, toks, cfg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        after = ops.launch_counts()
        check({k: after[k] - before[k] for k in after} == {**zero, "rwkv6_scan": L},
              f"forward launch counts {before} -> {after}: not {L} scans")
        runs.append((logits, dt))
    fwd_counts = ops.launch_counts()
    fwd_peak = torch.cuda.max_memory_allocated()
    (l1, dt1), (l2, dt2) = runs
    check(l1.shape == (4, 512, cfg.vocab_size) and l1.dtype == torch.float32
          and bool(torch.isfinite(l1).all()), "forward logits not finite or "
          "of the wrong shape")
    check(torch.equal(l1, l2), "a second forward gave other logits")
    fwd_max = l1.abs().max().item()
    del runs, l1, l2, logits
    # --- serving: 8 requests over 8 slots, dense recurrent-state slot cache
    sched = ContinuousBatchingScheduler(eng, max_slots=8)
    clock = PhaseClock(eng)
    sched.warmup(prompt_len=16, max_new=4)
    reqs = rwkv_requests(cfg.vocab_size)
    clock.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = sched.run(reqs)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    decode_s, admit_s = clock.decode_s, clock.admit_s
    res = out["results"]
    check(len(res) == len(reqs) and all(r.state == "DONE" for r in res),
          f"not every request DONE: {out['by_state']}")
    check(all(r.gen_len == 32 for r in res), "a request stopped short")
    check(all(0 <= t < cfg.vocab_size for r in res for t in r.tokens),
          "token out of range")
    check(out["quarantines"] == 0 and out["failed"] == 0,
          "the finite-logits sentinel flagged a step")
    steps, prefill = out["steps"], out["prefill_tokens"]
    check(prefill == sum(len(r.prompt) - 1 for r in reqs), "prefill tokens")
    check(counts == zero, f"serve launch counts {counts}: the rwkv serve path "
          "launches no kernel")
    tokens = prefill + out["decoded_tokens"]
    meter = eng.measured_bytes()["total"]
    check(meter == traffic_model_for(cfg).bytes_per_token() * tokens,
          f"meter {meter} != eq. 7-10 x {tokens} tokens")
    first = [r.tokens.tolist() for r in res]
    again = sched.run(reqs)
    check([r.tokens.tolist() for r in again["results"]] == first,
          "a second identical run gave other tokens")
    info = {"phase": "rwkv_path", "config": cfg.name, "layers": L,
            "d_model": cfg.d_model, "heads": cfg.d_model // 64, "head_dim": 64,
            "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "dtype": cfg.dtype,
            "setup_s": setup_s, "setup_peak_memory_bytes": setup_peak,
            "forward": {"batch": 4, "tokens": 512, "launches": fwd_counts,
                        "seconds": [dt1, dt2], "tokens_per_s": 2048 / dt2,
                        "max_abs_logit": fwd_max, "second_identical": True,
                        "peak_memory_bytes": fwd_peak},
            "max_slots": 8, "max_len": 128, "requests": len(reqs),
            "all_done": True, "prefill_tokens": prefill,
            "prompt_lens": [len(r.prompt) for r in reqs],
            "decode_steps": steps, "decoded_tokens": out["decoded_tokens"],
            "serve_launches": counts, "meter_bytes": meter,
            "second_run_identical": True,
            "wall_s": out["wall_s"], "decode_s": decode_s,
            "admit_s": admit_s,
            "decode_steps_per_s": steps / decode_s,
            "decode_tokens_per_s": out["decoded_tokens"] / decode_s,
            "prefill_tokens_per_s": prefill / admit_s,
            "tokens_per_s_wall": out["tokens_per_s"],
            "peak_memory_bytes": peak, "launches": fwd_counts,
            "card": smi_line}
    emit(info)
    return eng, info


def phase_profile(eng, dev, path):
    """Device time by kernel over decode steps of a path with all 8 slots
    decoding, and the device's busy share of the host's wall time."""
    from torch.profiler import ProfilerActivity, profile
    sched = ContinuousBatchingScheduler(eng, max_slots=8)
    sched.begin()
    for r in main_requests(eng.cfg.vocab_size, n=8, max_new=40):
        sched.submit(r)
    while len(sched.decoding_uids()) < 8:
        sched.step()
    for _ in range(2):
        sched.step()
    torch.cuda.synchronize()
    n = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            sched.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    dev_total = 0.0
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue                   # host-side ops (their kernels count below)
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0))
        if t > 0:
            dev_total += t
            rows.append((t, ev.key, ev.count))
    rows.sort(reverse=True)
    host = sorted(((getattr(ev, "self_cpu_time_total", 0.0), ev.key, ev.count)
                   for ev in prof.key_averages()
                   if not str(getattr(ev, "device_type", "")).endswith("CUDA")),
                  reverse=True)
    busy = dev_total / 1e6 / wall if wall else 0.0
    emit({"phase": "profile", "path": path, "config": eng.cfg.name,
          "decode_steps": n, "wall_ms_per_step": wall / n * 1e3,
          "device_ms_per_step": dev_total / 1e3 / n,
          "device_busy_share": busy if dev_total else "not measured",
          "top_kernels": [{"name": k[:80], "ms_per_step": t / 1e3 / n,
                           "calls_per_step": c / n} for t, k, c in rows[:12]],
          "host_ops_per_step": sum(c for _, _, c in host) / n,
          "top_host_ops": [{"name": k[:60], "self_cpu_ms_per_step": t / 1e3 / n,
                            "calls_per_step": c / n} for t, k, c in host[:12]]})


def w4a8_step_launches(eng, M, gen, dev):
    """The main path's W4A8 launches of one decode step at M slots, on the
    engine's real codes: 7 per layer plus the LM head."""
    mats = []
    for p in eng._layers:
        for w in (p["attn"]["wq"], p["attn"]["wk"], p["attn"]["wv"],
                  p["attn"]["wo"], p["mlp"]["w1"], p["mlp"]["w3"], p["mlp"]["w2"]):
            mats.append(w)
    mats.append(eng._head)
    acts = {}
    for w in mats:
        K = w.codes.shape[0]
        if K not in acts:
            acts[K] = (torch.randint(-127, 128, (M, K), generator=gen, device=dev,
                                     dtype=torch.int8),
                       torch.rand((M, 1), generator=gen, device=dev) * 0.01 + 1e-4)
    return [(acts[w.codes.shape[0]], w) for w in mats]


def w4a8_bound_ms(launches) -> float:
    nbytes = ops_ = 0
    for (qx, xs), w in launches:
        (M, K), N = qx.shape, w.codes.shape[1]
        nbytes += K * N + 4 * N + M * K + 4 * M + 2 * M * N
        ops_ += 2 * M * K * N
    return max(nbytes / HBM_BYTES_PER_S, ops_ / INT8_OPS_PER_S) * 1e3


def int_mm_yardstick(launches):
    """torch._int_mm on the same int8 operands (M padded to the 17 rows it
    requires) plus the same scale epilogue, one call per launch."""
    padded = []
    for (qx, xs), w in launches:
        M = qx.shape[0]
        qp = torch.zeros((17, qx.shape[1]), dtype=torch.int8, device=qx.device)
        qp[:M] = qx
        padded.append((qp, xs, w, M))

    def run():
        for qp, xs, w, M in padded:
            acc = torch._int_mm(qp, w.codes)[:M]
            (acc.float() * xs * w.scales).to(torch.bfloat16)
    return run


def graph_time_ms(fn, iters: int) -> float:
    """Device milliseconds of ``fn()``: captured once in a CUDA graph and
    replayed, so the host's launch overhead is out of the measurement (the
    eager loop on this path is host-bound; see the profile phase)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = cuda_time_ms(graph.replay, iters)
    del graph
    return ms


def yardstick_ms(fn, iters, detail, name):
    """A library call's time; it is only a yardstick, so a call the card's
    PyTorch refuses is reported as null with its error."""
    try:
        return graph_time_ms(fn, iters)
    except RuntimeError as e:
        torch.cuda.synchronize()
        detail.append({name + "_error": str(e)[:300]})
        return None


def phase_times(eng, dev, counts):
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    kernels, detail = [], []
    # --- W4A8: one decode step's 155 launches at M = 8 on the model's codes
    #     (1.03 GB, so every launch reads its codes from HBM, as decode does)
    launches = w4a8_step_launches(eng, 8, gen, dev)

    def w4a8_step(fn, ls):
        return lambda: [fn(qx, xs, w.codes, w.scales) for (qx, xs), w in ls]

    k_ms = graph_time_ms(w4a8_step(ops.w4a8_matmul, launches), iters=20)
    eager_ms = cuda_time_ms(w4a8_step(ops.w4a8_matmul, launches), iters=5)
    p_ms = graph_time_ms(w4a8_step(ref.w4a8_matmul, launches), iters=3)
    lib_ms = yardstick_ms(int_mm_yardstick(launches), 20, detail, "w4a8_library")
    for M in (1, 8):
        per = w4a8_step_launches(eng, M, gen, dev)
        for (K, N) in W4A8_SHAPES:
            # the 22 layers' distinct matrices of this shape (1 for the head)
            same = [x for x in per if tuple(x[1].codes.shape) == (K, N)]
            t = graph_time_ms(w4a8_step(ops.w4a8_matmul, same), iters=10)
            detail.append({"w4a8_M": M, "K": K, "N": N,
                           "kernel_us": t * 1e3 / len(same),
                           "bound_us": w4a8_bound_ms(same[:1]) * 1e3})
    kernels.append({"name": "w4a8_matmul", "route": "cuda", "source": W4A8_SRC[0],
                    "replaces": W4A8_SRC[1],
                    "launches": counts["w4a8_matmul"],
                    "unit": "one decode step: 155 launches at M=8 on the "
                            "model's codes, CUDA-graph replay",
                    "ms": k_ms, "plain_ms": p_ms,
                    "bound_ms": w4a8_bound_ms(launches), "bound_by": "bytes",
                    "library_ms": lib_ms,
                    "library_note": "torch._int_mm, M padded to 17, plus the "
                                    "same scale epilogue",
                    "eager_ms": eager_ms})
    # --- paged attention: one decode step's 22 launches (one per layer's
    #     pool slice) at 8 slots of the main path's lengths
    lens = [9, 24, 40, 47, 63, 70, 88, 95]
    t = paged_step_times(gen, dev, eng.cfg.num_layers, 32, 4, 64, 16, lens,
                         detail, "paged_library")
    kernels.append({"name": "paged_decode_attention", "route": "cuda",
                    "source": PAGED_SRC[0], "replaces": PAGED_SRC[1],
                    "launches": counts["paged_decode_attention"],
                    "unit": "one decode step: 22 launches, 8 slots, lengths "
                            f"{lens}, CUDA-graph replay",
                    **t, "library_note": "scaled_dot_product_attention on an "
                                    "already-gathered dense view (gather "
                                    "excluded)"})
    emit({"phase": "times", "detail": detail})
    return kernels


def paged_step_times(gen, dev, L, Hq, Hkv, D, P, lens, detail, name):
    """One decode step's L paged launches (one per layer's pool slice) at
    8 slots of the given lengths: kernel (graph replay), eager and plain
    times, the bound, and SDPA on an already-gathered dense view."""
    ps, B = 16, len(lens)
    cases = [paged_inputs(gen, dev, qdtype=torch.bfloat16, B=B, Hq=Hq,
                          Hkv=Hkv, D=D, ps=ps, P=P, lens=lens)
             for _ in range(L)]

    def paged_step(fn):
        return lambda: [run_paged(c, fn) for c in cases]

    # the timed launches' own geometry (split_plan's chunks at this P and
    # B * Hkv) against the plain version, before any timing
    errs = [paged_error(c, out) for c, out in
            zip(cases, paged_step(ops.paged_decode_attention)())]
    detail.append({name.replace("_library", "") + "_vs_plain": {
        "chunk_pages_chunks": kpa.split_plan(ps, P, B * Hkv, D),
        "max_abs_err": max(e[0] for e in errs),
        "max_err_bf16_ulps": max(e[1] for e in errs)}})
    check(all(e[2] for e in errs), f"paged attention at the timed geometry "
          f"{detail[-1]} outside tolerance")
    k_ms = graph_time_ms(paged_step(ops.paged_decode_attention), iters=50)
    eager_ms = cuda_time_ms(paged_step(ops.paged_decode_attention), iters=10)
    p_ms = graph_time_ms(paged_step(ref.paged_decode_attention), iters=5)
    toks = sum(lens)
    # bytes the function must move: the live tokens' K and V, q in, out,
    # the table and the lengths; operations: q.k and p.v in f32
    nbytes = L * (2 * toks * Hkv * D * 2 + 2 * B * Hq * D * 2 + B * P * 4
                  + B * 4)
    flops = L * 2 * 2 * toks * Hq * D
    dense = []
    for c in cases:
        S = P * ps
        kd = c["k"][c["table"].long()].reshape(B, S, Hkv, D).transpose(1, 2)
        vd = c["v"][c["table"].long()].reshape(B, S, Hkv, D).transpose(1, 2)
        mask = (torch.arange(S, device=dev)[None, :] < c["lens"][:, None])
        dense.append((c["q"], kd.contiguous(), vd.contiguous(),
                      mask[:, None, None, :]))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = yardstick_ms(lambda: [sdpa(q, k, v, attn_mask=m, enable_gqa=True)
                                   for q, k, v, m in dense], 50, detail, name)
    return {"ms": k_ms, "plain_ms": p_ms,
            "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                            flops / F32_FLOPS_PER_S) * 1e3,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= flops / F32_FLOPS_PER_S else "operations"),
            "library_ms": lib_ms, "eager_ms": eager_ms}


def flash_bound(launches, causal=True):
    """(ms, "bytes" or "operations"): max(bytes / HBM rate, flops / bf16
    tensor peak) over the launches, with q, out, k and v each moved once
    and 4 * D flops per visible q-k pair."""
    nbytes = flops = 0
    for q, k, _ in launches:
        B, Hq, Tq, D = q.shape
        Hkv, Tk = k.shape[1], k.shape[2]
        nbytes += q.element_size() * (2 * B * Hq * Tq + 2 * B * Hkv * Tk) * D
        pairs = Tq * (Tq + 1) // 2 if causal else Tq * Tk
        flops += 4 * B * Hq * D * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                        else "operations")


def phase_times_serve(dev, serve_info):
    """The serve path's kernels: the flash kernel over one 512-token
    prefill's 32 launches at llama2-7b's shape, and the paged kernel over
    one decode step's 32 launches at the serve path's lengths."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    detail = []
    L, T = 32, 512
    bf = torch.bfloat16
    launches = [flash_inputs(gen, dev, 1, 32, 32, T, T, 128, bf)
                for _ in range(L)]

    def prefill(fn, ls):
        return lambda: [fn(q, k, v, causal=True) for q, k, v in ls]

    k_ms = graph_time_ms(prefill(ops.attention, launches), iters=10)
    eager_ms = cuda_time_ms(prefill(ops.attention, launches), iters=3)
    p_ms = graph_time_ms(prefill(ref.flash_attention, launches), iters=3)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = yardstick_ms(
        lambda: [sdpa(q, k, v, is_causal=True, enable_gqa=True)
                 for q, k, v in launches], 10, detail, "flash_library")
    for t in (64, 128, 256, 512):
        one = [[x[:, :, :t].contiguous() for x in launches[0]]]
        us = graph_time_ms(prefill(ops.attention, one), iters=20) * 1e3
        detail.append({"flash_T": t, "kernel_us": us,
                       "bound_us": flash_bound(one)[0] * 1e3})
    counts = serve_info["launches"]
    bound_ms, bound_by = flash_bound(launches)
    flash = {"name": "flash_attention", "route": "cuda",
             "source": FLASH_SRC[0], "replaces": FLASH_SRC[1],
             "launches": counts["flash_attention"],
             "unit": "one 512-token prefill of llama2-7b: 32 launches, "
                     "B 1, 32/32 heads, D 128, causal, bf16, CUDA-graph "
                     "replay",
             "ms": k_ms, "plain_ms": p_ms,
             "bound_ms": bound_ms, "bound_by": bound_by,
             "library_ms": lib_ms,
             "library_note": "scaled_dot_product_attention(is_causal=True, "
                             "enable_gqa=True) on the same tensors",
             "eager_ms": eager_ms}
    # paged at llama2-7b's decode shape: 8 slots at the serve path's
    # prompt lengths, 16 tokens into their decode
    lens = [n - 1 + 16 for n in serve_info["prompt_lens"][:8]]
    paged = paged_step_times(gen, dev, L, 32, 32, 128, 1024 // 16, lens,
                             detail, "paged_llama2_library")
    paged["unit"] = ("one decode step of llama2-7b: 32 launches, 8 slots, "
                     f"32/32 heads, D 128, lengths {lens}, CUDA-graph replay")
    emit({"phase": "times", "path": "serve_path", "flash": flash,
          "paged_llama2": paged, "detail": detail})
    emit({"info": "times before the redesign, from PERF.md; NOT measured "
                  "in this run", **BEFORE_REDESIGN})
    return flash, paged


def rwkv_bound(B, H, T, D, itemsize, launches=1):
    """(ms, "bytes" or "operations"): max(bytes / HBM rate, flops / f32
    peak) with r, k, v, w read once, out written once, the f32 final state
    written once, and the 5 D^2 f32 operations per (b, h, t) that the
    function needs: 3 D^2 for the update w S + k v, 2 D^2 for sum_i r_i
    S_ij (the bonus term v_j sum_i r_i u_i k_i is O(D), left out)."""
    nbytes = launches * (5 * B * H * T * D * itemsize + 4 * B * H * D * D)
    flops = launches * 5 * D * D * B * H * T
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                        else "operations")


def phase_times_rwkv(dev, rwkv_info):
    """The scan kernel over one full-width forward's 32 launches at the
    path's shape (B 4, H 64, T 512, D 64, bf16), each on its own inputs."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    bf = torch.bfloat16
    L = 32
    launches = [rwkv_inputs(gen, dev, *RWKV_FWD, bf, "model") for _ in range(L)]

    def fwd(fn, ls):
        return lambda: [fn(*a) for a in ls]

    k_ms = graph_time_ms(fwd(ops.rwkv6, launches), iters=10)
    eager_ms = cuda_time_ms(fwd(ops.rwkv6, launches), iters=3)
    p_ms = cuda_time_ms(fwd(ref.rwkv6_scan, launches), iters=1, warmup=1)
    detail = []
    for B, T in ((1, 512), (4, 37), (4, 1)):
        one = [[a[:B, :, :T].contiguous() if a.dim() == 4 else a
                for a in launches[0]]]
        detail.append({"rwkv_B": B, "T": T,
                       "kernel_us": graph_time_ms(fwd(ops.rwkv6, one),
                                                  iters=20) * 1e3,
                       "bound_us": rwkv_bound(B, 64, T, 64, 2)[0] * 1e3})
    bound_ms, bound_by = rwkv_bound(*RWKV_FWD, 2, launches=L)
    kern = {"name": "rwkv6_scan", "route": "cuda", "source": RWKV_SRC[0],
            "replaces": RWKV_SRC[1],
            "launches": rwkv_info["launches"]["rwkv6_scan"],
            "unit": "one rwkv6-7b forward of 4 x 512 tokens: 32 launches, "
                    "B 4, H 64, T 512, D 64, bf16, CUDA-graph replay; plain "
                    "timed eagerly (one call of 32 launches)",
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "library_note": "none: no single PyTorch call computes the WKV "
                            "recurrence",
            "eager_ms": eager_ms}
    emit({"phase": "times", "path": "rwkv_path", "rwkv6_scan": kern,
          "detail": detail})
    return kern


def main() -> int:
    dev_info = phase_device()
    dev = torch.device("cuda", 0)
    smi = dev_info["nvidia_smi"]
    phase_build()
    errs = {"w4a8_matmul": phase_w4a8(dev),
            "paged_decode_attention": phase_paged(dev),
            "flash_attention": phase_flash(dev),
            "rwkv6_scan": phase_rwkv(dev)}
    phase_reference(dev)
    phase_reference_serve(dev)
    phase_reference_rwkv(dev)
    eng, main_info = phase_main_path(dev, smi)
    phase_profile(eng, dev, "main_path")
    kernels = phase_times(eng, dev, main_info["launches"])
    del eng                          # release tinyllama before llama2-7b
    gc.collect()
    torch.cuda.empty_cache()
    eng, serve_info = phase_serve_path(dev, smi)
    phase_profile(eng, dev, "serve_path")
    flash, paged_llama2 = phase_times_serve(dev, serve_info)
    kernels.append(flash)
    del eng                          # release llama2-7b before rwkv6-7b
    gc.collect()
    torch.cuda.empty_cache()
    eng, rwkv_info = phase_rwkv_path(dev, smi)
    phase_profile(eng, dev, "rwkv_path")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    kernels.append(phase_times_rwkv(dev, rwkv_info))
    for k in kernels:
        k["max_abs_err"] = errs[k["name"]]
        k["launches_by_path"] = {
            "main_path": main_info["launches"][k["name"]],
            "serve_path": serve_info["launches"][k["name"]],
            "rwkv_path": rwkv_info["launches"][k["name"]]}
        check(k["launches"] > 0, f"{k['name']} never launched on its path")
    kernels[1]["llama2_decode"] = paged_llama2
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev_info["name"],
                                 "count": dev_info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
