"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device: the fixture decides at run time and
skips without one.  Run them on the H100 with
``python -m pytest -m gpu tests/test_torch_*.py``.  This file imports
neither JAX nor the JAX package.

Tolerances: W4A8 is bit-identical (exact int32 sums, the same two f32
multiplies, one round-to-nearest-even to bf16), and one call is one device
kernel.  Paged and flash attention
in f32 are held to atol 1e-5 (the same f32 math in another summation
order), in bf16 to one bf16 ulp (that order can flip the final rounding);
flash attention's bf16 bound adds the f32 one, and the paged split-K
cases add the per-element f32 bound of two sum orders
(``ref.paged_decode_order_bound``), since an output near zero after
cancellation has a bf16 ulp below the f32 sum-order error.  The paged
kernel splits a slot's pages across blocks and merges them by log-sum-exp,
in a fixed order: a second call is bit-identical.  Its LSE
(``return_lse=True``) is held to the plain version's at atol 1e-5 for a
live slot and to at most -1e29 for an empty one.  The RWKV6
scan's state is the plain version's bit for bit (the same rounded f32 ops
in the same order), checked with ``torch.equal``; its f32 output is held to atol 1e-4 (the JAX kernel
test's), its bf16 output to one bf16 ulp plus the f32 bound of two orders
of its D-term sum over the k-dim (``ref.rwkv6_scan_order_bound``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import quant
from repro_torch.core.device import exact_matmuls
from repro_torch.kernels import ops, ref
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import paged_attention as kpa
from repro_torch.kernels import rwkv_scan as krw
from repro_torch.kernels import w4a8_matmul as kw
from repro_torch.models import api, rwkv6
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import ContinuousBatchingScheduler, Request
from repro_torch.serve.splitbrain_engine import SplitBrainEngine
from torch_cases import (assert_within_bf16_ulp, autograd_grads,
                         bf16_ulp_of, load_example, paged_case,
                         pick_report, run_paged,
                         rwkv_case, rwkv_decay_bits_report,
                         teacher_forced_logits, w4a8_case)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    """A CUDA device, or a skip: decided here, at run time, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run `python -m pytest -m gpu "
                    "tests/test_torch_*.py` on the H100")
    # cuBLAS may reduce bf16 products in bf16 by default; the CPU does not
    exact_matmuls()
    return torch.device("cuda")


# every projection shape of tinyllama-1.1b (the main path) at M 1-8, ragged
# shapes, and llama2-7b's shapes (K, N)
TINYLLAMA_W4A8 = [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048),
                  (2048, 32000)]
LLAMA2_W4A8 = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)]
RAGGED_W4A8 = [(1, 2048, 2048), (8, 2048, 256), (3, 100, 37), (13, 5632, 130),
               (8, 64, 32000)]
W4A8 = RAGGED_W4A8 + [
    c for c in ([(M, K, N) for K, N in TINYLLAMA_W4A8 for M in range(1, 9)]
                + [(M, K, N) for K, N in LLAMA2_W4A8 for M in (1, 5, 8)]
                + [(17, 4096, 4096), (40, 300, 1000)])
    if c not in RAGGED_W4A8]


def _w4a8_on_card(M, K, N, dev, seed):
    """The operands of w4a8_case, drawn on the card (llama2-7b's matrices
    are large), with the codes' packed layout."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    qx = torch.randint(-127, 128, (M, K), generator=gen, device=dev,
                       dtype=torch.int8)
    xs = torch.rand((M, 1), generator=gen, device=dev) * 0.02 + 1e-3
    codes = torch.randint(-7, 8, (K, N), generator=gen, device=dev,
                          dtype=torch.int8)
    ws = torch.rand((N,), generator=gen, device=dev) * 0.05 + 1e-3
    return (qx, xs, codes, ws), kw.pack_codes(codes)


@pytest.mark.parametrize("M,K,N", W4A8)
def test_w4a8_kernel_bit_identical_to_plain(cuda, M, K, N):
    if (M, K, N) in RAGGED_W4A8:
        ts = [torch.from_numpy(a).to(cuda) for a in w4a8_case(M, K, N, seed=M)]
        packed = kw.pack_codes(ts[2])
    else:
        ts, packed = _w4a8_on_card(M, K, N, cuda, seed=M * 7 + N)
    for dt in (torch.bfloat16, torch.float32):
        n0 = kw.w4a8_matmul.launches
        out = ops.w4a8_matmul(*ts, out_dtype=dt, packed=packed)
        torch.cuda.synchronize()
        assert kw.w4a8_matmul.launches == n0 + 1
        torch.testing.assert_close(out, ref.w4a8_matmul(*ts, dt), rtol=0,
                                   atol=0)


@pytest.mark.parametrize("M,K,N", [(8, 2048, 256), (1, 2048, 2048),
                                   (8, 2048, 32000), (13, 5632, 130),
                                   (8, 11008, 4096)])
def test_w4a8_call_is_one_device_kernel(cuda, M, K, N):
    """One call is one kernel on the card: no workspace memset, no second
    epilogue kernel (torch.profiler's device activity over one call)."""
    from torch.profiler import ProfilerActivity, profile
    ts, packed = _w4a8_on_card(M, K, N, cuda, seed=3)
    ops.w4a8_matmul(*ts, packed=packed)             # built and warm
    # a profiler session early in a process can record no device activity
    # at all: such a session is taken again (as chip_smoke.device_kernels)
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = ops.w4a8_matmul(*ts, packed=packed)
            torch.cuda.synchronize()
        names = [ev.key for ev in prof.key_averages()
                 for _ in range(ev.count)
                 if str(getattr(ev, "device_type", "")).endswith("CUDA")]
        if names:
            break
    assert len(names) == 1 and "w4a8" in names[0], names
    assert torch.equal(out, ref.w4a8_matmul(*ts))


GEOMS = [dict(ps=8), dict(ps=3, P=10), dict(ps=1, P=32, lens=(0, 1, 31)),
         dict(ps=8, Hq=4, Hkv=4), dict(ps=8, Hq=8, Hkv=1),
         dict(ps=16, Hq=32, Hkv=4, D=64, P=6, lens=(0, 17, 96))]


@pytest.mark.parametrize("kv", [None, "int8", "fp8"])
@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("opts", [dict(), dict(window=6, softcap=5.0)])
def test_paged_kernel_matches_plain_f32(cuda, kv, geom, opts):
    case = {k: v.to(cuda) for k, v in paged_case(4, kv=kv, **geom).items()}
    n0 = kpa.paged_decode_attention.launches
    out = run_paged(case, ops.paged_decode_attention, **opts)
    torch.cuda.synchronize()
    assert kpa.paged_decode_attention.launches == n0 + 1
    plain = run_paged(case, ref.paged_decode_attention, **opts)
    torch.testing.assert_close(out, plain, rtol=0, atol=1e-5)
    assert not out[0].any()              # the empty slot returns zeros


def test_paged_kernel_bf16_within_one_ulp(cuda):
    case = {k: v.to(cuda) for k, v in paged_case(
        5, dtype=torch.bfloat16, ps=16, Hq=32, Hkv=4, D=64, P=6,
        lens=(0, 33, 96)).items()}
    out = run_paged(case, ops.paged_decode_attention)
    plain = run_paged(case, ref.paged_decode_attention)
    assert out.dtype == torch.bfloat16
    assert_within_bf16_ulp(out, plain.float().cpu().numpy())


# where the split of a slot's pages across blocks matters: a slot of 1,000
# positions beside slots of 1 and 0 (63 live chunks to merge), windows that
# cross chunk boundaries, GQA with a group of 8 and of 16 (two row slices),
# and llama2-7b's serve-path decode geometry (8 slots, 32/32 heads, P 64:
# split_plan's 16-page chunks)
SPLIT = [dict(B=3, Hq=4, Hkv=4, D=128, ps=16, P=64, lens=(0, 1000, 1)),
         dict(B=3, Hq=8, Hkv=1, D=64, ps=16, P=64, lens=(1, 0, 777)),
         dict(B=4, Hq=32, Hkv=2, D=64, ps=8, P=20, lens=(160, 0, 9, 100)),
         dict(B=2, Hq=2, Hkv=2, D=256, ps=16, P=12, lens=(0, 190)),
         dict(B=8, Hq=32, Hkv=32, D=128, ps=16, P=64,
              lens=(143, 527, 208, 0, 300, 79, 431, 1024))]


@pytest.mark.parametrize("geom", range(len(SPLIT)))
@pytest.mark.parametrize("opts", [dict(), dict(window=37),
                                  dict(window=250, softcap=30.0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_paged_kernel_split_and_lse_match_plain(cuda, geom, opts, dtype):
    case = {k: v.to(cuda) for k, v in paged_case(
        9 + geom, dtype=dtype, **SPLIT[geom]).items()}
    n0 = kpa.paged_decode_attention.launches
    out, lse = run_paged(case, ops.paged_decode_attention, return_lse=True,
                         **opts)
    again = run_paged(case, ops.paged_decode_attention, **opts)
    torch.cuda.synchronize()
    assert kpa.paged_decode_attention.launches == n0 + 2
    assert torch.equal(out, again)        # the merge order is fixed
    plain, p_lse = run_paged(case, ref.paged_decode_attention,
                             return_lse=True, **opts)
    if dtype == torch.float32:
        torch.testing.assert_close(out, plain, rtol=0, atol=1e-5)
    else:
        assert_within_bf16_ulp(out, plain.float().cpu().numpy(),
                               atol=_order_bound(case, **opts))
    live = case["lens"] > 0
    torch.testing.assert_close(lse[live], p_lse[live], rtol=0, atol=1e-5)
    assert bool((lse[~live] <= -1e29).all())
    assert not out[~live].any()           # an empty slot returns zeros


def _order_bound(case, **opts):
    """ref.paged_decode_order_bound for the case, as a numpy allowance."""
    return run_paged(case, ref.paged_decode_order_bound,
                     **opts).cpu().numpy().astype(np.float64)


def test_paged_merge_counters_hold_across_graph_replay_and_streams(cuda):
    """The merge counters are the call's own and zeroed by its launch: a
    captured call replays right after a larger call and after its memory
    pool was dirtied, and two streams run calls at once."""
    small = {k: v.to(cuda) for k, v in paged_case(
        21, dtype=torch.bfloat16, B=3, Hq=8, Hkv=2, D=64, ps=16, P=64,
        lens=(700, 0, 1000)).items()}
    large = {k: v.to(cuda) for k, v in paged_case(
        22, dtype=torch.bfloat16, B=8, Hq=32, Hkv=32, D=128, ps=16, P=64,
        lens=(1024,) * 8).items()}
    plain = {n: run_paged(c, ref.paged_decode_attention)
             for n, c in (("small", small), ("large", large))}
    run_paged(small, ops.paged_decode_attention)         # warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run_paged(small, ops.paged_decode_attention)
    for _ in range(2):
        assert torch.equal(run_paged(large, ops.paged_decode_attention),
                           run_paged(large, ops.paged_decode_attention))
        torch.empty(1 << 24, dtype=torch.int32, device=cuda).fill_(7)
        graph.replay()
        torch.cuda.synchronize()
        assert_within_bf16_ulp(captured, plain["small"].float().cpu().numpy(),
                               atol=_order_bound(small))
    streams = [torch.cuda.Stream() for _ in range(2)]
    outs = []
    torch.cuda.synchronize()
    for st, c in zip(streams, (large, small)):
        with torch.cuda.stream(st):
            outs.append(run_paged(c, ops.paged_decode_attention))
    torch.cuda.synchronize()
    for out, (n, c) in zip(outs, (("large", large), ("small", small))):
        assert_within_bf16_ulp(out, plain[n].float().cpu().numpy(),
                               atol=_order_bound(c))


@pytest.mark.parametrize("kv", [None, "int8", "fp8"])
@pytest.mark.parametrize("geom", GEOMS)
def test_paged_kernel_lse_matches_plain(cuda, kv, geom):
    case = {k: v.to(cuda) for k, v in paged_case(4, kv=kv, **geom).items()}
    out, lse = run_paged(case, ops.paged_decode_attention, return_lse=True,
                         window=6, softcap=5.0)
    plain, p_lse = run_paged(case, ref.paged_decode_attention,
                             return_lse=True, window=6, softcap=5.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, plain, rtol=0, atol=1e-5)
    live = case["lens"] > 0
    torch.testing.assert_close(lse[live], p_lse[live], rtol=0, atol=1e-5)
    assert bool((lse[~live] <= -1e29).all())


def test_engine_on_card_matches_cpu_and_counts_launches(cuda):
    """Reduced tinyllama served on the card, through the CUDA kernels, and
    on the CPU through the plain versions, from the same weights: the same
    tokens, and every projection and every decode attention of the card's
    run was a kernel launch."""
    cfg = get_config("tinyllama-1.1b").reduced()
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    reqs = [Request(uid=i, prompt=np.arange(1, 6 + 2 * i, dtype=np.int32),
                    max_new=5) for i in range(4)]
    runs = {}
    for dev in ("cpu", "cuda"):
        eng = SplitBrainEngine(cfg, params, max_len=32, page_size=8, device=dev)
        ops.reset_launch_counts()
        runs[dev] = ContinuousBatchingScheduler(eng, max_slots=2).run(reqs)
        counts = ops.launch_counts()
    out = runs["cuda"]
    L = cfg.num_layers
    assert counts == {
        "w4a8_matmul": (7 * L + 1) * (out["prefill_tokens"] + out["steps"]),
        "paged_decode_attention": L * out["steps"],
        "flash_attention": 0, "rwkv6_scan": 0}
    assert ([r.tokens.tolist() for r in out["results"]]
            == [r.tokens.tolist() for r in runs["cpu"]["results"]])


FLASH = [  # (B, Hq, Hkv, Tq, Tk, D, options); bf16 at D 256 and 96 is refused
    (2, 4, 2, 37, 37, 16, dict(causal=True)),
    (1, 4, 4, 130, 130, 64, dict(causal=True, window=20, softcap=30.0)),
    (1, 8, 2, 5, 77, 128, dict(causal=True, kv_offset=72)),
    (2, 4, 2, 9, 70, 128, dict(causal=False, kv_offset=3, scale=0.2)),
    (1, 2, 1, 1, 1, 256, dict(causal=True)),
    (1, 4, 2, 65, 65, 48, dict(causal=True)),
    (1, 8, 2, 512, 512, 128, dict(causal=True)),
    (2, 4, 2, 200, 200, 48, dict(causal=True, window=70, softcap=20.0)),
    (1, 4, 1, 130, 300, 16, dict(causal=True, kv_offset=170)),
    (1, 2, 2, 70, 70, 96, dict(causal=True)),
    (1, 4, 4, 2048, 2048, 128, dict(causal=True)),
    (8, 4, 4, 512, 512, 64, dict(causal=False)),
]


def _flash_inputs(B, Hq, Hkv, Tq, Tk, D, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=g, device=dev).to(dtype)
            for s in ((B, Hq, Tq, D), (B, Hkv, Tk, D), (B, Hkv, Tk, D))]


@pytest.mark.parametrize("case", range(len(FLASH)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_kernel_matches_plain(cuda, case, dtype):
    *shape, opts = FLASH[case]
    q, k, v = _flash_inputs(*shape, dtype, cuda, seed=case)
    n0 = kfa.flash_attention.launches
    if dtype == torch.bfloat16 and shape[-1] not in kfa.TENSOR_CORE_HEAD_DIMS:
        with pytest.raises(ValueError, match="bf16 head dim"):
            ops.attention(q, k, v, **opts)      # no body takes it
        assert kfa.flash_attention.launches == n0
        return
    out = ops.attention(q, k, v, **opts)
    torch.cuda.synchronize()
    assert kfa.flash_attention.launches == n0 + 1
    plain = ref.flash_attention(q, k, v, **opts)
    assert out.dtype == dtype and out.shape == q.shape
    if dtype == torch.float32:
        torch.testing.assert_close(out, plain, rtol=0, atol=1e-5)
    else:   # + the f32 bound: a near-zero output's ulp is below it
        assert_within_bf16_ulp(out, plain.float().cpu().numpy(), atol=1e-5)


@pytest.mark.parametrize("arch", ["llama2-7b", "tinyllama-1.1b",
                                  "gemma2-27b", "stablelm-1.6b",
                                  "granite-8b", "minitron-8b"])
def test_serve_engine_on_card_matches_cpu_and_counts_launches(cuda, arch):
    """Reduced ServeEngine on the card (flash prefill, paged decode) and on
    the CPU (plain versions) from the same weights: the same tokens under
    the scheduler and generate(), one flash launch per layer per prefill
    and one paged launch per paging layer per decode step.  Reduced
    gemma2's local layer keeps a 16-position ring (no paged launch): its
    17-token prompt fills the ring before decode wraps it, and generate()
    on 24-token prompts takes the per-token prefill (no flash launch)."""
    cfg = get_config(arch).reduced()
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    reqs = [Request(uid=i, prompt=(np.arange(1, 6 + 4 * i) * 7 % 256)
                    .astype(np.int32), max_new=6) for i in range(4)]
    prompts = np.stack([(np.arange(1, 10) * (3 + i)) % 256
                        for i in range(3)]).astype(np.int32)
    long = np.stack([(np.arange(1, 25) * (5 + i)) % 256
                     for i in range(2)]).astype(np.int32)
    runs = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(cfg, params, max_len=64, page_size=8, device=dev)
        ops.reset_launch_counts()
        out = ContinuousBatchingScheduler(eng, max_slots=2).run(reqs)
        counts = ops.launch_counts()
        gen = eng.generate(prompts, max_new=6)
        gen_counts = ops.launch_counts()
        runs[dev] = ([r.tokens.tolist() for r in out["results"]],
                     gen["tokens"].tolist(),
                     eng.generate(long, max_new=6)["tokens"].tolist())
    L = cfg.num_layers
    paging = L // len(cfg.layer_pattern) * sum(ax >= 0 for ax in eng._sa["k"])
    assert paging == (L // 2 if arch == "gemma2-27b" else L)
    assert counts == {"w4a8_matmul": 0, "flash_attention": L * len(reqs),
                      "paged_decode_attention": paging * out["steps"],
                      "rwkv6_scan": 0}
    assert gen_counts["flash_attention"] == counts["flash_attention"] + L
    assert gen_counts["paged_decode_attention"] == counts[
        "paged_decode_attention"]
    assert runs["cuda"] == runs["cpu"]


RWKV = [  # (B, H, T, D): the JAX kernel tests' shapes, ragged T, H > 1
    (2, 3, 64, 16), (1, 2, 128, 32), (1, 1, 32, 64), (2, 4, 37, 64),
    (3, 5, 1, 32),
    # the column-split grid's edges: B 1, T 1 / 37 / 512 (chunk tails and
    # many chunks), every D, odd H; rwkv6-7b's heads at B 1
    (1, 3, 1, 16), (1, 5, 37, 16), (1, 3, 512, 16), (1, 5, 512, 32),
    (1, 3, 37, 64), (1, 5, 512, 64), (1, 3, 1, 64), (1, 64, 512, 64)]


@pytest.mark.parametrize("case", range(len(RWKV)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_rwkv_kernel_matches_plain(cuda, case, dtype):
    r, k, v, w, u = (torch.from_numpy(a).to(cuda)
                     for a in rwkv_case(*RWKV[case], seed=case))
    r, k, v, w = (t.to(dtype) for t in (r, k, v, w))
    n0 = krw.rwkv6_scan.launches
    out, state = ops.rwkv6(r, k, v, w, u)
    again = ops.rwkv6(r, k, v, w, u)
    torch.cuda.synchronize()
    assert krw.rwkv6_scan.launches == n0 + 2
    assert torch.equal(out, again[0]) and torch.equal(state, again[1])
    p_out, p_state = ref.rwkv6_scan(r, k, v, w, u)
    assert out.dtype == dtype and state.dtype == torch.float32
    assert torch.equal(state, p_state)     # the update's order is the plain one
    if dtype == torch.float32:
        torch.testing.assert_close(out, p_out, rtol=0, atol=1e-4)
    else:   # + the f32 bound of two orders of out's D-term sum
        assert_within_bf16_ulp(out, p_out.float().cpu().numpy(),
                               atol=ref.rwkv6_scan_order_bound(
                                   r, k, v, w, u).cpu().numpy())


def test_rwkv_engine_and_forward_on_card_match_cpu(cuda):
    """Reduced rwkv6-7b on the card and on the CPU from the same weights,
    over four weight seeds.  The serve path launches no kernel (every decode
    step carries the state); the tokens the card chose under the scheduler
    and generate(), fed back teacher-forced through the decode steps on both
    devices, give float32 logits within two bf16 ulps of the largest, and a
    token the CPU would not choose is a near-tie (its CPU logit short of the
    largest by at most twice that).  forward's bf16-rounded logits agree
    within one ulp of the largest, with one scan launch per layer."""
    cfg = get_config("rwkv6-7b").reduced()
    reqs = [Request(uid=i, prompt=(np.arange(1, 6 + 4 * i) * 7 % 256)
                    .astype(np.int32), max_new=6) for i in range(4)]
    prompts = np.stack([(np.arange(1, 10) * (3 + i)) % 256
                        for i in range(3)]).astype(np.int32)
    toks = torch.from_numpy(prompts)
    for seed in range(4):
        params = api.init_params(cfg, torch.Generator().manual_seed(seed),
                                 "cpu")
        engs = {dev: ServeEngine(cfg, params, max_len=64, page_size=8,
                                 device=dev) for dev in ("cpu", "cuda")}
        ops.reset_launch_counts()
        out = ContinuousBatchingScheduler(engs["cuda"], max_slots=2).run(reqs)
        gen = engs["cuda"].generate(prompts, max_new=6)
        assert sum(ops.launch_counts().values()) == 0
        seqs = ([(q.prompt, r.tokens) for q, r in zip(reqs, out["results"])]
                + list(zip(prompts, gen["tokens"])))
        assert all(len(t) == 6 for _, t in seqs)
        tf = {dev: torch.cat([teacher_forced_logits(engs[dev].params, cfg,
                                                    p, t, dev)
                              for p, t in seqs]) for dev in engs}
        rep = pick_report(tf["cpu"], tf["cuda"],
                          np.concatenate([t for _, t in seqs]))
        tol = 2 * bf16_ulp_of(rep["max_abs_logit"])
        assert rep["max_abs_err"] <= tol and rep["shortfall"] <= 2 * tol, rep
        fwd = {dev: api.forward(engs[dev].params, toks.to(dev), cfg)[0]
               .reshape(-1, cfg.vocab_size).cpu() for dev in engs}
        assert ops.launch_counts()["rwkv6_scan"] == cfg.num_layers
        rep = pick_report(fwd["cpu"], fwd["cuda"], fwd["cuda"].argmax(-1))
        tol = bf16_ulp_of(rep["max_abs_logit"])
        assert rep["max_abs_err"] <= tol and rep["shortfall"] <= 2 * tol, rep


def test_rwkv_decay_path_ops_bit_identical_card_vs_cpu(cuda):
    """Each op on the way to reduced rwkv6-7b's decay and gate, run on the
    card and on the CPU from the same CPU inputs: the decay the model uses
    (``rwkv6.decay``, float64 exps) has the CPU's bits in every layer,
    where the float32 exps taken op by op differ in the last place on
    many of the elements."""
    cfg = get_config("rwkv6-7b").reduced()
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    sp = rwkv6.serve_params(params, cfg, "cpu")
    x = torch.randn((4, 64, cfg.d_model),
                    generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    for _, p in rwkv6._layers(sp):
        rep = rwkv_decay_bits_report(p, x, cuda)
        assert rep["decay"]["differ"] == 0, rep
        assert rep["exp_inner"]["differ"] > 0, rep   # the op this repairs


def test_xla_tanh_on_card_matches_cpu(cuda):
    """``ref.tanh`` (the softcaps' tanh, XLA's rational form) gives the
    CPU's bits on the card: the same clamp, fused multiply-adds and IEEE
    division."""
    g = torch.Generator().manual_seed(3)
    x = torch.cat([torch.randn(1 << 18, generator=g) * s
                   for s in (1e-4, 0.01, 0.3, 1.0, 4.0, 20.0)])
    assert torch.equal(ref.tanh(x.to(cuda)).cpu(), ref.tanh(x))


@pytest.mark.parametrize("with_eos", [False, True], ids=["no_eos", "eos"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "stepwise"])
@pytest.mark.parametrize("quantize", [True, False], ids=["w4a8", "float"])
def test_splitbrain_generate_on_card_matches_cpu(cuda, quantize, fused,
                                                 with_eos):
    """Reduced tinyllama's split-brain generate() on the card and on the
    CPU from the same weights: the same tokens, gen_len and meter; with
    W4A8 weights every projection of every token step is a kernel launch
    (7 per layer and the head) and attention is the dense plain op."""
    cfg = get_config("tinyllama-1.1b").reduced()
    params = api.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    prompts = np.stack([(np.arange(1, 7) * (5 + 2 * i) + i) % 256
                        for i in range(3)]).astype(np.int32)
    eos, runs = None, {}
    for dev in ("cpu", "cuda"):
        eng = SplitBrainEngine(cfg, params, max_len=16, quantize=quantize,
                               fused=fused, device=dev)
        if with_eos and eos is None:
            eos = int(eng.generate(prompts, max_new=8)["tokens"][1, 2])
            eng.meter.reset()
        ops.reset_launch_counts()
        out = eng.generate(prompts, max_new=8, eos_id=eos)
        runs[dev] = (out["tokens"].tolist(), out["gen_len"].tolist(),
                     eng.meter.measured_bytes(), ops.launch_counts())
    assert runs["cuda"][:3] == runs["cpu"][:3]
    steps = prompts.shape[1] - 1 + 8
    if fused or not with_eos:
        assert runs["cuda"][3] == {
            "w4a8_matmul": (7 * cfg.num_layers + 1) * steps if quantize
            else 0, "paged_decode_attention": 0, "flash_attention": 0,
            "rwkv6_scan": 0}


@pytest.mark.parametrize("K,N", [(2048, 2048), (2048, 5632), (4096, 11008)])
def test_laq_on_card_bit_identical_to_cpu(cuda, K, N):
    """LAQ codes and scales, and the activation quantizer in both its
    eager (true division) and compiled (reciprocal) forms, on the card and
    on the CPU from the same inputs, at full-width shapes: bit for bit.
    (Dividing by a Python number on CUDA multiplies by its reciprocal: at
    tinyllama-1.1b's full width that moved codes, which reduced shapes
    did not show.)"""
    rng = np.random.default_rng(K + N)
    w = torch.from_numpy(rng.normal(size=(K, N)).astype(np.float32) * 0.02)
    x = torch.from_numpy(rng.normal(size=(64, K)).astype(np.float32))
    cpu = quant.quantize_weights(w)
    card = quant.quantize_weights(w.to(cuda))
    assert torch.equal(card.codes.cpu(), cpu.codes)
    assert torch.equal(card.scales.cpu(), cpu.scales)
    for reciprocal in (False, True):
        qc, sc = quant.quantize_activations_int8(x, reciprocal=reciprocal)
        qd, sd = quant.quantize_activations_int8(x.to(cuda),
                                                 reciprocal=reciprocal)
        assert torch.equal(qd.cpu(), qc) and torch.equal(sd.cpu(), sc)


def test_quickstart_example_on_card_matches_cpu(cuda):
    """``examples/quickstart_torch.py``'s ``run()`` on the card and on the
    CPU from the same weights (the example's reduced tinyllama): the same
    wq codes, pruned share, tokens (each ``decode_token`` fed its own
    ``next_tok``, on the card), meter and report; 7 W4A8 launches per layer
    and one for the head per token step, no other kernel."""
    qs = load_example("quickstart_torch")
    cfg = get_config("tinyllama-1.1b").reduced(vocab_size=512)
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cpu = qs.run(cfg, params, device="cpu")
    ops.reset_launch_counts()
    card = qs.run(cfg, params, device=cuda)
    assert ops.launch_counts() == {
        "w4a8_matmul": (7 * cfg.num_layers + 1) * 8,
        "paged_decode_attention": 0, "flash_attention": 0, "rwkv6_scan": 0}
    assert card["codes"].is_cuda
    assert torch.equal(card["codes"].cpu(), cpu["codes"])
    for key in ("pruned", "tokens", "measured_bytes_per_token",
                "model_bytes_per_token", "report"):
        assert card[key] == cpu[key], key
    assert card["measured_bytes_per_token"] == card["model_bytes_per_token"]


def test_serve_example_on_card_matches_cpu(cuda):
    """``examples/serve_splitbrain_torch.py``'s ``run()`` on the card and on
    the CPU (the example's reduced llama2-7b, 4 prompts of 5, 12 new): the
    same tokens of every run and the same meter; W4A8 launches only in the
    LAQ runs, 7 per layer and one for the head per token step."""
    sv = load_example("serve_splitbrain_torch")
    cfg = get_config("llama2-7b").reduced(vocab_size=512)
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = np.random.default_rng(0).integers(
        1, cfg.vocab_size, (4, 5)).astype(np.int32)
    cpu = sv.run(cfg, params, prompts, device="cpu")
    card = sv.run(cfg, params, prompts, device=cuda)
    for run in ("float_fused", "float_stepwise", "w4a8"):
        np.testing.assert_array_equal(card["tokens"][run], cpu["tokens"][run])
    assert card["measured_bytes_per_token"] == cpu["measured_bytes_per_token"]
    assert card["measured_bytes_per_token"] == card["model_bytes_per_token"]
    per_step = 7 * cfg.num_layers + 1
    parts = card["launches"]
    assert parts["w4a8"]["w4a8_matmul"] == per_step * (4 + 12)
    assert parts["w4a8_decode_token"]["w4a8_matmul"] == per_step
    assert not any(v for name in ("float_warmup", "float_fused",
                                  "float_stepwise")
                   for v in parts[name].values())
    assert all(parts[name][k] == 0 for name in parts
               for k in ("paged_decode_attention", "flash_attention",
                         "rwkv6_scan"))


# gemma2-27b's attention at full width: 32 query heads over 16 KV heads of
# 128, softcap 50, the local layers' 4096-token window; lengths that cross
# the window
@pytest.mark.parametrize("T", [4080, 4200])
@pytest.mark.parametrize("window", [4096, None])
def test_flash_kernel_at_gemma2_shape(cuda, T, window):
    q, k, v = _flash_inputs(1, 32, 16, T, T, 128, torch.bfloat16, cuda,
                            seed=T)
    opts = dict(causal=True, window=window, softcap=50.0)
    out = ops.attention(q, k, v, **opts)
    plain = ref.flash_attention(q, k, v, **opts)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert_within_bf16_ulp(out, plain.float().cpu().numpy(), atol=1e-5)


@pytest.mark.parametrize("window", [None, 4096])
def test_paged_kernel_at_gemma2_shape(cuda, window):
    case = {k: v.to(cuda) for k, v in paged_case(
        31, dtype=torch.bfloat16, B=4, Hq=32, Hkv=16, D=128, ps=16, P=264,
        lens=(1, 1000, 4096, 4117)).items()}
    opts = dict(window=window, softcap=50.0)
    out = run_paged(case, ops.paged_decode_attention, **opts)
    plain = run_paged(case, ref.paged_decode_attention, **opts)
    torch.cuda.synchronize()
    assert_within_bf16_ulp(out, plain.float().cpu().numpy(),
                           atol=_order_bound(case, **opts))


# ---------------------------------------------------------------- KV features
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_kv_quantizer_on_card_matches_cpu(cuda, kv_dtype):
    """The page scale (table lookups), encode (half-to-even int8, the
    round-to-nearest-even fp8 cast), decode, the page append and the
    fake-quant give the CPU's bits on the card."""
    from repro_torch.models import layers as L
    gen = torch.Generator().manual_seed(7)
    qmax = {"int8": 127.0, "fp8": 448.0}[kv_dtype]
    edge = qmax * torch.exp2(torch.arange(-30, 12, dtype=torch.float32))
    amax = torch.cat([edge, torch.nextafter(edge, torch.zeros(())),
                      torch.nextafter(edge, torch.full((), 1e9)),
                      torch.exp2(torch.rand(5000, generator=gen) * 30 - 20)])
    s_cpu = L.kv_pow2_scale(amax, kv_dtype)
    assert torch.equal(L.kv_pow2_scale(amax.to(cuda), kv_dtype).cpu(), s_cpu)
    x = torch.randn((64, 128), generator=gen) * 3
    sc = L.kv_pow2_scale(x.abs().amax(dim=1, keepdim=True), kv_dtype)
    q_cpu = L.kv_quantize(x, sc, kv_dtype)
    q_dev = L.kv_quantize(x.to(cuda), sc.to(cuda), kv_dtype)
    assert torch.equal(L.byte_view(q_dev).cpu(), L.byte_view(q_cpu))
    # append into a recycled pool: fresh page 3, page 5 mid, scratch twice
    codes = L.kv_quantize(torch.randn((9, 8, 2, 16), generator=gen),
                          torch.full((9, 1, 2, 1), 2.0 ** -5), kv_dtype)
    scales = torch.full((9, 2), 2.0 ** -5)
    tok = torch.randn((4, 2, 16), generator=gen).bfloat16().float()
    page, off = torch.tensor([3, 0, 5, 0]), torch.tensor([0, 0, 4, 0])
    pools = {d: (codes.clone().to(d), scales.clone().to(d))
             for d in ("cpu", cuda)}
    for d, (c, s) in pools.items():
        L.quant_page_append(c, s, tok.to(d), page.to(d), off.to(d), kv_dtype)
    for a, b in zip(pools["cpu"], pools[cuda]):
        assert torch.equal(L.byte_view(b.cpu())[1:], L.byte_view(a)[1:])
    leaf = (torch.randn((2, 1, 1, 2, 32, 16), generator=gen) * 2).bfloat16()
    fq = {d: L.fake_quant_pages(leaf.clone().to(d), 4, 27, 8, kv_dtype)
          for d in ("cpu", cuda)}
    assert torch.equal(fq[cuda].cpu(), fq["cpu"])


FEATURES = [
    ("llama2-7b", dict(page_size=8, prefix_cache="on", kv_dtype="int8"), 8),
    ("llama2-7b", dict(page_size=8, prefix_cache="on", kv_dtype="fp8",
                       paged_attn="gather"), 8),
    ("llama2-7b", dict(page_size=8, kv_dtype="fp8"), None),
    ("gemma2-27b", dict(page_size=8, prefix_cache="on", kv_dtype="int8"), 8),
]


@pytest.mark.parametrize("case", range(len(FEATURES)))
def test_serve_engine_features_on_card_match_cpu(cuda, case):
    """Chunked prefill, prefix reuse, the gather discipline and int8 / fp8
    pools on the card: the CPU's tokens and cached tokens, and the in-place
    discipline launches the paged kernel (on the quantized pool: never the
    plain version) once per paged layer per decode step.  With block
    prefill (the flash kernel, one bf16 ulp from the plain version) into a
    quantized pool, the CPU decodes from the card's prefilled request
    caches."""
    from torch_cases import (feature_prompts, record_prefills,
                             replay_prefills, serve_staged)
    arch, kw, chunk = FEATURES[case]
    cfg = get_config(arch).reduced()
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    got, kept = {}, None
    for d in (cuda, "cpu"):
        eng = ServeEngine(cfg, params, max_len=64, device=d, **kw)
        if chunk is None and d == cuda:
            kept = record_prefills(eng)
        elif chunk is None:
            replay_prefills(eng, kept)
        reqs = [Request(uid=i, prompt=p, max_new=6)
                for i, p in enumerate(feature_prompts(cfg.vocab_size))]
        steps = []
        decode = eng.decode_slots
        eng.decode_slots = lambda *a, **k: steps.append(1) or decode(*a, **k)
        ops.reset_launch_counts()
        res = serve_staged([ContinuousBatchingScheduler(
            eng, max_slots=2, prefill_chunk=chunk)], [reqs])[0]
        got[str(d)] = ([r.tokens.tolist() for r in res],
                       [r.cached_tokens for r in res])
        if d == cuda:
            counts, n_steps = ops.launch_counts(), len(steps)
    assert got[str(cuda)] == got["cpu"]
    paged_layers = (cfg.num_layers if arch != "gemma2-27b"
                    else cfg.num_layers // 2)
    want = (0 if kw.get("paged_attn") == "gather"
            else paged_layers * n_steps)
    assert counts["paged_decode_attention"] == want
    if chunk:
        assert counts["flash_attention"] == 0


@pytest.mark.parametrize("quantize", [True, False], ids=["w4a8", "float"])
def test_splitbrain_features_on_card_match_cpu(cuda, quantize):
    """The split-brain engine with an int8 prefix-shared pool and chunked
    prefill, and on a dense slot cache: the CPU's tokens on the card."""
    from torch_cases import feature_prompts, serve_staged
    cfg = get_config("tinyllama-1.1b").reduced()
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for kw in (dict(page_size=8, prefix_cache="on", kv_dtype="int8"),
               dict()):
        got = {}
        for d in ("cpu", cuda):
            eng = SplitBrainEngine(cfg, params, max_len=64, quantize=quantize,
                                   device=d, **kw)
            reqs = [Request(uid=i, prompt=p, max_new=6)
                    for i, p in enumerate(feature_prompts(cfg.vocab_size))]
            res = serve_staged([ContinuousBatchingScheduler(
                eng, max_slots=2, prefill_chunk=8)], [reqs])[0]
            got[str(d)] = [r.tokens.tolist() for r in res]
        assert got[str(cuda)] == got["cpu"], kw


# ---------------------------------------------------------------- hymba
# hymba-1.5b's attention at full width: 25 query heads over 5 KV heads of
# 64 (group 5), the 1024-token sliding window; lengths that cross it
@pytest.mark.parametrize("T", [1000, 2048])
def test_flash_kernel_at_hymba_shape(cuda, T):
    q, k, v = _flash_inputs(2, 25, 5, T, T, 64, torch.bfloat16, cuda, seed=T)
    opts = dict(causal=True, window=1024)
    out = ops.attention(q, k, v, **opts)
    plain = ref.flash_attention(q, k, v, **opts)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert_within_bf16_ulp(out, plain.float().cpu().numpy(), atol=1e-5)


@pytest.mark.parametrize("window", [None, 1024])
def test_paged_kernel_at_hymba_shape(cuda, window):
    case = {k: v.to(cuda) for k, v in paged_case(
        41, dtype=torch.bfloat16, B=8, Hq=25, Hkv=5, D=64, ps=16, P=80,
        lens=(1, 33, 100, 512, 1023, 1024, 1025, 1270)).items()}
    opts = dict(window=window)
    out = run_paged(case, ops.paged_decode_attention, **opts)
    plain = run_paged(case, ref.paged_decode_attention, **opts)
    torch.cuda.synchronize()
    assert_within_bf16_ulp(out, plain.float().cpu().numpy(),
                           atol=_order_bound(case, **opts))


def test_xla_exp_on_card_matches_cpu(cuda):
    """``ref.exp`` (XLA's CPU exp: Cephes' reduction and polynomial as fused
    multiply-adds, exact power-of-two scaling, flush below 2^-126) gives
    the CPU's bits on the card, over the range the SSM scan uses and
    beyond."""
    g = torch.Generator().manual_seed(4)
    x = torch.cat([torch.rand(1 << 20, generator=g) * -100.0,
                   torch.randn(1 << 18, generator=g) * 10.0])
    assert torch.equal(ref.exp(x.to(cuda)).cpu(), ref.exp(x))


def test_hymba_engine_and_forward_on_card_match_cpu(cuda):
    """Reduced hymba-1.5b on the card and on the CPU from the same weights:
    under the scheduler on the ring layout (max_len 40, the 16-token ring
    wraps) and on the paged one (max_len 12, page 4: 2 paged launches per
    decode step, no flash launch), and generate().  The card's tokens, fed
    back teacher-forced through the decode steps on both devices, give
    float32 logits within two bf16 ulps of the largest, and a token the CPU
    would not choose is a near-tie (short of its largest by at most twice
    that).  forward's logits (one flash launch per layer) agree within one
    bf16 ulp of the largest."""
    cfg = get_config("hymba-1.5b").reduced()
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = np.stack([(np.arange(1, 21) * (3 + i)) % 256
                        for i in range(3)]).astype(np.int32)
    for kw, lens, max_len in ((dict(), (5, 9, 17, 24), 40),
                              (dict(page_size=4), (3, 5, 2, 7), 12)):
        reqs = [Request(uid=i, prompt=(np.arange(1, n + 1) * 7 % 256)
                        .astype(np.int32), max_new=4) for i, n in
                enumerate(lens)]
        engs = {dev: ServeEngine(cfg, params, max_len=max_len, device=dev,
                                 **kw) for dev in ("cpu", "cuda")}
        ops.reset_launch_counts()
        out = ContinuousBatchingScheduler(engs["cuda"], max_slots=2).run(reqs)
        counts = ops.launch_counts()
        assert counts["flash_attention"] == 0
        assert counts["paged_decode_attention"] == (
            cfg.num_layers * out["steps"] if kw else 0)
        seqs = [(q.prompt, r.tokens) for q, r in zip(reqs, out["results"])]
        if not kw:
            gen = engs["cuda"].generate(prompts, max_new=6)
            seqs += list(zip(prompts, gen["tokens"]))
        tf = {dev: torch.cat([teacher_forced_logits(engs[dev].params, cfg,
                                                    p, t, dev)
                              for p, t in seqs]) for dev in engs}
        rep = pick_report(tf["cpu"], tf["cuda"],
                          np.concatenate([t for _, t in seqs]))
        tol = 2 * bf16_ulp_of(rep["max_abs_logit"])
        assert rep["max_abs_err"] <= tol and rep["shortfall"] <= 2 * tol, rep
    toks = torch.from_numpy(prompts)
    ops.reset_launch_counts()
    fwd = {dev: api.forward(engs[dev].params, toks.to(dev), cfg)[0]
           .reshape(-1, cfg.vocab_size).cpu() for dev in engs}
    assert ops.launch_counts()["flash_attention"] == cfg.num_layers
    rep = pick_report(fwd["cpu"], fwd["cuda"], fwd["cuda"].argmax(-1))
    tol = bf16_ulp_of(rep["max_abs_logit"])
    assert rep["max_abs_err"] <= tol and rep["shortfall"] <= 2 * tol, rep


def test_online_server_on_card_serves_from_its_loop_thread(cuda):
    """The OnlineServer's loop thread runs under the engine's device: a
    reduced llama2-7b engine on the card serves streamed requests with the
    tokens of the scheduler run on the same engine."""
    from repro_torch.serve.server import OnlineServer
    cfg = get_config("llama2-7b").reduced()
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = ServeEngine(cfg, params, max_len=64, page_size=8, device=cuda)
    prompts = [(np.arange(1, n + 1) * 7 % 256).astype(np.int32)
               for n in (5, 9, 3)]
    base = ContinuousBatchingScheduler(eng, max_slots=2).run(
        [Request(uid=i, prompt=p, max_new=6) for i, p in enumerate(prompts)])
    with OnlineServer(ContinuousBatchingScheduler(eng, max_slots=2),
                      watchdog_s=30.0) as srv:
        handles = [srv.submit(p, max_new=6) for p in prompts]
        streamed = [list(h.stream()) for h in handles]
    assert streamed == [r.tokens.tolist() for r in base["results"]]


def _moe_layer0(seed=0):
    """Reduced top-8 override (16 experts, top-8, GQA 16/1): its config and
    layer 0's MoE weights in bf16 on the CPU."""
    from repro_torch.configs.base import MoEConfig
    cfg = get_config("qwen3-moe-235b-a22b").reduced(
        num_heads=16, num_kv_heads=1, moe=MoEConfig(16, 8))
    params = api.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    return cfg, {k: w[0, 0].to(torch.bfloat16)
                 for k, w in params["blocks"]["moe"].items()}


@pytest.mark.parametrize("n", [8, 64])
def test_moe_apply_on_card_matches_cpu_and_repeats(cuda, n):
    """``moe_apply`` on the card against the CPU on the same bf16 inputs
    (similar rows, so capacity drops): the experts chosen are the CPU's
    except where a row's k-th and (k+1)-th router probabilities are within
    1e-5, each row within 2^-7 of the CPU's in relative norm (the bf16
    GEMMs and the CPU's float32 products round the expert outputs in
    other places), and a second call on the card bit-identical (the
    combine gathers; no atomics)."""
    from repro_torch.models import moe
    cfg, p = _moe_layer0()
    mc = cfg.moe
    rng = np.random.default_rng(n)
    x = torch.from_numpy((rng.standard_normal((1, n, 64))
                          + 2 * rng.standard_normal(64)).astype(np.float32)
                         ).to(torch.bfloat16)
    want, _ = moe.moe_apply(p, x, mc)
    pc = {k: w.to(cuda) for k, w in p.items()}
    got, _ = moe.moe_apply(pc, x.to(cuda), mc)
    again, _ = moe.moe_apply(pc, x.to(cuda), mc)
    assert torch.equal(got, again)
    probs, _, ids = moe.route(p, x[0], mc)
    _, _, ids_c = moe.route(pc, x[0].to(cuda), mc)
    C = moe.capacity(n, mc)
    assert not moe.dispatch(ids, C, mc.num_experts)[2].all()   # drops
    top = torch.sort(probs, dim=-1, descending=True).values
    tie = (top[:, mc.top_k - 1] - top[:, mc.top_k]) <= 1e-5
    same = (torch.sort(ids, 1).values == torch.sort(ids_c.cpu(), 1).values
            ).all(1)
    assert bool((same | tie).all())
    rel = ((got.cpu().float() - want.float())[0].norm(dim=1)
           / want.float()[0].norm(dim=1).clamp_min(1e-30))
    assert float(rel.max()) <= 2.0 ** -7


def test_moe_quantized_experts_on_card_match_plain(cuda):
    """The W4A8 branch of the expert products: one kernel launch per
    expert on its packed codes, bit-identical to the plain version on the
    card and to the CPU path."""
    from repro_torch.core import quant
    from repro_torch.models import moe
    cfg, p = _moe_layer0(1)
    E = cfg.moe.num_experts
    qw = api.quantize_model({"w1": p["w1"]}, cfg)["w1"]
    qc = quant.QuantizedLinear(qw.codes.to(cuda), qw.scales.to(cuda)
                               ).with_packed()
    eb = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (E, 5, 64)).astype(np.float32)).to(torch.bfloat16)
    ops.reset_launch_counts()
    got = moe._expert_matmul(eb.to(cuda), qc)
    assert ops.launch_counts()["w4a8_matmul"] == E
    qx, xs = quant.quantize_activations_int8(eb.to(cuda).reshape(E * 5, 64),
                                             reciprocal=True)
    plain = torch.stack([ref.w4a8_matmul(
        qx.reshape(E, 5, 64)[e], xs.reshape(E, 5, 1)[e], qc.codes[e],
        qc.scales[e], torch.bfloat16) for e in range(E)])
    assert torch.equal(got, plain)
    assert torch.equal(got.cpu(), moe._expert_matmul(eb, qw))


def test_moe_engine_on_card_matches_cpu(cuda):
    """Reduced phi3.5-moe's ServeEngine on a paged pool with 4 slots (the
    MoE couples the decode rows): one flash launch per layer per prefill,
    one paged launch per layer per decode step, and the CPU's tokens."""
    cfg = get_config("phi3.5-moe-42b-a6.6b").reduced()
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    reqs = [Request(uid=i, prompt=(np.arange(1, n + 1) * 7 % 256)
                    .astype(np.int32), max_new=6)
            for i, n in enumerate((5, 9, 17, 24, 3, 12))]
    toks = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(cfg, params, max_len=64, page_size=8, device=dev)
        ops.reset_launch_counts()
        out = ContinuousBatchingScheduler(eng, max_slots=4).run(reqs)
        counts = ops.launch_counts()
        toks[dev] = [r.tokens.tolist() for r in out["results"]]
    L = cfg.num_layers
    assert counts["flash_attention"] == L * len(reqs)
    assert counts["paged_decode_attention"] == L * out["steps"]
    assert toks["cuda"] == toks["cpu"]


# ------------------------------------------------ cross-attention families
# seamless-m4t-medium's encoder (non-causal self-attention over 960 frames,
# 16/16 heads of 64) and llama-3.2-vision-11b's cross blocks (32/8 heads of
# 128 over 1,600 frontend tokens, 127 prompt rows in a prefill and one row
# in a decode step)
XATTN_FLASH = [(4, 16, 16, 960, 960, 64), (2, 32, 8, 127, 1600, 128),
               (4, 32, 8, 1, 1600, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", range(len(XATTN_FLASH)))
def test_flash_kernel_at_cross_attention_shapes(cuda, case, dtype):
    q, k, v = _flash_inputs(*XATTN_FLASH[case], dtype, cuda, seed=60 + case)
    n0 = kfa.flash_attention.launches
    out = ops.attention(q, k, v, causal=False)
    plain = ref.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert kfa.flash_attention.launches == n0 + 1
    assert out.dtype == dtype and out.shape == q.shape
    if dtype == torch.float32:
        torch.testing.assert_close(out, plain, rtol=0, atol=1e-5)
    else:
        assert_within_bf16_ulp(out, plain.float().cpu().numpy(), atol=1e-5)


def _xattn_model(arch):
    """A reduced cross-attention config's params with its cross gates set
    (0.7, -0.9: a zero gate hides the cross path) and seeded frontends."""
    cfg = get_config(arch).reduced()
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    if cfg.cross_attn_every:
        params["cross"]["gate"] = torch.tensor([0.7, -0.9])
    fe = (np.random.default_rng(7).standard_normal(
        (3, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
        if cfg.frontend_tokens else None)
    return cfg, params, fe


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b",
                                  "seamless-m4t-medium"])
def test_frontend_generate_on_card_matches_cpu(cuda, arch):
    """Reduced llama-3.2-vision-11b and seamless-m4t-medium: generate()
    fused and stepwise on the card (kernels) and on the CPU (plain
    versions) from the same weights and frontends give the same tokens.
    Launches per call: the VLM one flash per layer and per cross block in
    the prefill and one per cross block per decode step (at one query row),
    stepwise one per cross block per step; seamless one per encoder layer
    (its decode steps attend through the plain decode_attention)."""
    cfg, params, fe = _xattn_model(arch)
    prompts = np.stack([(np.arange(1, 10) * (3 + i)) % 256
                        for i in range(3)]).astype(np.int32)
    T0, new = prompts.shape[1], 6
    toks, counts = {}, {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(cfg, params, max_len=32, device=dev)
        for fused in (True, False):
            ops.reset_launch_counts()
            out = eng.generate(prompts, max_new=new, frontend=fe,
                               fused=fused)
            counts[fused] = ops.launch_counts()["flash_attention"]
            toks[dev, fused] = out["tokens"].tolist()
    if cfg.cross_attn_every:
        G = cfg.num_layers // cfg.cross_attn_every
        assert counts[True] == cfg.num_layers + G + G * new
        assert counts[False] == G * (T0 - 1 + new)
    else:
        assert counts[True] == counts[False] == cfg.num_encoder_layers
    assert toks["cuda", True] == toks["cpu", True] == toks["cpu", False]
    assert toks["cuda", False] == toks["cpu", False]


@pytest.mark.parametrize("arch", ["llama2-7b", "gemma2-27b",
                                  "phi3.5-moe-42b-a6.6b",
                                  "llama-3.2-vision-11b",
                                  "seamless-m4t-medium"])
def test_forward_on_card_matches_cpu_and_counts_launches(cuda, arch):
    """``api.forward`` on 3 x 24 tokens on the card and on the CPU from the
    same engine weights: one flash launch per layer (and per VLM cross
    block; seamless: encoder, causal self and cross per layer), logits
    within two bf16 ulps of the largest and a differing pick a near-tie."""
    cfg, params, fe = _xattn_model(arch)
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        1, 256, (3, 24)).astype(np.int32))
    fwd = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(cfg, params, max_len=32, device=dev)
        ops.reset_launch_counts()
        f = torch.from_numpy(fe).to(dev) if cfg.frontend_tokens else None
        fwd[dev] = api.forward(eng.params, toks.to(dev), cfg, frontend=f)[0] \
            .reshape(-1, cfg.vocab_size).cpu()
    want = cfg.num_layers
    if cfg.cross_attn_every:
        want += cfg.num_layers // cfg.cross_attn_every
    if cfg.family == "encdec":
        want = cfg.num_encoder_layers + 2 * cfg.num_layers
    assert ops.launch_counts()["flash_attention"] == want
    rep = pick_report(fwd["cpu"], fwd["cuda"], fwd["cuda"].argmax(-1))
    tol = 2 * bf16_ulp_of(rep["max_abs_logit"])
    assert rep["max_abs_err"] <= tol and rep["shortfall"] <= 2 * tol, rep


def test_tp_paged_head_cut_and_merge_on_card(cuda):
    """The paged kernel's tensor-parallel dispatch on two gloo ranks that
    share the card: the head cut (each rank's 16 query and 4 KV heads, the
    unsharded split plan) bit for bit the unsharded kernel's heads, and the
    page-split LSE merge within one bf16 ulp of the plain version plus the
    order bound."""
    from repro_torch.distributed import runtime
    from torch_tp_cases import paged_card_rank
    ranks = runtime.spawn(paged_card_rank, (1, 2), (), backend="gloo",
                          devices=["cuda:0"] * 2, timeout=300)
    for r in ranks:
        assert r["head_cut"], r
        assert r["merge"], r


# the sequence-cut dense decode's log-sum-exp body (parallel.decode_attn=
# "shard_map"; plain PyTorch, no kernel) at llama2-7b's shape (32 heads of
# 128, one per KV head) and gemma2-27b's global layers (32/16 heads of 128,
# softcap 50), over a rank's 512 positions at tp 2 of a 1,024-token cache
LSE_SHAPES = [dict(Hq=32, Hkv=32, D=128, softcap=None),
              dict(Hq=32, Hkv=16, D=128, softcap=50.0)]
LSE_BOUND = 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", range(len(LSE_SHAPES)))
def test_lse_decode_body_on_card_matches_cpu(cuda, case, dtype):
    """The body on the card (cuBLAS's dots, the softcap's division as the
    multiplication by the cap's reciprocal that XLA compiles, which is the
    same op on both devices) against the CPU's (PyTorch's CPU dots), on
    the same inputs, B 8 with lengths 0 to 512.  The logits' sum orders
    differ, and where an f32 ulp of a weight p flips its rounding to bf16
    (the body rounds p before the PV product) the output moves: the
    largest difference read on the H100 was 5.2e-5 for f32 queries at
    both shapes (the cases' first run, against a bound of 1e-5).  f32
    queries are held to LSE_BOUND, about twice that, bf16 ones to one bf16
    ulp of the CPU's output plus it.  Dropping p's rounding would move the
    output by more than 10 x LSE_BOUND on these inputs (float64, asserted
    first), so the bound sees the numerics that the body keeps."""
    from repro_torch.distributed import collectives
    g = LSE_SHAPES[case]
    gen = torch.Generator().manual_seed(90 + case)
    B, S = 8, 512
    q = torch.randn((B, g["Hq"], 1, g["D"]), generator=gen).to(dtype)
    k, v = (torch.randn((B, g["Hkv"], S, g["D"]), generator=gen)
            .to(torch.bfloat16) for _ in range(2))
    lens = torch.tensor([0, 1, 37, 128, 255, 256, 400, 512])
    valid = torch.arange(S)[None, :] < lens[:, None]
    # what keeping p in f32 for the PV product would change, in float64
    Hkv, G = g["Hkv"], g["Hq"] // g["Hkv"]
    logits = torch.einsum("bhgd,bhkd->bhgk",
                          q.double().reshape(B, Hkv, G, g["D"]),
                          k.double()) * g["D"] ** -0.5
    if g["softcap"]:
        logits = g["softcap"] * torch.tanh(logits / g["softcap"])
    logits = logits.masked_fill(~valid[:, None, None, :], -1e30)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    kept = torch.einsum("bhgk,bhkd->bhgd", p - p.to(torch.bfloat16).double(),
                        v.double()) / p.sum(-1, keepdim=True)
    assert float(kept.abs().max()) > 10 * LSE_BOUND
    cpu = collectives.distributed_decode_attention(q, k, v, valid,
                                                   softcap=g["softcap"])
    card = collectives.distributed_decode_attention(
        q.to(cuda), k.to(cuda), v.to(cuda), valid.to(cuda),
        softcap=g["softcap"])
    assert card.dtype == dtype and card.shape == cpu.shape
    diff = (card.cpu().double() - cpu.double()).abs().numpy()
    ulp = 0.0
    if dtype == torch.bfloat16:
        ulp = np.exp2(np.floor(np.log2(np.maximum(
            np.abs(cpu.double().numpy()), 2.0 ** -126))) - 7)
    print(f"{case} {dtype}: largest difference {diff.max():.3e}")
    assert (diff <= ulp + LSE_BOUND).all(), float(diff.max())


# the kernels at tensor-parallel ranks' shapes: qwen3-moe's head-cut pool
# (32/2 heads of 64 on a 32-page table) and flash at qwen3-moe's bucketed
# prefill (32/2 x 64), the VLM's prefill and cross blocks (16/4 x 128, a
# 63-row body, 1,600 frontend tokens) and seamless's encoder (8/8 x 64)
TP_RANK_CASES = [
    ("paged", dict(B=8, Hq=32, Hkv=2, D=64, ps=16, P=32,
                   lens=(0, 1, 31, 64, 100, 180, 257, 271)), {}),
    ("flash", (1, 32, 2, 256, 256, 64), dict(causal=True)),
    ("flash", (2, 16, 4, 63, 63, 128), dict(causal=True)),
    ("flash", (2, 16, 4, 63, 1600, 128), dict(causal=False)),
    ("flash", (2, 16, 4, 1, 1600, 128), dict(causal=False)),
    ("flash", (4, 8, 8, 960, 960, 64), dict(causal=False))]


@pytest.mark.parametrize("case", range(len(TP_RANK_CASES)))
def test_kernels_at_tp_rank_shapes(cuda, case):
    """bf16, one launch each: paged within one bf16 ulp of the plain value
    plus the order bound of two sum orders, flash within one bf16 ulp plus
    1e-5."""
    kind, geom, opts = TP_RANK_CASES[case]
    if kind == "paged":
        c = {k: v.to(cuda) if torch.is_tensor(v) else v
             for k, v in paged_case(70, dtype=torch.bfloat16,
                                    **geom).items()}
        n0 = kpa.paged_decode_attention.launches
        out = ops.paged_decode_attention(c["q"], c["k"], c["v"], c["table"],
                                         c["lens"])
        plain = ref.paged_decode_attention(c["q"], c["k"], c["v"],
                                           c["table"], c["lens"]).float()
        bound = ref.paged_decode_order_bound(c["q"], c["k"], c["v"],
                                             c["table"], c["lens"])
        torch.cuda.synchronize()
        assert kpa.paged_decode_attention.launches == n0 + 1
        ulp = torch.exp2(torch.floor(torch.log2(
            torch.clamp_min(plain.abs(), 2.0 ** -126))) - 7)
        assert bool(((out.float() - plain).abs() <= ulp + bound).all())
        return
    q, k, v = _flash_inputs(*geom, torch.bfloat16, cuda, seed=80 + case)
    n0 = kfa.flash_attention.launches
    out = ops.attention(q, k, v, **opts)
    plain = ref.flash_attention(q, k, v, **opts)
    torch.cuda.synchronize()
    assert kfa.flash_attention.launches == n0 + 1
    assert_within_bf16_ulp(out, plain.float().cpu().numpy(), atol=1e-5)


def test_vlm_generate_on_two_ranks_on_card(cuda, monkeypatch):
    """llama-3.2-vision-11b at full width and 5 layers (one gated cross
    block) on two gloo ranks sharing the card: fused ``generate()`` on 2 x
    32 with 4 new gives both ranks the same tokens and the flash launches
    of one device on the rank's heads (a prefill's 5 causal and 1 cross,
    one cross per decode step), and the tp 1 engine's tokens, or at a
    row's first differing pick a near-tie in its logits (within 4 bf16
    ulps of the largest: the ranks' half-width GEMMs may round apart)."""
    from repro_torch.distributed import runtime
    from repro_torch.serve import engine as engine_mod
    from torch_tp_cases import vlm_card_case, vlm_card_rank
    layers, B, T0, new = 5, 2, 32, 4
    ranks = runtime.spawn(vlm_card_rank, (1, 2), (layers, B, T0, new),
                          backend="gloo", devices=["cuda:0"] * 2,
                          timeout=600)
    (toks, counts), (toks1, _) = ranks
    assert np.array_equal(toks, toks1)
    assert counts == {"w4a8_matmul": 0, "paged_decode_attention": 0,
                      "flash_attention": layers + 1 + new, "rwkv6_scan": 0}
    cfg, params, prompts, fe = vlm_card_case(layers, B, T0, cuda)
    eng = ServeEngine(cfg, params, max_len=T0 + new, device=cuda)
    del params
    kept, step = [], engine_mod.api.decode_step

    def spy(*a, **kw):
        logits, cache = step(*a, **kw)
        kept.append(logits.float().cpu())
        return logits, cache
    monkeypatch.setattr(engine_mod.api, "decode_step", spy)
    want = eng.generate(prompts, max_new=new, frontend=fe)["tokens"]
    for row in np.flatnonzero((want != toks).any(axis=1)):
        j = int(np.flatnonzero(want[row] != toks[row])[0])
        logits = kept[j][row]
        gap = abs(logits[int(want[row, j])] - logits[int(toks[row, j])])
        assert gap <= 4 * bf16_ulp_of(logits.abs().max().item()), (row, j)


# ----------------------------------------------------------------------------
# training: the kernels refuse gradients, their Functions give the plain
# versions' (the same plain computation runs on the same saved inputs, so
# the gradients are expected bit for bit)
# ----------------------------------------------------------------------------
def _grad_case(cuda):
    q, k, v = (torch.from_numpy(np.random.default_rng(i).standard_normal(
        (2, h, 40, 64)).astype(np.float32)).to(cuda, torch.bfloat16)
        for i, h in enumerate((8, 4, 4)))
    r, kk, vv, w, u = (torch.from_numpy(a).to(cuda)
                       for a in rwkv_case(1, 4, 40, 64))
    qx, xs, codes, ws = (torch.from_numpy(a).to(cuda)
                         for a in w4a8_case(2, 64, 32))
    pc = {n: t.to(cuda) for n, t in paged_case(0, D=64).items()}
    return {
        "flash_attention": lambda g: kfa.flash_attention(
            q.requires_grad_(g), k, v),
        "rwkv6_scan": lambda g: krw.rwkv6_scan(r, kk, vv, w,
                                               u.requires_grad_(g)),
        "w4a8_matmul": lambda g: kw.w4a8_matmul(
            qx, xs.requires_grad_(g), codes, ws,
            packed=kw.pack_codes(codes)),
        "paged_decode_attention": lambda g: kpa.paged_decode_attention(
            pc["q"].requires_grad_(g), pc["k"], pc["v"], pc["table"],
            pc["lens"])}


@pytest.mark.parametrize("name", sorted(ops.KERNELS))
def test_kernel_wrappers_refuse_grad_on_card(cuda, name):
    call = _grad_case(cuda)[name]
    with pytest.raises(RuntimeError, match="requires grad"):
        call(True)
    with torch.no_grad():
        call(True)                                # launches: no grad wanted
    call(False)


@pytest.mark.parametrize("opts", [dict(), dict(window=16, softcap=30.0),
                                  dict(causal=False)])
def test_ops_attention_gradients_are_the_plain_versions_on_card(cuda, opts):
    rng = np.random.default_rng(3)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(
        (2, h, 40, 64)).astype(np.float32)).to(cuda, torch.bfloat16)
        for h in (8, 4, 4, 8))
    ops.reset_launch_counts()
    out_k, g_k = autograd_grads(lambda *x: ops.attention(*x, **opts),
                                (q, k, v), (dout,))
    assert ops.launch_counts()["flash_attention"] == 1
    assert "FlashAttentionFn" in type(out_k[0].grad_fn).__name__
    out_r, g_r = autograd_grads(lambda *x: ref.flash_attention(*x, **opts),
                           (q, k, v), (dout,))
    assert torch.equal(out_k[0], kfa.flash_attention(q, k, v, **opts))
    assert_within_bf16_ulp(out_k[0], out_r[0].detach().float().cpu(),
                           atol=1e-5)
    for a, b in zip(g_k, g_r):
        assert torch.equal(a, b)


def test_ops_rwkv6_gradients_are_the_plain_versions_on_card(cuda):
    r, k, v, w, u = (torch.from_numpy(a).to(cuda)
                     for a in rwkv_case(1, 4, 40, 64))
    g = torch.Generator(device=cuda).manual_seed(0)
    dout = torch.randn(r.shape, generator=g, device=cuda)
    dstate = torch.randn((1, 4, 64, 64), generator=g, device=cuda)
    for douts in ((dout, dstate), (dout, None)):
        ops.reset_launch_counts()
        out_k, g_k = autograd_grads(ops.rwkv6, (r, k, v, w, u), douts)
        assert ops.launch_counts()["rwkv6_scan"] == 1
        out_r, g_r = autograd_grads(ref.rwkv6_scan, (r, k, v, w, u), douts)
        assert torch.equal(out_k[1], out_r[1])        # the state
        for a, b in zip(g_k, g_r):
            assert torch.equal(a, b)


# ----------------------------------------------------------------------------
# distributed training: a (2, 2) grid of gloo ranks sharing the card
# ----------------------------------------------------------------------------
def test_grid_train_step_on_card(cuda):
    """One train step of granite-8b reduced (bf16 compute, 2 layers, each
    rank's flash launch on its 2/1 heads of 16, its config's remat "full")
    on a (2, 2) grid of ranks sharing the card: every rank's metrics the
    same, two flash launches per layer per rank (the forward, and its
    recomputation in the backward, which re-runs the layer's FSDP gathers
    and Megatron collectives in the same order on every rank) and no other
    kernel, the loss within a relative 1e-3 and the grad norm within 1e-2
    of the one-device step's on the card (the row cuts and the data split
    sum in other orders)."""
    from repro_torch.distributed import runtime
    from repro_torch.train import optimizer as topt
    from repro_torch.train import step as tstep
    from torch_dist_cases import OPT, card_step_rank, numpy_batch, port_cfg
    cfg = port_cfg()
    batch = numpy_batch(cfg.vocab_size, B=4, T=32)
    ranks = runtime.spawn(card_step_rank, (2, 2), (batch,), backend="gloo",
                          devices=["cuda:0"] * 4, timeout=300)
    assert cfg.parallel.remat == "full"
    want = {"w4a8_matmul": 0, "paged_decode_attention": 0, "rwkv6_scan": 0,
            "flash_attention": 2 * cfg.num_layers}
    for r in ranks:
        assert r["launches"] == want, r
        assert r["metrics"] == ranks[0]["metrics"]
    ocfg = topt.AdamWConfig(**OPT)
    params = api.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                             device=cuda)
    _, _, m = tstep.make_train_step(cfg, ocfg)(
        params, topt.init_state(params, ocfg), batch)
    got = ranks[0]["metrics"]
    np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=1e-3)
    np.testing.assert_allclose(got["grad_norm"], float(m["grad_norm"]),
                               rtol=1e-2)


# ----------------------------------------------------------------------------
# tensor-parallel training: every family's rank shapes and a (1, 2) grid
# ----------------------------------------------------------------------------
# a (1, 2) rank's attention in chip_smoke.py's tp_train_path, (B, Hq, Hkv,
# Tq, Tk, D) and options: phi3.5-moe's and the VLM's 16/4 heads of 128 (and
# the VLM's cross block over 1,600 frontend tokens), seamless's 8/8 heads
# of 64 (encoder, decoder, cross over 960 frames), hymba-1.5b's 25/5 heads
# of 64 whole on every rank with its window of 1,024 at T 2,048
TP_TRAIN_FLASH_SHAPES = [
    ((4, 16, 4, 256, 256, 128), dict(causal=True)),
    ((4, 16, 4, 256, 1600, 128), dict(causal=False)),
    ((4, 8, 8, 960, 960, 64), dict(causal=False)),
    ((4, 8, 8, 256, 256, 64), dict(causal=True)),
    ((4, 8, 8, 256, 960, 64), dict(causal=False)),
    ((2, 25, 5, 2048, 2048, 64), dict(causal=True, window=1024)),
]


@pytest.mark.parametrize("shape, opts", TP_TRAIN_FLASH_SHAPES)
def test_flash_function_at_tp_train_rank_shapes(cuda, shape, opts):
    """``FlashAttentionFn`` at a tp-train rank's shape: one launch, the
    forward within the flash bound of the plain version, the gradients the
    plain version's autograd bit for bit."""
    B, Hq, Hkv, Tq, Tk, D = shape
    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
               for s in ((B, Hq, Tq, D), (B, Hkv, Tk, D), (B, Hkv, Tk, D)))
    dout = torch.randn(q.shape, generator=g, device=cuda).to(torch.bfloat16)
    ops.reset_launch_counts()
    out_k, g_k = autograd_grads(lambda *x: ops.attention(*x, **opts),
                                (q, k, v), (dout,))
    assert ops.launch_counts()["flash_attention"] == 1
    assert "FlashAttentionFn" in type(out_k[0].grad_fn).__name__
    out_r, g_r = autograd_grads(lambda *x: ref.flash_attention(*x, **opts),
                                (q, k, v), (dout,))
    assert_within_bf16_ulp(out_k[0], out_r[0].detach().float().cpu(),
                           atol=1e-5)
    for a, b in zip(g_k, g_r):
        assert torch.equal(a, b)


def test_rwkv6_function_at_the_tp_train_rank_shape(cuda):
    """``RWKV6ScanFn`` at rwkv6-7b's rank in tp_train_path (B 4, 32 of its 64
    heads, T 256, bf16, the model's decays): one launch, the state and the
    gradients the plain version's bit for bit, the output within the scan's
    bf16 bound."""
    g = torch.Generator(device=cuda).manual_seed(8)
    shape = (4, 32, 256, 64)
    r, k, v = (torch.randn(shape, generator=g, device=cuda) for _ in range(3))
    w = torch.exp(-torch.exp(torch.empty(shape, device=cuda).uniform_(
        -8.0, -5.0, generator=g)))
    r, k, v, w = (t.to(torch.bfloat16) for t in (r, k, v, w))
    u = torch.randn((32, 64), generator=g, device=cuda) * 0.3
    douts = (torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16),
             torch.randn((4, 32, 64, 64), generator=g, device=cuda))
    ops.reset_launch_counts()
    out_k, g_k = autograd_grads(ops.rwkv6, (r, k, v, w, u), douts)
    assert ops.launch_counts()["rwkv6_scan"] == 1
    out_r, g_r = autograd_grads(ref.rwkv6_scan, (r, k, v, w, u), douts)
    assert torch.equal(out_k[1], out_r[1])
    assert_within_bf16_ulp(out_k[0], out_r[0].detach().float().cpu().numpy(),
                           atol=ref.rwkv6_scan_order_bound(
                               r, k, v, w, u).cpu().numpy())
    for a, b in zip(g_k, g_r):
        assert torch.equal(a, b)


def test_tp_train_step_of_every_family_on_card(cuda):
    """One train step of every family at tp 2 (the reduced configs of
    ``torch_dist_cases.TP_FAMILIES``, bf16 compute, remat "none") on a (1,
    2) grid of ranks sharing the card: every rank's metrics the same, the
    flash and scan launches a rank as the family's forward makes them (one
    flash per attention call, one scan per rwkv layer; none in the
    backward), the loss within a relative 1e-3 and the grad norm within
    1e-2 of the one-device step's on the card (the row cuts sum in other
    orders)."""
    from repro_torch.distributed import runtime
    from repro_torch.train import optimizer as topt
    from repro_torch.train import step as tstep
    from torch_dist_cases import (OPT, TP_FAMILIES, card_family_step_rank,
                                  numpy_batch, port_cfg)
    names = ("rwkv6", "hymba", "seamless", "phi_moe", "vlm")
    cases = {}
    for name in names:
        arch, over = TP_FAMILIES[name]
        cfg = port_cfg(arch, **over)
        fe = ((cfg.frontend_tokens, cfg.d_model) if cfg.frontend_tokens
              else None)
        cases[name] = (arch, over, numpy_batch(cfg.vocab_size, B=4, T=32,
                                               frontend=fe))
    ranks = runtime.spawn(card_family_step_rank, (1, 2), (cases,),
                          backend="gloo", devices=["cuda:0"] * 2,
                          timeout=300)
    flash = {"rwkv6": 0, "hymba": 2, "seamless": 6, "phi_moe": 2, "vlm": 6}
    for name in names:
        arch, over, batch = cases[name]
        cfg = port_cfg(arch, **over)
        want = {"w4a8_matmul": 0, "paged_decode_attention": 0,
                "flash_attention": flash[name],
                "rwkv6_scan": cfg.num_layers if cfg.family == "rwkv" else 0}
        for r in ranks:
            assert r[name]["launches"] == want, (name, r[name])
            assert r[name]["metrics"] == ranks[0][name]["metrics"]
        cfg = port_cfg(arch, parallel=dataclasses.replace(
            cfg.parallel, remat="none"), **over)
        ocfg = topt.AdamWConfig(**OPT)
        params = api.init_params(
            cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
        _, _, m = tstep.make_train_step(cfg, ocfg)(
            params, topt.init_state(params, ocfg), batch)
        got = ranks[0][name]["metrics"]
        np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=1e-3)
        np.testing.assert_allclose(got["grad_norm"], float(m["grad_norm"]),
                                   rtol=1e-2)


# ---------------------------------------------------------------- dry run
def test_dryrun_prefill_trace_matches_the_card(cuda):
    """The dry run's calibration (b) at a reduced width: stablelm-1.6b's
    prefill (``api.forward`` under the (1, 1) training layout) traced on
    meta, then built from seeded weights on the card and run: each
    kernel's launches equal the trace's ``kernel_calls`` and the rank's
    argument bytes (params and inputs) equal the trace's, exactly."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch import op_analysis as oa
    shape = ShapeConfig("cal_b", 256, 1, "prefill")
    cfg = dryrun.adapt_parallel(
        get_config("stablelm-1.6b").reduced(num_layers=3, d_model=256,
                                            num_heads=4, head_dim=64),
        shape, dryrun.grid_shape((1, 1)))
    rec = dryrun.trace(cfg, shape, (1, 1))
    assert rec["kernel_calls"] == {"flash_attention": 3}
    step = dryrun.build_step(cfg, shape, oa.stand_in_grid((1, 1), cuda),
                             cuda, torch.Generator(cuda).manual_seed(0))
    ops.reset_launch_counts()
    logits = step.run()
    torch.cuda.synchronize()
    want = {k: int(rec["kernel_calls"].get(k, 0)) for k in ops.KERNELS}
    assert ops.launch_counts() == want
    assert step.argument_bytes == rec["memory"]["argument_size_in_bytes"]
    assert tuple(logits.shape) == (1, 256, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())


def test_soft_cap_on_card_bit_identical_to_cpu(cuda):
    """``ref._soft_cap`` at gemma2-27b's softcap (50) over float32 logits
    spread across their whole range (every 256th bit pattern, the
    non-finite ones dropped): the card's bits equal the CPU's, which the
    CPU parity tests hold against the JAX package (a division by a 0-d
    tensor; a division by the Python number is a product by its
    reciprocal on the card)."""
    cap = get_config("gemma2-27b").softcap
    bits = torch.arange(2 ** 24, dtype=torch.int64) * 256 - 2 ** 31
    x = bits.to(torch.int32).view(torch.float32)
    x = x[torch.isfinite(x)]
    got = ref._soft_cap(x.to(cuda), cap).cpu()
    assert torch.equal(got.view(torch.int32),
                       ref._soft_cap(x, cap).view(torch.int32))
