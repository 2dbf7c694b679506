"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device: the fixture decides at run time and
skips without one.  Run them on the H100 with
``python -m pytest -m gpu tests/test_torch_*.py``.  This file imports
neither JAX nor the JAX package.

Tolerances: W4A8 is bit-identical (exact int32 sums, the same two f32
multiplies, one round-to-nearest-even to bf16).  Paged and flash attention
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
in the same order); its f32 output is held to atol 1e-4 (the JAX kernel
test's), its bf16 output to one bf16 ulp plus the f32 bound of two orders
of its D-term sum over the k-dim (``ref.rwkv6_scan_order_bound``).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.device import exact_matmuls
from repro_torch.kernels import ops, ref
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import paged_attention as kpa
from repro_torch.kernels import rwkv_scan as krw
from repro_torch.kernels import w4a8_matmul as kw
from repro_torch.models import api
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import ContinuousBatchingScheduler, Request
from repro_torch.serve.splitbrain_engine import SplitBrainEngine
from torch_cases import (assert_within_bf16_ulp, bf16_ulp_of, paged_case,
                         pick_report, run_paged, rwkv_case,
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


@pytest.mark.parametrize("M,K,N", [(1, 2048, 2048), (8, 2048, 256), (3, 100, 37),
                                   (13, 5632, 130), (8, 64, 32000)])
def test_w4a8_kernel_bit_identical_to_plain(cuda, M, K, N):
    ts = [torch.from_numpy(a).to(cuda) for a in w4a8_case(M, K, N, seed=M)]
    n0 = kw.w4a8_matmul.launches
    out = ops.w4a8_matmul(*ts)
    torch.cuda.synchronize()
    assert kw.w4a8_matmul.launches == n0 + 1
    torch.testing.assert_close(out, ref.w4a8_matmul(*ts), rtol=0, atol=0)


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


@pytest.mark.parametrize("arch", ["llama2-7b", "tinyllama-1.1b"])
def test_serve_engine_on_card_matches_cpu_and_counts_launches(cuda, arch):
    """Reduced ServeEngine on the card (flash prefill, paged decode) and on
    the CPU (plain versions) from the same weights: the same tokens under
    the scheduler and generate(), one flash launch per layer per prefill
    and one paged launch per layer per decode step."""
    cfg = get_config(arch).reduced()
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    reqs = [Request(uid=i, prompt=(np.arange(1, 6 + 4 * i) * 7 % 256)
                    .astype(np.int32), max_new=6) for i in range(4)]
    prompts = np.stack([(np.arange(1, 10) * (3 + i)) % 256
                        for i in range(3)]).astype(np.int32)
    runs = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(cfg, params, max_len=64, page_size=8, device=dev)
        ops.reset_launch_counts()
        out = ContinuousBatchingScheduler(eng, max_slots=2).run(reqs)
        counts = ops.launch_counts()
        gen = eng.generate(prompts, max_new=6)
        gen_counts = ops.launch_counts()
        runs[dev] = ([r.tokens.tolist() for r in out["results"]],
                     gen["tokens"].tolist())
    L = cfg.num_layers
    assert counts == {"w4a8_matmul": 0, "flash_attention": L * len(reqs),
                      "paged_decode_attention": L * out["steps"],
                      "rwkv6_scan": 0}
    assert gen_counts["flash_attention"] == counts["flash_attention"] + L
    assert gen_counts["paged_decode_attention"] == counts[
        "paged_decode_attention"]
    assert runs["cuda"] == runs["cpu"]


RWKV = [  # (B, H, T, D): the JAX kernel tests' shapes, ragged T, H > 1
    (2, 3, 64, 16), (1, 2, 128, 32), (1, 1, 32, 64), (2, 4, 37, 64),
    (3, 5, 1, 32)]


@pytest.mark.parametrize("case", range(len(RWKV)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_rwkv_kernel_matches_plain(cuda, case, dtype):
    r, k, v, w, u = (torch.from_numpy(a).to(cuda)
                     for a in rwkv_case(*RWKV[case], seed=case))
    r, k, v, w = (t.to(dtype) for t in (r, k, v, w))
    n0 = krw.rwkv6_scan.launches
    out, state = ops.rwkv6(r, k, v, w, u)
    torch.cuda.synchronize()
    assert krw.rwkv6_scan.launches == n0 + 1
    p_out, p_state = ref.rwkv6_scan(r, k, v, w, u)
    assert out.dtype == dtype and state.dtype == torch.float32
    torch.testing.assert_close(state, p_state, rtol=0, atol=1e-4)
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
