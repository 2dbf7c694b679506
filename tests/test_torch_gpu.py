"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device: the fixture decides at run time and
skips without one.  Run them on the H100 with
``python -m pytest -m gpu tests/test_torch_*.py``.  This file imports
neither JAX nor the JAX package.

Tolerances: W4A8 is bit-identical (exact int32 sums, the same two f32
multiplies, one round-to-nearest-even to bf16).  Paged and flash attention
in f32 are held to atol 1e-5 (the same f32 math in another summation
order), in bf16 to one bf16 ulp (that order can flip the final rounding);
flash attention's bf16 bound adds the f32 one, since an output near zero
after cancellation has a bf16 ulp below the f32 sum-order error.  The RWKV6
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


FLASH = [  # (B, Hq, Hkv, Tq, Tk, D, options)
    (2, 4, 2, 37, 37, 16, dict(causal=True)),
    (1, 4, 4, 130, 130, 64, dict(causal=True, window=20, softcap=30.0)),
    (1, 8, 2, 5, 77, 128, dict(causal=True, kv_offset=72)),
    (2, 4, 2, 9, 70, 128, dict(causal=False, kv_offset=3, scale=0.2)),
    (1, 2, 1, 1, 1, 256, dict(causal=True)),
    (1, 4, 2, 65, 65, 48, dict(causal=True)),
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
