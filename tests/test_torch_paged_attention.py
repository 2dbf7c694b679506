"""repro_torch paged flash-decode attention against the JAX package.

The plain version (``repro_torch.kernels.ref.paged_decode_attention``) is
held to the Pallas kernel in interpret mode:
  * f32 inputs: atol 1e-5 — both take the logits, the online softmax and the
    value sum in f32, in different summation orders (~1e-7 relative each);
  * bf16 inputs: within one bf16 ulp of the reference's value — the same f32
    math, then one rounding to bf16 that a last-bit f32 difference can flip.
Page sizes {1, 3, 8}, GQA, window, softcap, an empty slot (cache_len 0) and
int8 / fp8 pools with per-(page, KV head) scales are covered, and so is the
log-sum-exp of ``return_lse=True``: atol 1e-5 for a live slot (the same f32
max and sum), at most -1e29 for an empty one (the Pallas kernel's
-1e30 + log(1e-30)).  The CUDA kernel splits a slot's pages into chunks
(``split_plan``) and merges them by log-sum-exp; the plain version run on
column ranges of a table and merged so equals the whole.  The CUDA kernel is
held to the plain version on the card in ``test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")   # the parity half needs the JAX package

from repro.kernels import paged_attention as jpa
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as kpa
from repro_torch.kernels import ref as tref
from torch_cases import (assert_within_bf16_ulp, merge_by_lse, paged_case,
                         run_paged)


def _jax(t):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    if t.dtype == torch.float8_e4m3fn:
        return jnp.asarray(t.view(torch.uint8).numpy().view(jnp.float8_e4m3fn))
    return jnp.asarray(t.numpy())


def _run_ours(case, fn=tops.paged_decode_attention, **kw):
    return run_paged(case, fn, **kw)


def _run_pallas(case, **kw):
    sc = {}
    if "k_scale" in case:
        sc = dict(k_scale=_jax(case["k_scale"]), v_scale=_jax(case["v_scale"]))
    return jpa.paged_decode_attention(
        _jax(case["q"]), _jax(case["k"]), _jax(case["v"]), _jax(case["table"]),
        _jax(case["lens"]), interpret=True, **sc, **kw)


CASES = [
    dict(ps=8),                                       # GQA group 2
    dict(ps=3, P=10),                                 # odd page size
    dict(ps=1, P=32, lens=(0, 1, 31)),                # one token per page
    dict(ps=8, Hq=4, Hkv=4),                          # MHA
    dict(ps=8, Hq=8, Hkv=1),                          # MQA
]
WINDOW_CAP = dict(window=3, softcap=2.0)


@pytest.mark.parametrize("geom,opts", [
    (CASES[0], {}), (CASES[1], dict(window=6)), (CASES[2], dict(softcap=5.0)),
    (CASES[3], WINDOW_CAP), (CASES[4], {}), (CASES[0], WINDOW_CAP),
    (CASES[2], dict(window=6))])
def test_plain_matches_pallas_f32(geom, opts):
    case = paged_case(0, **geom)
    ours = _run_ours(case, **opts)
    ref = np.asarray(_run_pallas(case, **opts))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5)
    # the empty slot returns exact zeros
    assert not ours[0].any()


@pytest.mark.parametrize("geom", CASES[:3])
def test_plain_matches_pallas_bf16(geom):
    case = paged_case(1, dtype=torch.bfloat16, **geom)
    ours = _run_ours(case, window=9, softcap=20.0)
    assert ours.dtype == torch.bfloat16
    ref = _run_pallas(case, window=9, softcap=20.0)
    assert_within_bf16_ulp(ours, np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("kv", ["int8", "fp8"])
@pytest.mark.parametrize("geom", [dict(ps=8), dict(ps=3, P=10), dict(ps=1, P=32,
                                                                     lens=(0, 1, 31))])
def test_plain_matches_pallas_quantized_pools(kv, geom):
    case = paged_case(2, kv=kv, **geom)
    ours = _run_ours(case, softcap=30.0)
    ref = np.asarray(_run_pallas(case, softcap=30.0))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5)
    # the scales are applied: without them the answer moves far away
    raw = _run_ours(dict(case, k_scale=None, v_scale=None), softcap=30.0)
    assert np.abs(raw.numpy() - ref).max() > 1e-2


def test_dense_decode_attention_matches_oracle():
    """The dense single-position attention prefill uses (no kernel on either
    side) against the JAX oracle, with GQA, window and softcap, f32."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((3, 4, 1, 16)).astype(np.float32)
    k = rng.standard_normal((3, 2, 24, 16)).astype(np.float32)
    v = rng.standard_normal((3, 2, 24, 16)).astype(np.float32)
    lens = np.array([1, 7, 24], np.int32)
    for kw in (dict(), dict(window=5, softcap=3.0)):
        ref = jref.decode_attention(*map(jnp.asarray, (q, k, v, lens)), **kw)
        ours = tref.decode_attention(*map(torch.from_numpy, (q, k, v, lens)), **kw)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-5)


LSE_CASES = [(None, CASES[0], {}), (None, CASES[1], dict(window=6)),
             (None, CASES[2], dict(softcap=5.0)), (None, CASES[3], WINDOW_CAP),
             (None, CASES[4], {}), ("int8", CASES[0], dict(softcap=30.0)),
             ("fp8", CASES[1], dict(window=6)), ("int8", CASES[2], {})]


@pytest.mark.parametrize("kv,geom,opts", LSE_CASES)
def test_lse_matches_pallas(kv, geom, opts):
    case = paged_case(6, kv=kv, **geom)
    out, lse = _run_ours(case, return_lse=True, **opts)
    ref_out, ref_lse = _run_pallas(case, return_lse=True, **opts)
    ref_lse = np.asarray(ref_lse)
    assert lse.dtype == torch.float32 and lse.shape == ref_lse.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=0,
                               atol=1e-5)
    live = case["lens"].numpy() > 0
    np.testing.assert_allclose(lse.numpy()[live], ref_lse[live], rtol=0,
                               atol=1e-5)
    assert (lse.numpy()[~live] <= -1e29).all()
    assert (ref_lse[~live] <= -1e29).all()
    # the output is the one a call without the LSE gives
    assert torch.equal(out, _run_ours(case, **opts))


@pytest.mark.parametrize("geom,cuts", [
    (CASES[0], (1, 3)), (CASES[1], (2, 5, 9)), (CASES[2], (4, 17, 30)),
    (CASES[4], (2,)), (dict(ps=8, Hq=4, Hkv=1, P=8, lens=(64, 9, 40)),
                       (1, 2, 3, 5, 7))])
@pytest.mark.parametrize("softcap", [None, 8.0])
def test_lse_merge_of_page_ranges_equals_whole(geom, cuts, softcap):
    """What the CUDA kernel does with a slot's page chunks, in plain
    PyTorch: the table cut into column ranges, each range attended with its
    lengths rebased (positions past the range dropped), the parts merged by
    their log-sum-exps, gives the whole table's answer in f32."""
    case = paged_case(7, **geom)
    ps, P = case["k"].shape[1], case["table"].shape[1]
    edges = (0,) + cuts + (P,)
    parts = []
    for c0, c1 in zip(edges[:-1], edges[1:]):
        lens = torch.clamp(case["lens"] - c0 * ps, 0, (c1 - c0) * ps)
        part = dict(case, table=case["table"][:, c0:c1].contiguous(),
                    lens=lens.to(torch.int32))
        parts.append(_run_ours(part, return_lse=True, softcap=softcap))
    merged = merge_by_lse(parts)
    whole = _run_ours(case, softcap=softcap)
    np.testing.assert_allclose(merged.numpy(), whole.numpy(), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("seed", [8, 9, 10])
def test_order_bound_covers_another_sum_order(seed):
    """ref.paged_decode_order_bound, the allowance beside one bf16 ulp for
    the card's bf16 outputs, holds between two float32 sum orders of the
    plain version -- the whole table and its page ranges merged by LSE -- at
    a 1,000-position slot, is 0 for an empty slot and stays far below the
    outputs' own size."""
    case = paged_case(seed, B=3, Hq=4, Hkv=2, D=64, ps=16, P=64,
                      lens=(1000, 0, 517))
    parts = []
    for c0 in range(0, 64, 16):
        lens = torch.clamp(case["lens"] - c0 * 16, 0, 256).to(torch.int32)
        part = dict(case, table=case["table"][:, c0:c0 + 16].contiguous(),
                    lens=lens)
        parts.append(_run_ours(part, return_lse=True))
    merged = merge_by_lse(parts)
    whole = _run_ours(case)
    bound = tref.paged_decode_order_bound(case["q"], case["k"], case["v"],
                                          case["table"], case["lens"])
    assert bound.shape == whole.shape and bound.dtype == torch.float32
    assert bool(((merged - whole).abs() <= bound).all())
    assert not bound[1].any() and bool((bound[0] > 0).all())
    assert bound.max().item() < 1e-6 < whole.abs().median().item()


@pytest.mark.parametrize("ps,P,B,Hkv,D", [
    (16, 64, 8, 32, 128),     # llama2-7b's serve shape
    (16, 16, 8, 4, 64),       # tinyllama's
    (8, 4, 3, 2, 16), (3, 10, 3, 2, 16), (1, 32, 3, 1, 16),
    (16, 64, 3, 1, 128), (16, 6, 8, 4, 64), (64, 7, 1, 1, 256),
    (1, 1024, 2, 1, 16), (16, 300, 8, 8, 128)])
def test_split_plan_covers_the_table_once(ps, P, B, Hkv, D):
    cp, n = kpa.split_plan(ps, P, B * Hkv, D)
    assert cp >= 1 and n == -(-P // cp)
    covered = [p for c in range(n) for p in range(c * cp, min((c + 1) * cp, P))]
    assert covered == list(range(P))          # every column once, in order
    if P >= 4:
        assert n > 1                          # a slot's pages span blocks
    assert n <= kpa.MAX_CHUNKS
    assert cp * ps <= max(ps * -(-P // kpa.MAX_CHUNKS),
                          kpa.CHUNK_BYTES // (2 * D))
