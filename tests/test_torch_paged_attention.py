"""repro_torch paged flash-decode attention against the JAX package.

The plain version (``repro_torch.kernels.ref.paged_decode_attention``) is
held to the Pallas kernel in interpret mode:
  * f32 inputs: atol 1e-5 — both take the logits, the online softmax and the
    value sum in f32, in different summation orders (~1e-7 relative each);
  * bf16 inputs: within one bf16 ulp of the reference's value — the same f32
    math, then one rounding to bf16 that a last-bit f32 difference can flip.
Page sizes {1, 3, 8}, GQA, window, softcap, an empty slot (cache_len 0) and
int8 / fp8 pools with per-(page, KV head) scales are covered.  The CUDA
kernel is held to the plain version on the card in ``test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")   # the parity half needs the JAX package

from repro.kernels import paged_attention as jpa
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from torch_cases import assert_within_bf16_ulp, paged_case, run_paged


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


def test_lse_variant_is_not_ported_yet():
    from repro_torch.kernels import paged_attention as kpa
    case = paged_case(0)
    with pytest.raises(NotImplementedError):
        _run_ours(case, fn=kpa.paged_decode_attention, return_lse=True)
