"""The KV page quantizer of int8 / fp8 pools against the JAX package's
``models/layers.py`` functions as its engines run them (jitted): the page
scale, encode and decode, the quantize-on-write page append and the
fake-quant of a request cache's completed pages, bit for bit on the same
numpy inputs.

The reference computes the scale as ``exp(ceil(log(amax * (1/qmax)) *
log2(e)) * ln 2)`` with XLA's float32 log and exp, which are not correctly
rounded: near a power of two ``ceil`` can step a few ulps early or late,
and ``exp`` of an integer multiple of ln 2 is a power of two only for
exponents in [-13, 13].  The port reads both effects from two tables
(``layers._LOG_STEP_ULPS`` / ``_EXP2_ULPS``); the first tests rebuild them
from the JAX package and check every entry, then the scale on values at,
just below and just above ``qmax * 2^k``.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the parity tests need the JAX package
import jax.numpy as jnp

from repro.models import layers as JL
from repro_torch.models import layers as L

KV = ["int8", "fp8"]


def _np(t):
    """A tensor's bytes as numpy (fp8 as uint8)."""
    return L.byte_view(t).numpy() if t.dtype == torch.float8_e4m3fn \
        else t.numpy()


def _jnp_bytes(a):
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 and a.dtype != np.int8 \
        else a


def test_log_step_table_is_xlas():
    """For each k, the first float32 r at which ceil(log(r) * log2(e))
    reaches k + 1 in a compiled JAX program lies _LOG_STEP_ULPS[k + 110]
    ulps from 2^k, and the step is single (monotone) within 2^14 ulps."""
    f = jax.jit(lambda r: jnp.ceil(jnp.log(r) * np.float32(1.44269502)))
    W = 1 << 14
    for k, want in zip(range(-110, 128), L._LOG_STEP_ULPS):
        c = int(np.float32(2.0 ** k).view(np.int32))
        bits = np.arange(c - W, c + W, dtype=np.int64).astype(np.int32)
        out = np.asarray(f(jnp.asarray(bits.view(np.float32))))
        steps = np.flatnonzero(np.diff(out) > 0)
        assert len(steps) == 1 and set(np.unique(out)) == {k, k + 1}, k
        assert int(bits[steps[0] + 1]) - c == want, k


def test_exp2_table_is_xlas():
    e = np.arange(-110, 129).astype(np.float32)
    ref = np.asarray(jax.jit(lambda a: jnp.exp(a * np.float32(0.693147182)))(
        jnp.asarray(e)))
    _, vals = L._scale_tables("cpu")
    np.testing.assert_array_equal(vals.numpy().view(np.int32),
                                  ref.view(np.int32))


@pytest.mark.parametrize("kv_dtype", KV)
def test_pow2_scale_bit_identical_at_edges(kv_dtype):
    qmax = {"int8": 127.0, "fp8": 448.0}[kv_dtype]
    rng = np.random.default_rng(0)
    edge = (np.float32(qmax) * np.exp2(np.arange(-100, 120))).astype(
        np.float32)
    bf16 = torch.from_numpy(np.exp2(rng.uniform(-20, 12, 20000)).astype(
        np.float32)).bfloat16().float().numpy()
    a = np.concatenate([edge, np.nextafter(edge, np.float32(0)),
                        np.nextafter(edge, np.float32(np.inf)), bf16,
                        np.exp2(rng.uniform(-40, 30, 20000)),
                        [0.0, 1e-35, 3e38]]).astype(np.float32)
    ref = np.asarray(jax.jit(lambda x: JL.kv_pow2_scale(x, kv_dtype))(
        jnp.asarray(a)))
    ours = L.kv_pow2_scale(torch.from_numpy(a), kv_dtype).numpy()
    np.testing.assert_array_equal(ours.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("kv_dtype", KV)
def test_quantize_and_dequantize_bit_identical(kv_dtype):
    """Encode (round half to even and clip to +-127 for int8, the
    round-to-nearest-even cast for fp8), at half-way values too, and the
    exact decode."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((64, 128)) * 3).astype(np.float32)
    x[0, :64] = np.arange(-32, 32) + 0.5            # half-way codes
    amax = np.abs(x).max(axis=1, keepdims=True)
    sc = L.kv_pow2_scale(torch.from_numpy(amax), kv_dtype).numpy()
    f = jax.jit(lambda x, s: JL.kv_quantize(x, s, kv_dtype))
    ref = f(jnp.asarray(x), jnp.asarray(sc))
    ours = L.kv_quantize(torch.from_numpy(x), torch.from_numpy(sc), kv_dtype)
    np.testing.assert_array_equal(_np(ours), _jnp_bytes(ref))
    back = jax.jit(lambda c, s: JL.kv_dequantize(c, s, jnp.bfloat16))(ref, sc)
    np.testing.assert_array_equal(
        L.kv_dequantize(ours, torch.from_numpy(sc), torch.bfloat16)
        .float().numpy(), np.asarray(back.astype(jnp.float32)))


def _pool(rng, kv_dtype, N=9, ps=8, Hkv=2, D=16):
    """A pool whose every page holds stale codes and a stale scale (a
    recycled pool), as numpy."""
    x = rng.standard_normal((N, ps, Hkv, D)).astype(np.float32) * 2
    sc = np.array(JL.kv_pow2_scale(jnp.asarray(np.abs(x).max(axis=(1, 3))),
                                   kv_dtype))
    codes = np.asarray(JL.kv_quantize(jnp.asarray(x),
                                      jnp.asarray(sc[:, None, :, None]),
                                      kv_dtype))
    return codes, sc


@pytest.mark.parametrize("kv_dtype", KV)
def test_quant_page_append_bit_identical(kv_dtype):
    """Several steps of appends into a recycled pool: fresh pages (off 0,
    whose stale scale must not leak), pages partly written, a token larger
    than a page's range (the scale grows, never shrinks), and inactive slots
    piling onto the scratch page 0.  Every live page's codes and scales
    bit-identical after each step (the scratch page holds garbage by
    contract)."""
    rng = np.random.default_rng(2)
    codes, sc = _pool(rng, kv_dtype)
    sc[3] *= 64.0                  # a stale scale far above page 3's new one
    ref_c, ref_s = jnp.asarray(codes), jnp.asarray(sc)
    ours_c = torch.from_numpy(np.array(codes.view(np.uint8)
                                       if kv_dtype == "fp8" else codes))
    if kv_dtype == "fp8":
        ours_c = ours_c.view(torch.float8_e4m3fn)
    ours_c, ours_s = ours_c.clone(), torch.from_numpy(sc.copy())
    f = jax.jit(lambda c, s, t, p, o: JL.quant_page_append(c, s, t, p, o,
                                                           kv_dtype))
    steps = [([3, 0, 5, 0], [0, 0, 4, 0]),      # fresh page 3; page 5 mid
             ([3, 0, 5, 7], [1, 0, 5, 7]),      # page 7 at its last slot
             ([3, 0, 5, 0], [2, 0, 6, 0])]
    for i, (page, off) in enumerate(steps):
        tok = rng.standard_normal((4, 2, 16)).astype(np.float32)
        tok[0] *= 40.0 if i == 1 else 1.0       # beyond the page's range
        tok = np.asarray(jnp.asarray(tok).astype(jnp.bfloat16)
                         .astype(jnp.float32))
        p, o = np.asarray(page, np.int32), np.asarray(off, np.int32)
        ref_c, ref_s = f(ref_c, ref_s, jnp.asarray(tok), p, o)
        L.quant_page_append(ours_c, ours_s, torch.from_numpy(tok),
                            torch.from_numpy(p).long(),
                            torch.from_numpy(o).long(), kv_dtype)
        np.testing.assert_array_equal(_np(ours_c)[1:],
                                      _jnp_bytes(ref_c)[1:], err_msg=str(i))
        np.testing.assert_array_equal(ours_s.numpy()[1:].view(np.int32),
                                      np.asarray(ref_s)[1:].view(np.int32))
        if i == 0:     # page 3 started fresh: its stale scale did not leak
            assert (ours_s[3] < torch.from_numpy(sc[3])).all()
            fresh = ours_s[3].clone()
        if i == 1:     # the large token grew page 3's scale
            assert (ours_s[3] > fresh).all()


@pytest.mark.parametrize("kv_dtype", KV)
@pytest.mark.parametrize("n_tokens", [0, 13, 24, 31])
def test_fake_quant_pages_bit_identical(kv_dtype, n_tokens):
    """A B=1 request-cache leaf (the lm layout, sequence axis 4): only the
    pages wholly below ``n_tokens`` round-trip, every one of them on every
    call, the tail stays as it was."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 1, 1, 2, 32, 16)) * 2).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = jax.jit(lambda a, n: JL.fake_quant_pages(a, 4, n, 8, kv_dtype))(
        xb, jnp.int32(n_tokens))
    ours = torch.from_numpy(np.asarray(xb.astype(jnp.float32))).bfloat16()
    again = L.fake_quant_pages(ours, 4, n_tokens, 8, kv_dtype)
    assert again is ours
    np.testing.assert_array_equal(ours.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("kv_dtype", KV)
def test_paged_attention_takes_a_quantized_leaf(kv_dtype):
    """``ops.paged_decode_attention`` unpacks a ``QuantizedLeaf`` pool into
    codes and scales, as the JAX package's dispatcher does, and gives the
    reference's output on the same pool."""
    from repro.kernels import ops as jops
    from repro_torch.core.quant import QuantizedLeaf
    from repro_torch.kernels import ops
    from torch_cases import paged_case
    c = paged_case(5, kv=kv_dtype)
    k, v = (QuantizedLeaf(c[x], c[x + "_scale"], kv_dtype, torch.float32)
            for x in ("k", "v"))
    ours = ops.paged_decode_attention(c["q"], k, v, c["table"], c["lens"])
    jk, jv = (JL.QuantizedLeaf(jnp.asarray(_np(c[x]).view(
        np.int8 if kv_dtype == "int8" else jnp.float8_e4m3fn)),
        jnp.asarray(c[x + "_scale"].numpy()), kv_dtype, "float32")
        for x in ("k", "v"))
    ref = jops.paged_decode_attention(
        jnp.asarray(c["q"].numpy()), jk, jv, jnp.asarray(c["table"].numpy()),
        jnp.asarray(c["lens"].numpy()), use_pallas=False)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
