"""repro_torch layers against the JAX package's (compiled, as its engine runs
them), on the same numpy inputs in bfloat16.

Float modules (rmsnorm, rope, SwiGLU, the QKV projection) are held to one
bf16 ulp: both sides take the same op sequence in f32 and round to bf16 at
the same points, and only a last-bit difference in a transcendental (rsqrt,
cos, sin, exp) could flip a rounding.  Page writes, page tables and the
pool insert are exact.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the parity tests need the JAX package

import jax.numpy as jnp

from repro.core import quant as jq
from repro.models import layers as JL
from repro.serve import pages as jpages
from repro_torch.core import quant as tq
from repro_torch.models import layers as TL
from repro_torch.serve import pages as tpages
from torch_cases import assert_within_bf16_ulp as _within

RNG = np.random.default_rng(0)


def _bf(x):
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def assert_within_bf16_ulp(ours: torch.Tensor, ref, ulps=1):
    _within(ours, _f32(ref), ulps)


def _weights(shapes, quantized):
    ws = [(RNG.standard_normal(s) * 0.1).astype(np.float32) for s in shapes]
    if quantized:
        return ([jax.jit(jq.quantize_weights)(jnp.asarray(w)) for w in ws],
                [tq.quantize_weights(torch.from_numpy(w)) for w in ws])
    return [jnp.asarray(w) for w in ws], [torch.from_numpy(w) for w in ws]


def test_rmsnorm():
    xj, xt = _bf(RNG.standard_normal((3, 1, 64)).astype(np.float32) * 3)
    g = (RNG.standard_normal(64) * 0.1).astype(np.float32)
    ref = jax.jit(JL.rmsnorm)(xj, jnp.asarray(g), 1e-6)
    assert_within_bf16_ulp(TL.rmsnorm(xt, torch.from_numpy(g), 1e-6), ref)


@pytest.mark.parametrize("pos", [np.array([0, 3, 17, 250], np.int32),
                                 np.array([[0], [5], [31], [255]], np.int32)])
def test_rope(pos):
    T = pos.shape[-1] if pos.ndim == 2 else pos.shape[0]
    xj, xt = _bf(RNG.standard_normal((4, 4, T, 16)).astype(np.float32))
    ref = jax.jit(JL.rope)(xj, jnp.asarray(pos), 10000.0)
    assert_within_bf16_ulp(TL.rope(xt, torch.from_numpy(pos), 10000.0), ref)


@pytest.mark.parametrize("quantized", [True, False])
def test_swiglu(quantized):
    xj, xt = _bf(RNG.standard_normal((3, 1, 64)).astype(np.float32))
    wj, wt = _weights([(64, 128), (64, 128), (128, 64)], quantized)
    ref = jax.jit(JL.swiglu)(xj, *wj)
    assert_within_bf16_ulp(TL.swiglu(xt, *wt), ref)


def test_qkv_project_quantized():
    xj, xt = _bf(RNG.standard_normal((2, 1, 64)).astype(np.float32))
    wj, wt = _weights([(64, 64), (64, 32), (64, 32)], True)
    pj = dict(zip(("wq", "wk", "wv"), wj))
    pt = dict(zip(("wq", "wk", "wv"), wt))
    ref = jax.jit(lambda p, x: JL.qkv_project(p, x, 4, 2, 16))(pj, xj)
    ours = TL.qkv_project(pt, xt, 4, 2, 16)
    for r, o, shape in zip(ref, ours, [(2, 4, 1, 16), (2, 2, 1, 16), (2, 2, 1, 16)]):
        assert tuple(o.shape) == shape
        assert_within_bf16_ulp(o, r)


def test_paged_cache_write_exact_and_in_place():
    N, ps, Hkv, D, B, P = 9, 4, 2, 8, 3, 4
    pool = RNG.standard_normal((N, ps, Hkv, D)).astype(np.float32)
    new = RNG.standard_normal((B, Hkv, 1, D)).astype(np.float32)
    table = np.array([[3, 5, 0, 0], [1, 2, 4, 6], [0, 0, 0, 0]], np.int32)
    pos = np.array([5, 13, 16], np.int32)       # slot 2: finished, stale pos
    write = np.array([True, True, False])
    ref = jax.jit(JL.paged_cache_write)(
        jnp.asarray(pool).astype(jnp.bfloat16),
        jnp.asarray(new).astype(jnp.bfloat16), jnp.asarray(table),
        jnp.asarray(pos), jnp.asarray(write))
    tpool = torch.from_numpy(pool).to(torch.bfloat16)
    before = tpool.clone()
    out = TL.paged_cache_write(tpool, torch.from_numpy(new).to(torch.bfloat16),
                               torch.from_numpy(table), torch.from_numpy(pos),
                               torch.from_numpy(write))
    assert out is tpool
    # the scratch page is garbage by contract: compare every other page
    np.testing.assert_array_equal(_f32(ref)[1:], tpool.float().numpy()[1:])
    # in place, and only the two appended rows (plus scratch) changed
    changed = {tuple(c) for c in
               (tpool != before).reshape(N, ps, -1).any(-1).nonzero().tolist()}
    assert {(5, 1), (6, 1)} <= changed <= {(5, 1), (6, 1), (0, 0)}


def test_insert_tree_matches_reference_pool():
    """A prefilled B=1 dense cache scattered into the pool through a table
    row with excess logical pages on scratch: every real page equals the
    JAX package's insert; the dense ``len`` leaf lands in the slot's row."""
    L, Hkv, S, hd, ps, N, n_slots = 2, 2, 16, 8, 4, 7, 3
    k = RNG.standard_normal((L, 1, Hkv, S, hd)).astype(np.float32)
    single = {"k": k, "v": -k, "len": np.array([6], np.int32)}
    row = np.array([4, 2, 0, 0], np.int32)
    ba = {"k": 1, "v": 1, "len": 0}
    sa = {"k": 3, "v": 3, "len": -1}
    shapes = {"k": (L, n_slots, Hkv, S, hd), "v": (L, n_slots, Hkv, S, hd),
              "len": (n_slots,)}
    dtypes = {"k": torch.bfloat16, "v": torch.bfloat16, "len": torch.int32}
    like = {n: torch.empty(s, dtype=dtypes[n], device="meta")
            for n, s in shapes.items()}
    tpool = tpages.make_pool(like, ba, sa, N, ps, "cpu")
    assert tuple(tpool["k"].shape) == (L, N, ps, Hkv, hd)
    jlike = {n: jax.ShapeDtypeStruct(s, jnp.bfloat16 if n != "len" else jnp.int32)
             for n, s in shapes.items()}
    jpool = jpages.make_pool(jlike, ba, sa, N, ps)
    jout = jpages.insert_tree(jpool, {n: jnp.asarray(a).astype(jpool[n].dtype)
                                      for n, a in single.items()},
                              jnp.asarray(row), jnp.int32(1), ba, sa)
    tpages.insert_tree(tpool, {n: torch.from_numpy(a).to(dtypes[n])
                               for n, a in single.items()},
                       torch.from_numpy(row), 1, ba, sa)
    for n in ("k", "v"):
        np.testing.assert_array_equal(_f32(jout[n])[:, 1:],
                                      tpool[n].float().numpy()[:, 1:])
    np.testing.assert_array_equal(np.asarray(jout["len"]), tpool["len"].numpy())
