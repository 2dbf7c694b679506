"""The port's plain flash attention against the JAX package's Pallas flash
kernel (interpret mode) and its naive oracle ``ref.mha``.

Inputs are made from numpy seeds, rounded once to the case's dtype, and
fed to both packages.  Tolerances: float32 outputs within atol 1e-5 (the
same f32 math with the sums taken in another order and blocking); bfloat16
outputs within one bf16 ulp (that order can flip the final rounding).
Cases cover causal and not, MHA and GQA,
window, softcap, ``kv_offset`` with Tq < Tk, an explicit ``scale``, Tq = 1,
and a ragged T = 37 run through 16-row blocks on the JAX side, so that its
block skipping and key padding are exercised.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the parity tests need the JAX package

import jax.numpy as jnp

from repro.kernels import flash_attention as jfa
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from torch_cases import assert_within_bf16_ulp

# (B, Hq, Hkv, Tq, Tk, D, options, Pallas block)
CASES = {
    "causal_mha": (2, 4, 4, 12, 12, 16, dict(causal=True), 512),
    "causal_gqa": (2, 4, 2, 12, 12, 16, dict(causal=True), 512),
    "noncausal_gqa": (1, 4, 2, 9, 9, 16, dict(causal=False), 512),
    "window_softcap": (2, 4, 2, 20, 20, 16,
                       dict(causal=True, window=6, softcap=5.0), 512),
    "kv_offset": (1, 4, 2, 5, 13, 16, dict(causal=True, kv_offset=8), 512),
    "noncausal_offset_scale": (1, 4, 4, 3, 10, 32,
                               dict(causal=False, kv_offset=7, scale=0.3), 512),
    "tq1": (2, 4, 2, 1, 1, 16, dict(causal=True), 512),
    "ragged37_blocked": (2, 4, 2, 37, 37, 16, dict(causal=True), 16),
    "ragged37_window_blocked": (1, 4, 2, 37, 37, 16,
                                dict(causal=True, window=10, softcap=8.0), 16),
}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(B, Hq, Hkv, Tq, Tk, D, jdt, tdt, seed=0):
    """Seeded q, k, v rounded to the dtype, as (jax arrays, torch tensors)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, Tq, D), (B, Hkv, Tk, D), (B, Hkv, Tk, D))]
    js = [jnp.asarray(a).astype(jdt) for a in arrs]
    ts = [torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)
          for j in js]
    return js, ts


def _check(ours, theirs, dtype):
    theirs = np.asarray(theirs.astype(jnp.float32))
    assert ours.dtype == DTYPES[dtype][1]
    if dtype == "float32":
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=1e-5)
    else:
        assert_within_bf16_ulp(ours, theirs)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_flash_attention_matches_pallas_and_mha(case, dtype):
    B, Hq, Hkv, Tq, Tk, D, opts, blk = CASES[case]
    jdt, tdt = DTYPES[dtype]
    (jq, jk, jv), (tq, tk, tv) = _inputs(B, Hq, Hkv, Tq, Tk, D, jdt, tdt)
    ours = ref.flash_attention(tq, tk, tv, **opts)
    assert ours.shape == (B, Hq, Tq, D)
    pallas = jfa.flash_attention(jq, jk, jv, bq=blk, bk=blk, interpret=True,
                                 **opts)
    _check(ours, pallas, dtype)
    _check(ours, jref.mha(jq, jk, jv, **opts), dtype)


def test_ops_attention_takes_the_plain_version_on_the_cpu():
    (_, _, _), (tq, tk, tv) = _inputs(1, 4, 2, 7, 7, 16, jnp.bfloat16,
                                      torch.bfloat16, seed=3)
    ops.reset_launch_counts()
    out = ops.attention(tq.transpose(2, 3).contiguous().transpose(2, 3), tk,
                        tv, causal=True, softcap=4.0)
    assert torch.equal(out, ref.flash_attention(tq, tk, tv, causal=True,
                                                softcap=4.0))
    assert ops.launch_counts()["flash_attention"] == 0


def test_documented_difference_from_mha_chunked():
    """Why the port does not follow ``ref.mha_chunked``: that backend
    rounds the softmax weights p to bf16 before the value product, so on
    bf16 inputs it differs from the Pallas kernel (which the port matches
    exactly) by more than a bf16 ulp on some outputs, up to about 2^-7."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(2, 4, 2, 64, 64, 16, jnp.bfloat16,
                                         torch.bfloat16, seed=7)
    ours = ref.flash_attention(tq, tk, tv).float().numpy()
    pallas = np.asarray(jfa.flash_attention(jq, jk, jv, interpret=True)
                        .astype(jnp.float32))
    chunked = np.asarray(jref.mha_chunked(jq, jk, jv).astype(jnp.float32))
    np.testing.assert_array_equal(ours, pallas)
    diff = np.abs(chunked - pallas)
    assert (diff > 0).mean() > 0.05
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(pallas), 2.0 ** -126)))
                  - 7)
    assert (diff > ulp).any()
    assert diff.max() <= 2.0 ** -6
