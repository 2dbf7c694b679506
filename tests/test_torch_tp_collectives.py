"""The tensor-parallel decode-attention collectives
(``repro_torch/distributed/collectives.py``: the paged ones through
``kernels/ops.py``'s TP dispatch, the dense one directly) on gloo ranks on the CPU, against the JAX package: the
head-cut paged case (Hkv = tp: each rank's kernel on its heads) and the
page-split LSE merge (Hkv = 1 < tp) of ``tests/test_mesh_serve.py``
against its interpret-mode Pallas kernel, the int8 head-cut case against
its plain ``ref.paged_decode_attention``, and the sequence-cut dense
``distributed_decode_attention`` against its single-device
``ref.decode_attention``, each within 1e-5.  One spawn per tp."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp

from repro.kernels import paged_attention as jpa
from repro.kernels import ref as jref
from repro_torch.distributed import runtime
from torch_tp_cases import fail_on_rank_1, paged_rank

TOL = 1e-5
B, D, PS, N, PG = 3, 16, 8, 12, 4


def _cases(tp):
    """The mesh test's kernel cases (B 3, D 16, ps 8, N 12, P 4, lengths
    1 / 9 / 30, softcap 2.0) and the int8 and dense ones, as numpy."""
    rng = np.random.default_rng(tp)
    lens = np.asarray([1, 9, 30], np.int32)
    table = rng.permutation(N)[:B * PG].reshape(B, PG).astype(np.int32)

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    cases = {}
    for name, hkv in (("head_cut", tp), ("merge", 1)):
        cases[name] = dict(kind=name, q=f32(B, 4, 1, D), k=f32(N, PS, hkv, D),
                           v=f32(N, PS, hkv, D), table=table, lens=lens,
                           softcap=2.0)
    cases["int8_head_cut"] = dict(
        kind="head_cut", kv_dtype="int8", q=f32(B, 4, 1, D),
        k=rng.integers(-127, 128, (N, PS, tp, D)).astype(np.int8),
        v=rng.integers(-127, 128, (N, PS, tp, D)).astype(np.int8),
        k_scale=np.exp2(rng.integers(-9, -5, (N, tp))).astype(np.float32),
        v_scale=np.exp2(rng.integers(-9, -5, (N, tp))).astype(np.float32),
        table=table, lens=lens, softcap=2.0)
    S = 8 * tp
    cases["dense"] = dict(kind="dense", q=f32(B, 4, 1, D),
                          k=f32(B, 2, S, D), v=f32(B, 2, S, D),
                          lens=np.asarray([1, S // 2 + 1, S], np.int32),
                          softcap=2.0)
    return cases


def _want(c):
    j = {k: jnp.asarray(v) for k, v in c.items() if isinstance(v, np.ndarray)}
    if c["kind"] == "dense":
        return jref.decode_attention(j["q"], j["k"], j["v"], j["lens"],
                                     softcap=c["softcap"])
    if "k_scale" in j:
        return jref.paged_decode_attention(
            j["q"], j["k"], j["v"], j["table"], j["lens"],
            softcap=c["softcap"], k_scale=j["k_scale"], v_scale=j["v_scale"])
    return jpa.paged_decode_attention(j["q"], j["k"], j["v"], j["table"],
                                      j["lens"], softcap=c["softcap"],
                                      interpret=True)


@pytest.mark.parametrize("tp", [2, 4])
def test_collectives_match_the_jax_package(tp):
    cases = _cases(tp)
    ranks = runtime.spawn(paged_rank, (1, tp), (cases,), backend="gloo",
                          devices=["cpu"] * tp, timeout=300)
    for name, c in cases.items():
        want = np.asarray(_want(c))
        for r, got in enumerate(ranks):
            assert got[name].shape == want.shape, (name, r)
            err = float(np.max(np.abs(got[name] - want)))
            assert err < TOL, (name, r, err)
        # every rank holds the same output (gathered, or merged)
        assert all(np.array_equal(g[name], ranks[0][name]) for g in ranks)


def test_a_failing_rank_fails_the_run():
    """A rank that raises ends the run with its traceback, and no rank goes
    on: ``spawn`` raises in the caller."""
    with pytest.raises(RuntimeError, match="rank 1 raised"):
        runtime.spawn(fail_on_rank_1, (1, 2), (), backend="gloo",
                      devices=["cpu"] * 2, timeout=120)
