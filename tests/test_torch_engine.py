"""The port's split-brain slice end to end against the JAX package.

Reduced tinyllama (2 layers, d_model 64, 4 heads, 2 KV heads, hd 16),
LAQ W4A8 weights, a paged KV pool (page_size 8, max_len 32) and each
package's own continuous-batching scheduler with two slots, so slots turn
over.  Both packages run the SAME weights (``params_from_numpy``); the
reference is built on an Auto-axis mesh (its default mesh does not build
on this JAX).  Greedy tokens and page tables must be identical, the
eq. 7-10 meter exact to the byte.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")   # the parity tests need the JAX package

from jax.sharding import AxisType

from repro.configs import get_config
from repro.models import api as japi
from repro.serve.scheduler import ContinuousBatchingScheduler as JScheduler
from repro.serve.scheduler import Request as JRequest
from repro.serve.splitbrain_engine import SplitBrainEngine as JEngine
from repro_torch.configs import get_config as t_get_config
from repro_torch.models.api import params_from_numpy
from repro_torch.serve.scheduler import ContinuousBatchingScheduler, Request
from repro_torch.serve.splitbrain_engine import (
    SplitBrainEngine, traffic_model_for)

ARCH = "tinyllama-1.1b"
PROMPTS = [np.arange(1, 6 + i, dtype=np.int32) for i in range(3)] + [
    np.array([9, 200, 31, 7, 7, 100, 3, 3, 250], np.int32)]
MAX_NEW = [4, 4, 4, 9]


@pytest.fixture(scope="module")
def setup():
    cfg = get_config(ARCH).reduced()
    params = jax.jit(japi.init_params, static_argnums=0)(cfg, jax.random.PRNGKey(0))
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    return cfg, t_get_config(ARCH).reduced(), params, mesh


def _port_engine(setup, device="cpu", **kw):
    _, tcfg, params, _ = setup
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), device)
    return SplitBrainEngine(tcfg, tparams, max_len=32, quantize=True,
                            device=device, **kw)


def _requests(cls):
    return [cls(uid=i, prompt=p, max_new=m)
            for i, (p, m) in enumerate(zip(PROMPTS, MAX_NEW))]


def _serve_lockstep(ref_sched, our_sched):
    """Step both schedulers together; the page tables must agree after
    every iteration (admission, growth, release)."""
    for s, cls in ((ref_sched, JRequest), (our_sched, Request)):
        s.begin()
        for r in _requests(cls):
            assert s.submit(r)
    steps = 0
    while ref_sched.has_work() or our_sched.has_work():
        ref_sched.step()
        our_sched.step()
        steps += 1
        np.testing.assert_array_equal(
            ref_sched.engine._pager.pool.table,
            our_sched.engine._pager.pool.table, err_msg=f"iteration {steps}")
        assert steps < 100
    out = []
    for s in (ref_sched, our_sched):
        res = sorted(s.poll(), key=lambda r: r.uid)
        assert [r.state for r in res] == ["DONE"] * len(PROMPTS)
        out.append([r.tokens.tolist() for r in res])
    return out


@pytest.mark.parametrize("use_pallas", [False, True])
def test_scheduler_tokens_page_tables_and_meter_identical(setup, use_pallas):
    """Tokens and page tables identical; eq. 7-10 total ==
    bytes_per_token x (prefill + decoded tokens) to the byte, the meter log
    (and its live-page KV-read channel) entry for entry the reference's."""
    cfg, tcfg, params, mesh = setup
    ref = JEngine(cfg, params, max_len=32, quantize=True, page_size=8,
                  use_pallas=use_pallas, mesh=mesh)
    ours = _port_engine(setup, page_size=8)
    ref_toks, our_toks = _serve_lockstep(JScheduler(ref, max_slots=2),
                                         ContinuousBatchingScheduler(ours, max_slots=2))
    assert our_toks == ref_toks
    assert [len(t) for t in our_toks] == MAX_NEW
    n_tok = sum(len(p) - 1 for p in PROMPTS) + sum(MAX_NEW)
    assert ours.meter.measured_bytes()["total"] == \
        traffic_model_for(tcfg).bytes_per_token() * n_tok
    assert ours.meter.log == ref.meter.log
    assert ours.meter.host_log == ref.meter.host_log
    assert ours._pager.pool.pages_in_use == 0      # every page came back


def test_run_counters(setup):
    """The closed-loop run() reports what was served."""
    ours = _port_engine(setup, page_size=8)
    out = ContinuousBatchingScheduler(ours, max_slots=2).run(_requests(Request))
    assert out["prefill_tokens"] == sum(len(p) - 1 for p in PROMPTS)
    assert out["decoded_tokens"] == sum(MAX_NEW)
    assert out["by_state"] == {"DONE": len(PROMPTS)}


@pytest.mark.parametrize("quantize", [True, False])
def test_decode_token_dense_matches_reference(setup, quantize):
    """The dense decode_token (the path prefill runs) against the
    reference's eager per-layer loop (``jit=False``), LAQ W4A8 or float
    weights: tokens identical, logits within one bf16 ulp of the largest
    logit (bit-identical on this CPU: the same ops, rounded to bf16 at the
    same points; a last-bit difference in a float matmul's sum order would
    move a logit by about one ulp).  The reference's compiled scan keeps
    some bf16 intermediates in f32 and differs by up to ~2^-5 in a logit;
    the scheduler test above holds the tokens of that compiled path."""
    cfg, tcfg, params, mesh = setup
    ours = SplitBrainEngine(tcfg, params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu"), max_len=32,
        quantize=quantize, device="cpu")
    ref = JEngine(cfg, params, max_len=32, quantize=quantize, mesh=mesh,
                  jit=False)
    jc, tc = ref.init_cache(2), ours.init_cache(2)
    tok = np.array([3, 5], np.int32)
    for _ in range(2):
        tj, lj, jc = ref.decode_token(jc, jax.numpy.asarray(tok))
        tt, lt, tc = ours.decode_token(tc, tok)
        np.testing.assert_array_equal(np.asarray(tj), tt.numpy())
        lj = np.asarray(lj.astype(np.float32))
        ulp = 2.0 ** (np.floor(np.log2(np.abs(lj).max())) - 7)
        np.testing.assert_allclose(lt.float().numpy(), lj, rtol=0, atol=ulp)
        tok = tt.numpy()
    assert ours.measured_bytes_per_token(2) == ref.measured_bytes_per_token(2)


def test_corrupt_flags_a_slot_and_rebuild_resets(setup):
    """decode_slots: the ``corrupt`` hook NaN-poisons one slot's logits and
    the finite-logits sentinel reports exactly that slot; ``rebuild`` hands
    back a fresh pool and an empty pager."""
    eng = _port_engine(setup, page_size=8)
    cache = eng.init_slot_cache(2)
    for slot in (0, 1):
        eng.admit_slot(slot, np.arange(1, 5, dtype=np.int32), 3)
        single, tok = eng.prefill_slot(np.arange(1, 5, dtype=np.int32))
        cache = eng.insert_slot(cache, single, slot)
    nxt, ok, cache = eng.decode_slots(cache, np.array([4, 4], np.int32),
                                      np.array([True, True]),
                                      corrupt=np.array([False, True]))
    assert ok.tolist() == [True, False] and nxt.dtype == np.int32
    assert cache["len"].tolist() == [4, 4]
    assert eng._pager.pool.pages_in_use == 2
    fresh = eng.rebuild(2)
    assert eng._pager.pool.pages_in_use == 0 and not fresh["k"].any()
    # without page_size the slot cache is the dense (L, n_slots, Hkv,
    # max_len, hd) cache, and its rebuild a fresh one
    dense = _port_engine(setup)
    cache = dense.init_slot_cache(2)
    assert cache["k"].shape[1:4:2] == (2, 32) and not cache["k"].any()
    assert dense.cache_stats(cache)["cache_bytes"] == sum(
        t.numel() * t.element_size() for t in cache.values())


def test_not_ported_options_refuse(setup):
    """The options this test once held to a refusal (prefix sharing, the
    gather discipline, an int8 pool, chunked prefill) now serve: every
    request DONE with the tokens of the plain paged engine."""
    plain = ContinuousBatchingScheduler(_port_engine(setup, page_size=8),
                                        max_slots=2).run(_requests(Request))
    want = [r.tokens.tolist() for r in plain["results"]]
    for kw, chunk in ((dict(page_size=8, prefix_cache="on"), None),
                      (dict(page_size=8, paged_attn="gather"), None),
                      (dict(page_size=8, kv_dtype="int8"), None),
                      (dict(page_size=8), 4)):
        out = ContinuousBatchingScheduler(
            _port_engine(setup, **kw), max_slots=2,
            prefill_chunk=chunk).run(_requests(Request))
        assert out["by_state"] == {"DONE": len(PROMPTS)}
        if "kv_dtype" not in kw:
            assert [r.tokens.tolist() for r in out["results"]] == want
