"""The port's float ServeEngine under the continuous-batching scheduler,
against the JAX package's ServeEngine on the same weights.

Reduced llama2-7b (MHA, 4/4 heads) and reduced tinyllama-1.1b (GQA, 4/2
heads): d_model 64, head_dim 16, 2 layers, vocab 256.  The port's engine is
built from ``params_from_numpy`` of the JAX params with ``page_size=8``,
``max_len=64`` (or a dense slot cache), the reference on an Auto-axis mesh
(its default mesh does not build on this JAX).  Four requests whose prompt
lengths cross power-of-two bucket edges (5, 9, 17, 24) go through each
package's scheduler with two slots, so slots turn over.

Greedy tokens must be identical to the reference with ``use_pallas=True``
(the Pallas flash kernel, which the port follows).  The reference's other
attention backend (``use_pallas=False``) rounds softmax weights to bf16 and
can pick other tokens; the port is held to it exactly on the requests where
the two JAX backends agree, and the test checks that agreement itself.
Page tables must agree after every scheduler iteration, and the eq. 7-10
meter must be exact to the byte, its log entry for entry the reference's.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")   # the parity tests need the JAX package

from jax.sharding import AxisType

from repro.configs import get_config
from repro.models import api as japi
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.scheduler import ContinuousBatchingScheduler as JScheduler
from repro.serve.scheduler import Request as JRequest
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.splitbrain import TrafficModel
from repro_torch.models.api import params_from_numpy
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import ContinuousBatchingScheduler, Request

ARCHS = ["llama2-7b", "tinyllama-1.1b"]
LENS = [5, 9, 17, 24]
MAX_NEW = 8
MAX_LEN = 64


def _prompts():
    return [((np.arange(1, n + 1) * 7 + i) % 256).astype(np.int32)
            for i, n in enumerate(LENS)]


def _requests(cls):
    return [cls(uid=i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(_prompts())]


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    cfg = get_config(arch).reduced()
    params = jax.jit(japi.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return dict(arch=arch, cfg=cfg, tcfg=t_get_config(arch).reduced(),
                params=params, tparams=tparams, mesh=mesh)


def _ref_engine(s, use_pallas, **kw):
    cfg = dataclasses.replace(s["cfg"], use_pallas=use_pallas)
    return JEngine(cfg, s["params"], mesh=s["mesh"], max_len=MAX_LEN, **kw)


def _port_engine(s, **kw):
    return ServeEngine(s["tcfg"], s["tparams"], max_len=MAX_LEN,
                       device="cpu", **kw)


def _serve_lockstep(ref_sched, our_sched, paged):
    """Step both schedulers together; with a page pool the page tables must
    agree after every iteration (admission, growth, release)."""
    for s, cls in ((ref_sched, JRequest), (our_sched, Request)):
        s.begin()
        for r in _requests(cls):
            assert s.submit(r)
    steps = 0
    while ref_sched.has_work() or our_sched.has_work():
        ref_sched.step()
        our_sched.step()
        steps += 1
        if paged:
            np.testing.assert_array_equal(
                ref_sched.engine._pager.pool.table,
                our_sched.engine._pager.pool.table,
                err_msg=f"iteration {steps}")
        assert steps < 200
    out = []
    for s in (ref_sched, our_sched):
        res = sorted(s.poll(), key=lambda r: r.uid)
        assert [r.state for r in res] == ["DONE"] * len(LENS)
        out.append([r.tokens.tolist() for r in res])
    return out


@pytest.mark.parametrize("page_size", [8, None], ids=["paged", "dense"])
def test_scheduler_tokens_tables_and_meter_match_pallas_reference(
        setup, page_size):
    ref = _ref_engine(setup, True, page_size=page_size)
    ours = _port_engine(setup, page_size=page_size)
    ref_toks, our_toks = _serve_lockstep(
        JScheduler(ref, max_slots=2),
        ContinuousBatchingScheduler(ours, max_slots=2),
        paged=page_size is not None)
    assert our_toks == ref_toks
    assert [len(t) for t in our_toks] == [MAX_NEW] * len(LENS)
    n_tok = sum(n - 1 for n in LENS) + MAX_NEW * len(LENS)
    bpt = TrafficModel.for_config(setup["tcfg"]).bytes_per_token()
    assert ours.measured_bytes()["total"] == bpt * n_tok
    assert ours.meter.log == ref.meter.log
    assert ours.meter.host_log == ref.meter.host_log
    if page_size is not None:
        assert ours._pager.pool.pages_in_use == 0    # every page came back


def test_scheduler_tokens_match_xla_backend_where_backends_agree(setup):
    """Against ``use_pallas=False``: identical tokens on every request
    where the two JAX backends agree with each other (reduced llama2-7b:
    all four; reduced tinyllama-1.1b: all but the 5-token prompt, where the
    bf16-rounded softmax weights of ``mha_chunked`` pick token 234 at step
    3 and the Pallas kernel 236)."""
    runs = {}
    for up in (True, False):
        out = JScheduler(_ref_engine(setup, up, page_size=8),
                         max_slots=2).run(_requests(JRequest))
        runs[up] = [r.tokens.tolist() for r in out["results"]]
    ours = ContinuousBatchingScheduler(_port_engine(setup, page_size=8),
                                       max_slots=2).run(_requests(Request))
    ours = [r.tokens.tolist() for r in ours["results"]]
    agree = [i for i in range(len(LENS)) if runs[True][i] == runs[False][i]]
    expected = ([0, 1, 2, 3] if setup["arch"] == "llama2-7b"
                else [1, 2, 3])
    assert agree == expected
    for i in agree:
        assert ours[i] == runs[False][i]
    assert ours == runs[True]


def test_run_counters_and_cache_stats(setup):
    ours = _port_engine(setup, page_size=8)
    sched = ContinuousBatchingScheduler(ours, max_slots=2)
    out = sched.run(_requests(Request))
    assert out["prefill_tokens"] == sum(n - 1 for n in LENS)
    assert out["decoded_tokens"] == MAX_NEW * len(LENS)
    assert out["by_state"] == {"DONE": len(LENS)}
    stats = ours.cache_stats(sched.cache)
    assert stats["num_pages"] == 2 * MAX_LEN // 8 + 1
    assert 0 < stats["peak_pages_in_use"] <= 2 * MAX_LEN // 8
    assert stats["pages_in_use"] == 0
    # a second run frees the first run's pool before it allocates its own,
    # so two pools never coexist on the device
    seen, init = [], ours.init_slot_cache
    ours.init_slot_cache = lambda n: seen.append(sched.cache is None) or init(n)
    sched.run(_requests(Request))
    assert seen == [True]


@pytest.mark.parametrize("page_size", [8, None], ids=["paged", "dense"])
def test_decode_slots_corrupt_freeze_and_rebuild(setup, page_size):
    """decode_slots: the ``corrupt`` hook NaN-poisons one slot's logits and
    the sentinel reports exactly that slot; an inactive slot keeps its
    ``len``; ``rebuild`` hands back a fresh slot cache."""
    eng = _port_engine(setup, page_size=page_size)
    cache = eng.init_slot_cache(2)
    prompt = np.arange(1, 6, dtype=np.int32)
    for slot in (0, 1):
        assert eng.admit_slot(slot, prompt, 3) == 0
        single, tok = eng.prefill_slot(prompt)
        cache = eng.insert_slot(cache, single, slot)
    nxt, ok, cache = eng.decode_slots(cache, np.array([tok, tok], np.int32),
                                      np.array([True, False]),
                                      corrupt=np.array([False, True]))
    assert ok.tolist() == [True, False] and nxt.dtype == np.int32
    assert cache["len"].tolist() == [5, 4]
    # the B=1 request cache holds the body's pages on the paged layout, a
    # max_len row for the dense slot cache
    assert single["k"][0].shape[4] == (8 if page_size else MAX_LEN)
    fresh = eng.rebuild(2)
    assert not fresh["k"][0].any() and fresh["len"].tolist() == [0, 0]
    if page_size is not None:
        assert eng._pager.pool.pages_in_use == 0
