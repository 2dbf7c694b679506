"""The port's OnlineServer (a copy of the JAX package's ``serve/server.py``)
over the port's scheduler and ServeEngine, with the JAX package's engine on
the same weights as the token reference (an Auto-axis mesh; the JAX
package's own ``tests/test_server.py`` cannot build its engine on the
installed JAX).

Reduced stablelm-1.6b, max_len 64, two slots.  The cases of the JAX
package's file: streamed tokens equal the terminal result's and the
reference's ``generate()``; many submitting threads; cancellation and a
deadline mid-flight; a rejection resolves with its reason and the loop
lives on; priority reorders admission; ``stop(drain=False)`` cancels what
is outstanding.  And the watchdog: a decode step wedged for 1 s by the
injector's ``step_stall`` trips a 0.2 s watchdog, the recovery runs on the
loop thread, the requests finish with the reference's tokens, and
``stats()`` shows the incident."""
import dataclasses
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")   # the parity tests need the JAX package

from jax.sharding import AxisType

from repro.configs import get_config
from repro.models import api as japi
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs import get_config as t_get_config
from repro_torch.models.api import params_from_numpy
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.faults import FaultInjector, FaultPlan
from repro_torch.serve.scheduler import ContinuousBatchingScheduler
from repro_torch.serve.server import OnlineServer, ServerClosed

MAX_NEW = 6


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("stablelm-1.6b").reduced()
    cfg = dataclasses.replace(
        cfg, use_pallas=True,
        parallel=dataclasses.replace(cfg.parallel, remat="none"))
    params = jax.jit(japi.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    tcfg = t_get_config("stablelm-1.6b").reduced()
    ref = JEngine(cfg, params, mesh=mesh, max_len=64)
    eng = ServeEngine(tcfg, tparams, max_len=64, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, (t,)).astype(np.int32)
               for t in (5, 8, 4, 6)]
    base = [np.asarray(ref.generate(p[None, :], max_new=MAX_NEW)
                       ["tokens"][0]) for p in prompts]
    paged = ServeEngine(tcfg, tparams, max_len=32, page_size=4, num_pages=33,
                        prefix_cache="on", device="cpu")
    return eng, paged, prompts, base


def _server(eng, **kw):
    return OnlineServer(ContinuousBatchingScheduler(eng, max_slots=2, **kw))


def test_stream_result_and_baseline_agree(setup):
    eng, _, prompts, base = setup
    with _server(eng) as srv:
        handles = [srv.submit(p, max_new=MAX_NEW) for p in prompts]
        streamed = [list(h.stream()) for h in handles]
        results = [h.result(timeout=60) for h in handles]
    for got, res, b in zip(streamed, results, base):
        assert res.state == "DONE"
        np.testing.assert_array_equal(got, b)
        np.testing.assert_array_equal(res.tokens, b)
        assert res.admitted_s >= 0.0 and res.ttft_s >= 0.0


def test_concurrent_submitters(setup):
    eng, _, prompts, base = setup
    results, lock = {}, threading.Lock()

    def client(i):
        h = srv.submit(prompts[i % len(prompts)], max_new=MAX_NEW)
        r = h.result(timeout=60)
        with lock:
            results[h.uid] = (i % len(prompts), r)

    with _server(eng) as srv:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert len(results) == 8
    for pi, r in results.values():
        assert r.state == "DONE"
        np.testing.assert_array_equal(r.tokens, base[pi])


def test_cancel_mid_flight_and_deadline(setup):
    eng, _, prompts, base = setup
    with _server(eng) as srv:
        h = srv.submit(prompts[0], max_new=40)
        for i, _tok in enumerate(h.stream()):
            if i == 2:
                h.cancel()
        r = h.result(timeout=60)
        late = srv.submit(prompts[1], max_new=MAX_NEW, deadline_s=0.0)
        rl = late.result(timeout=60)
    assert r.state == "CANCELLED" and 1 <= r.gen_len < 40
    np.testing.assert_array_equal(r.tokens, base[0][:min(r.gen_len, MAX_NEW)])
    assert rl.state == "TIMEOUT" and rl.gen_len == 0


def test_rejection_resolves_with_reason(setup):
    eng, _, prompts, base = setup
    with _server(eng) as srv:
        h = srv.submit(prompts[0], max_new=10 ** 6)   # cannot fit max_len
        r = h.result(timeout=60)
        ok = srv.submit(prompts[2], max_new=MAX_NEW).result(timeout=60)
    assert r.state == "REJECTED" and r.gen_len == 0
    assert "does not fit" in h.reject_reason
    assert ok.state == "DONE"
    np.testing.assert_array_equal(ok.tokens, base[2])


def test_priority_orders_admission(setup):
    """One slot and a backlog: the high-priority request submitted after
    four low-priority ones is admitted before the part of the backlog that
    was still queued."""
    eng, _, prompts, base = setup
    srv = OnlineServer(ContinuousBatchingScheduler(eng, max_slots=1))
    with srv:
        low = [srv.submit(prompts[i % len(prompts)], max_new=MAX_NEW,
                          priority=0) for i in range(4)]
        high = srv.submit(prompts[1], max_new=MAX_NEW, priority=3)
        rh = high.result(timeout=60)
        rl = [h.result(timeout=60) for h in low]
    assert rh.state == "DONE"
    np.testing.assert_array_equal(rh.tokens, base[1])
    assert [r for r in rl if r.admitted_s > rh.admitted_s], \
        "high-priority request did not overtake the backlog"


def test_stop_without_drain_cancels_outstanding(setup):
    eng, _, prompts, _ = setup
    srv = _server(eng).start()
    handles = [srv.submit(prompts[i % len(prompts)], max_new=40)
               for i in range(6)]
    srv.stop(drain=False)
    states = {h.result(timeout=60).state for h in handles}
    assert states <= {"CANCELLED", "DONE"} and "CANCELLED" in states
    with pytest.raises(ServerClosed):
        srv.submit(prompts[0])


def test_watchdog_detects_wedged_step_and_recovers(setup):
    _, paged, prompts, base = setup
    inj = FaultInjector(FaultPlan(step_stall_at=2, step_stall_s=1.0), seed=0)
    sched = ContinuousBatchingScheduler(paged, max_slots=2, faults=inj)
    srv = OnlineServer(sched, watchdog_s=0.2)
    with srv:
        handles = [srv.submit(p, max_new=MAX_NEW) for p in prompts[:2]]
        results = [h.result(timeout=120.0) for h in handles]
    assert inj.fired("step_stall") == 1
    stats = srv.stats()
    assert stats["watchdog_trips"] >= 1 and stats["recoveries"] >= 1
    assert stats["last_recovery_s"] >= 0.0 and stats["outstanding"] == 0
    assert any(e["event"] == "recover" and "watchdog" in e["reason"]
               for e in sched.recovery_log)
    for r, b in zip(results, base[:2]):
        assert r.state == "DONE"
        np.testing.assert_array_equal(r.tokens, b)
    pool = paged._pager.pool
    assert (pool.pages_in_use, pool.total_reserved) == (0, 0)
