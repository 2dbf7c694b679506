"""Seeded fault injection on the port's scheduler and ServeEngine, against
the JAX package's scheduler, ServeEngine and ``repro.serve.faults`` on the
same weights: the port's ``serve/faults.py`` is a copy, so a (plan, seed)
pair must fire the same events at the same iterations, and the loop must
absorb them the same way.

Reduced stablelm-1.6b on a paged, prefix-armed pool (max_len 32, page 4,
33 pages), the reference's ServeEngine on an Auto-axis mesh (its own
``tests/test_faults.py`` and ``tests/test_recovery.py`` cannot build the
engine on the installed JAX).  Every fault point: admission (a budget and
a Bernoulli rate), pool_squeeze, prefill errors (targeted and by rate),
prefill stalls (by rate, and one reaped by its deadline), cancel_burst
(armed before anything decodes, and mid-decode), step_error, step_corrupt
(transient, and persistent to FAILED), device_loss and step_stall.  Held
equal, exactly: every result's state, tokens, ``gen_len``, preemptions and
cached tokens; the rejected uids and reasons; the recovery log's events,
uids, iterations, strikes and requeue counts; ``injector.events``; the
scheduler's counters; and the pool back to empty.  The copied error
hierarchy and disciplines registry are held equal to the JAX package's.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")   # the parity tests need the JAX package

from jax.sharding import AxisType

from repro.configs import get_config
from repro.models import api as japi
from repro.serve import disciplines as jdisciplines
from repro.serve import errors as jerrors
from repro.serve import faults as jfaults
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.scheduler import ContinuousBatchingScheduler as JScheduler
from repro.serve.scheduler import Request as JRequest
from repro_torch.configs import get_config as t_get_config
from repro_torch.models.api import params_from_numpy
from repro_torch.serve import disciplines, errors, faults
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.errors import InjectedFault, SchedulerError
from repro_torch.serve.scheduler import ContinuousBatchingScheduler, Request

MAX_NEW = 6
LENS = (5, 9, 4, 7)

# name -> (FaultPlan fields, scheduler kwargs, max_new, prompts used, the
# events that must fire)
CASES = {
    "prefill_error": (dict(prefill_error_uids=(1,)),
                      dict(max_slots=2, prefill_chunk=4), MAX_NEW, 4,
                      ("prefill_fault",)),
    "prefill_error_rate": (dict(prefill_error_rate=0.3),
                           dict(max_slots=2, prefill_chunk=4), MAX_NEW, 4,
                           ("prefill_fault",)),
    "admission": (dict(admission_failures=3), dict(max_slots=2), MAX_NEW, 4,
                  ("admission_fault",)),
    "admission_rate": (dict(admission_fail_rate=0.4), dict(max_slots=2),
                       MAX_NEW, 4, ("admission_fault",)),
    "pool_squeeze": (dict(pool_squeeze_at=1, pool_squeeze_iters=10),
                     dict(max_slots=2), MAX_NEW, 4, ("pool_squeeze",)),
    "stall_rate": (dict(stall_rate=0.5, stall_iters=3),
                   dict(max_slots=2, prefill_chunk=4), MAX_NEW, 4,
                   ("stall",)),
    "cancel_burst": (dict(cancel_burst_at=6, cancel_burst_frac=0.5),
                     dict(max_slots=4), 16, 4, ("cancel_burst",)),
    "cancel_burst_deferred": (dict(cancel_burst_at=0, cancel_burst_frac=1.0),
                              dict(max_slots=2), MAX_NEW, 2,
                              ("cancel_burst",)),
    "step_error": (dict(step_error_at=3, step_error_count=2),
                   dict(max_slots=2, prefill_chunk=4), MAX_NEW, 4,
                   ("step_error",)),
    "step_corrupt_transient": (dict(step_corrupt_at=4, step_corrupt_iters=2,
                                    step_corrupt_frac=0.5),
                               dict(max_slots=4), MAX_NEW, 4,
                               ("step_corrupt",)),
    "step_corrupt_persistent": (dict(step_corrupt_at=0,
                                     step_corrupt_iters=10 ** 9,
                                     step_corrupt_uids=(1,)),
                                dict(max_slots=4, max_strikes=3), MAX_NEW, 4,
                                ("step_corrupt",)),
    "device_loss": (dict(device_loss_at=6),
                    dict(max_slots=2, prefill_chunk=4), MAX_NEW, 4,
                    ("device_loss",)),
    "step_stall": (dict(step_stall_at=2, step_stall_s=0.01),
                   dict(max_slots=2), MAX_NEW, 4, ("step_stall",)),
}


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
    kw = dict(max_len=32, page_size=4, num_pages=33, prefix_cache="on")
    ref = JEngine(cfg, params, mesh=mesh, **kw)
    ours = ServeEngine(t_get_config("stablelm-1.6b").reduced(),
                       params_from_numpy(jax.tree.map(np.asarray, params),
                                         "cpu"), device="cpu", **kw)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, (t,)).astype(np.int32)
               for t in LENS]
    return ref, ours, prompts


def _pool(eng):
    pool = eng._pager.pool
    return (pool.pages_in_use, pool.total_reserved, pool.total_drawn)


def _serve(eng, sched_cls, req_cls, inj, prompts, max_new, deadlines=None,
           **sched_kw):
    sched = sched_cls(eng, faults=inj, **sched_kw)
    reqs = [req_cls(uid=i, prompt=p, max_new=max_new,
                    deadline_s=None if deadlines is None else deadlines[i])
            for i, p in enumerate(prompts)]
    out = sched.run(reqs)
    assert _pool(eng) == (0, 0, 0), "pages stranded"
    return {
        "results": [(r.uid, r.state, r.tokens.tolist(), r.gen_len,
                     r.preemptions, r.cached_tokens) for r in out["results"]],
        "rejected": [(r.uid, r.reason) for r in out["rejected"]],
        "log": [{k: v for k, v in e.items() if k != "recovery_s"}
                for e in sched.recovery_log],
        "events": list(inj.events),
        "counters": {k: out[k] for k in (
            "steps", "iterations", "decoded_tokens", "prefill_tokens",
            "cached_prompt_tokens", "preemptions", "quarantines", "failed",
            "recoveries", "by_state")},
    }


@pytest.mark.parametrize("case", sorted(CASES))
def test_fault_point_matches_reference(setup, case):
    ref, ours, prompts = setup
    plan, sched_kw, max_new, n, fired = CASES[case]
    runs = []
    for eng, mod, sched_cls, req_cls in (
            (ref, jfaults, JScheduler, JRequest),
            (ours, faults, ContinuousBatchingScheduler, Request)):
        inj = mod.FaultInjector(mod.FaultPlan(**plan), seed=0)
        runs.append(_serve(eng, sched_cls, req_cls, inj, prompts[:n],
                           max_new, **sched_kw))
        for kind in fired:
            assert inj.fired(kind) > 0, f"{kind} never fired"
    assert runs[1] == runs[0]
    res = {r[0]: r for r in runs[1]["results"]}
    states = set(r[1] for r in runs[1]["results"])
    if case == "step_corrupt_persistent":
        assert res[1][1] == "FAILED" and res[1][3] == 0
        assert runs[1]["counters"]["quarantines"] == 3
    else:
        assert "FAILED" not in states
    if case in ("cancel_burst", "cancel_burst_deferred"):
        assert "CANCELLED" in states
    if case.startswith("prefill_error"):
        assert runs[1]["rejected"] and all(
            "injected" in reason for _, reason in runs[1]["rejected"])
    if case in ("step_error", "device_loss"):
        assert runs[1]["counters"]["recoveries"] == (2 if case == "step_error"
                                                     else 1)


def test_fault_free_tokens_equal_faulted_survivors(setup):
    """The recovered and quarantined requests of the faulted runs are
    token-identical to a fault-free run of the same requests."""
    ref, ours, prompts = setup
    clean = _serve(ours, ContinuousBatchingScheduler, Request,
                   faults.FaultInjector(faults.FaultPlan(), seed=0), prompts,
                   MAX_NEW, max_slots=2, prefill_chunk=4)
    base = {r[0]: r[2] for r in clean["results"]}
    for case in ("device_loss", "step_error", "step_corrupt_transient"):
        plan, sched_kw, max_new, n, _ = CASES[case]
        got = _serve(ours, ContinuousBatchingScheduler, Request,
                     faults.FaultInjector(faults.FaultPlan(**plan), seed=0),
                     prompts[:n], max_new, **sched_kw)
        for uid, state, toks, *_ in got["results"]:
            assert state == "DONE" and toks == base[uid], (case, uid)


def test_pool_empty_after_every_step_error_recovery(setup):
    """Two consecutive step errors: the pool is empty the instant each
    recovering iteration ends (reserved pages and radix refcounts died with
    the pool), and the drained run serves everything."""
    _, ours, prompts = setup
    inj = faults.FaultInjector(
        faults.FaultPlan(step_error_at=3, step_error_count=2), seed=0)
    sched = ContinuousBatchingScheduler(ours, max_slots=2, prefill_chunk=4,
                                        faults=inj)
    sched.begin()
    for i, p in enumerate(prompts):
        sched.submit(Request(uid=i, prompt=p, max_new=MAX_NEW))
    seen = 0
    for _ in range(500):
        sched.step()
        if sched._recoveries > seen:
            seen = sched._recoveries
            assert _pool(ours) == (0, 0, 0), "pages survived the rebuild"
        if not sched.has_work():
            break
    assert seen == 2 and inj.fired("step_error") == 2
    assert [r.state for r in sched.poll()] == ["DONE"] * len(prompts)


def test_stalled_prefill_reaped_by_deadline(setup):
    """A prefill whose chunks are withheld forever is reaped by its 0.25 s
    deadline as TIMEOUT on both packages (wall-clock, so iterations are not
    compared); the other request is served with the reference's tokens."""
    ref, ours, prompts = setup
    out = []
    for eng, mod, sched_cls, req_cls in (
            (ref, jfaults, JScheduler, JRequest),
            (ours, faults, ContinuousBatchingScheduler, Request)):
        inj = mod.FaultInjector(mod.FaultPlan(stall_uids=(0,),
                                              stall_iters=10 ** 9), seed=0)
        run = _serve(eng, sched_cls, req_cls, inj, prompts[1:3], MAX_NEW,
                     deadlines=[0.25, None], max_slots=2, prefill_chunk=4)
        assert inj.fired("stall") == 1
        out.append(run["results"])
    assert [r[1] for r in out[1]] == ["TIMEOUT", "DONE"]
    assert out[1][0][3] == 0 and out[1][1][2] == out[0][1][2]


def test_unknown_exception_propagates_after_cleanup(setup):
    """InjectedFault is a SchedulerError the loop absorbs; an exception of
    another type propagates, after the slot and pages are released."""
    _, ours, prompts = setup
    assert issubclass(InjectedFault, SchedulerError)

    class Hostile:
        plan = faults.FaultPlan()

        def on_step(self, sched):
            pass

        def admission_fault(self, uid):
            return False

        def prefill_fault(self, uid):
            raise RuntimeError("not a SchedulerError")

        def prefill_stalled(self, uid):
            return False

    sched = ContinuousBatchingScheduler(ours, max_slots=2, prefill_chunk=4,
                                        faults=Hostile())
    sched.begin()
    sched.submit(Request(uid=0, prompt=prompts[1], max_new=MAX_NEW))
    with pytest.raises(RuntimeError, match="not a SchedulerError"):
        for _ in range(50):
            sched.step()
    assert _pool(ours) == (0, 0, 0)


def test_fault_plan_fields_errors_and_disciplines_equal_reference():
    """The copies: FaultPlan's fields with their defaults, the error
    hierarchy (every class and its bases, by name), and the disciplines
    registry with its README table."""
    def hierarchy(mod):
        return {n: [b.__name__ for b in c.__mro__]
                for n, c in vars(mod).items()
                if isinstance(c, type) and issubclass(c, Exception)}

    assert hierarchy(errors) == hierarchy(jerrors)
    assert issubclass(errors.DeviceLost, errors.DeviceError)
    assert ([(f.name, f.default) for f in
             dataclasses.fields(faults.FaultPlan)]
            == [(f.name, f.default) for f in
                dataclasses.fields(jfaults.FaultPlan)])
    assert ([dataclasses.astuple(d) for d in disciplines.DISCIPLINES]
            == [dataclasses.astuple(d) for d in jdisciplines.DISCIPLINES])
    assert disciplines.NAMES == jdisciplines.NAMES
    assert disciplines.markdown_table() == jdisciplines.markdown_table()
