"""Cancellation, SLA-aware preemption and recovery across the model
families, on the port's scheduler and engines against the JAX package's on
the same weights (an Auto-axis mesh; the JAX package's own
``tests/test_preemption.py`` and ``tests/test_recovery.py`` cannot build
its engines on the installed JAX).

The family matrix of those files: stablelm-1.6b (dense KV), gemma2-27b
(sliding-window rings), hymba-1.5b (attention ring + SSM state), rwkv6-7b
(recurrent state only) and the split-brain engine (reduced tinyllama, paged
and prefix-armed with 4-token pages and chunked prefill, so a resumed
victim re-admits through the prefix cache).  Each scenario runs on both
packages' schedulers; every result (uid, state, tokens, ``gen_len``,
preemptions, cached tokens) must be equal, and the greedy tokens equal to
the reference engine's ``generate()`` of each prompt alone."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")   # the parity tests need the JAX package

from jax.sharding import AxisType

from repro.configs import get_config
from repro.models import api as japi
from repro.serve import faults as jfaults
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.scheduler import ContinuousBatchingScheduler as JScheduler
from repro.serve.scheduler import Request as JRequest
from repro.serve.splitbrain_engine import SplitBrainEngine as JSplitBrain
from repro_torch.configs import get_config as t_get_config
from repro_torch.models.api import params_from_numpy
from repro_torch.serve import faults
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import ContinuousBatchingScheduler, Request
from repro_torch.serve.splitbrain_engine import SplitBrainEngine

MAX_NEW = 6
FAMILIES = ["stablelm-1.6b", "gemma2-27b", "hymba-1.5b", "rwkv6-7b",
            "splitbrain"]
_BUILT = {}


def _build(arch):
    """((reference engine, port engine), prefill_chunk, reference baseline
    of a prompt), one build per arch for the whole file."""
    if arch in _BUILT:
        return _BUILT[arch]
    name = "tinyllama-1.1b" if arch == "splitbrain" else arch
    cfg = get_config(name).reduced()
    cfg = dataclasses.replace(
        cfg, use_pallas=True,
        parallel=dataclasses.replace(cfg.parallel, remat="none"))
    params = jax.jit(japi.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    tcfg = t_get_config(name).reduced()
    if arch == "splitbrain":
        kw = dict(max_len=32, quantize=False, page_size=4, num_pages=17,
                  prefix_cache="on")
        engines = (JSplitBrain(cfg, params, mesh=mesh, **kw),
                   SplitBrainEngine(tcfg, tparams, device="cpu", **kw))
        chunk = 4
    else:
        engines = (JEngine(cfg, params, mesh=mesh, max_len=32),
                   ServeEngine(tcfg, tparams, max_len=32, device="cpu"))
        chunk = None
    cache = {}

    def base(prompt):
        key = tuple(prompt.tolist())
        if key not in cache:
            cache[key] = np.asarray(engines[0].generate(
                prompt[None, :], max_new=MAX_NEW)["tokens"][0]).tolist()
        return cache[key]

    _BUILT[arch] = (engines, chunk, base)
    return _BUILT[arch]


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, (t,)).astype(np.int32) for t in lens]


def _both(arch):
    engines, chunk, base = _build(arch)
    return zip(engines, (JScheduler, ContinuousBatchingScheduler),
               (JRequest, Request), (jfaults, faults)), chunk, base


def _summary(results):
    return [(r.uid, r.state, r.tokens.tolist(), r.gen_len, r.preemptions,
             r.cached_tokens) for r in sorted(results, key=lambda r: r.uid)]


def _preempt_scenario(arch, plan=None):
    """One slot: a priority-0 victim decodes for three iterations, then a
    priority-5 request arrives and evicts it; with ``plan`` a fault
    injector rides along.  Returns, per package, (results, recovery log,
    injector events)."""
    both, chunk, base = _both(arch)
    p0, p1 = _prompts((5, 6))
    out = []
    for eng, sched_cls, req_cls, mod in both:
        inj = None if plan is None else mod.FaultInjector(
            mod.FaultPlan(**plan), seed=0)
        sched = sched_cls(eng, max_slots=1, preemption=True, backoff_steps=1,
                          prefill_chunk=chunk, faults=inj)
        sched.begin()
        sched.submit(req_cls(uid=0, prompt=p0, max_new=MAX_NEW, priority=0))
        for _ in range(3):
            sched.step()
        assert sched.decoding_uids() == [0]      # the victim is mid-decode
        sched.submit(req_cls(uid=1, prompt=p1, max_new=MAX_NEW, priority=5))
        for _ in range(300):
            sched.step()
            if not sched.has_work():
                break
        assert not sched.poll_rejected()
        out.append((_summary(sched.poll()),
                    [(e["event"], e.get("uid"), e["iteration"])
                     for e in sched.recovery_log],
                    [] if inj is None else list(inj.events)))
        if getattr(eng, "_pager", None) is not None:
            pool = eng._pager.pool
            assert (pool.pages_in_use, pool.total_reserved,
                    pool.total_drawn) == (0, 0, 0)
    assert out[1] == out[0]
    res = out[1][0]
    assert res[0][1] == res[1][1] == "DONE"
    assert res[0][4] >= 1 and res[1][4] == 0
    assert res[0][2] == base(p0) and res[1][2] == base(p1)
    return out[1]


@pytest.mark.parametrize("arch", FAMILIES)
def test_preempted_and_resumed_matches_uninterrupted(arch):
    res, _, _ = _preempt_scenario(arch)
    if arch == "splitbrain":
        # eviction published the victim's full pages: the resume radix-
        # matched them instead of re-prefilling from scratch
        assert res[0][5] > 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_preempted_then_device_loss_token_identical(arch):
    """The victim is preempted AND then survives a wholesale device loss:
    the same events at the same iterations, and the uninterrupted tokens."""
    _, log, events = _preempt_scenario(arch, dict(device_loss_at=8))
    assert [e[0] for e in events] == ["device_loss"]
    assert [e[0] for e in log].count("recover") == 1


@pytest.mark.parametrize("arch", FAMILIES)
def test_non_preempted_identical_with_preemption_on_vs_off(arch):
    """Mixed priorities over two slots with preemption armed and disarmed:
    nothing is evicted, so the flag is a no-op and every request has its
    fused-baseline tokens."""
    both, chunk, base = _both(arch)
    prompts = _prompts((4, 6, 3, 5), seed=1)
    runs = []
    for eng, sched_cls, req_cls, _ in both:
        for preemption in (False, True):
            sched = sched_cls(eng, max_slots=2, preemption=preemption,
                              prefill_chunk=chunk)
            out = sched.run([req_cls(uid=i, prompt=p, max_new=MAX_NEW,
                                     priority=i % 2)
                             for i, p in enumerate(prompts)])
            assert not out["rejected"] and out["preemptions"] == 0
            runs.append(_summary(out["results"]))
    assert runs[1] == runs[2] == runs[3] == runs[0]
    assert [r[2] for r in runs[3]] == [base(p) for p in prompts]


@pytest.mark.parametrize("arch", FAMILIES)
def test_mid_decode_cancellation_leaves_others_token_identical(arch):
    """Cancel one of three streams mid-decode: it ends CANCELLED within one
    iteration with a greedy prefix of its output (its pages back in the
    pool that iteration on a paged engine), the others keep their tokens."""
    both, chunk, base = _both(arch)
    prompts = _prompts((5, 4, 6), seed=2)
    out = []
    for eng, sched_cls, req_cls, _ in both:
        sched = sched_cls(eng, max_slots=3, prefill_chunk=chunk)
        sched.begin()
        for i, p in enumerate(prompts):
            sched.submit(req_cls(uid=i, prompt=p, max_new=MAX_NEW))
        for _ in range(20):
            sched.step()
            if 1 in sched.decoding_uids():
                break
        mid = eng.cache_stats(sched.cache)
        sched.cancel(1)
        fin = sched.step()
        assert [r.state for r in fin if r.uid == 1] == ["CANCELLED"]
        if "pages_in_use" in mid:
            assert (eng.cache_stats(sched.cache)["pages_in_use"]
                    < mid["pages_in_use"])
        for _ in range(200):
            sched.step()
            if not sched.has_work():
                break
        out.append(_summary(fin + sched.poll()))
    assert out[1] == out[0]
    res = {r[0]: r for r in out[1]}
    assert res[0][2] == base(prompts[0]) and res[2][2] == base(prompts[2])
    g = res[1][3]
    assert 1 <= g < MAX_NEW and res[1][2] == base(prompts[1])[:g]
