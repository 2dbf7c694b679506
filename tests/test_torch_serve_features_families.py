"""The float ServeEngine's KV-cache features on the families whose caches do
not all page, against the JAX package's ServeEngine on the same weights.

Reduced gemma2-27b (16-token window, so with ``max_len`` 64 the local
layers keep slot-private rings beside the paged global layers): prefix
sharing is a no-op (a ring cannot be restored from a shared page), chunked
prefill takes the per-token decode steps (a ring is not a linear cache),
and an int8 / fp8 pool quantizes the global layers' pages only.  Reduced
rwkv6-7b: the recurrent state never pages, chunks run the per-token steps,
and a quantized pool is refused.  Reduced phi3.5-moe-42b-a6.6b and the
top-8 MoE override (16 experts, GQA 16/1): every cache leaf pages, so
prefix sharing, copy-on-write and chunked prefill through the block chunk
path are live, on 4 slots so that the MoE's capacity couples the decode
rows; and one preemption with a device loss.  Tokens, ``cached_tokens``,
page tables, ``cache_stats``, meters (and for the faults the recovery log
and the injector's events) identical to the reference
(``use_pallas=True``, Auto-axis mesh).
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")   # the parity tests need the JAX package

from jax.sharding import AxisType

from repro.configs import get_config
from repro.configs.base import MoEConfig as JMoE
from repro.models import api as japi
from repro.serve import faults as jfaults
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.scheduler import ContinuousBatchingScheduler as JScheduler
from repro.serve.scheduler import Request as JRequest
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs.base import MoEConfig
from repro_torch.models.api import params_from_numpy
from repro_torch.serve import faults
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import ContinuousBatchingScheduler, Request
from torch_cases import feature_prompts, serve_staged

MAX_LEN, MAX_NEW = 64, 4
_SETUPS = {}


# the top-8 MoE override: qwen's routing shape, a GQA group of 16
TOP8 = "qwen3-moe-235b-a22b-top8"


def _configs(arch):
    if arch == TOP8:
        kw = dict(num_heads=16, num_kv_heads=1)
        return (get_config("qwen3-moe-235b-a22b").reduced(
                    moe=JMoE(16, 8), **kw),
                t_get_config("qwen3-moe-235b-a22b").reduced(
                    moe=MoEConfig(16, 8), **kw))
    return get_config(arch).reduced(), t_get_config(arch).reduced()


def setup_for(arch):
    if arch not in _SETUPS:
        jcfg, tcfg = _configs(arch)
        cfg = dataclasses.replace(jcfg, use_pallas=True)
        params = jax.jit(japi.init_params, static_argnums=0)(
            cfg, jax.random.PRNGKey(0))
        mesh = jax.make_mesh((1, 1), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        prompts = feature_prompts(cfg.vocab_size)
        # past the reduced 16-token window: the rings wrap while prefilling
        prompts[0] = np.concatenate([prompts[0], prompts[-1]])
        _SETUPS[arch] = dict(
            cfg=cfg, tcfg=tcfg, params=params,
            tparams=params_from_numpy(jax.tree.map(np.asarray, params),
                                      "cpu"),
            mesh=mesh, prompts=prompts)
    return _SETUPS[arch]


def _requests(cls, prompts):
    return [cls(uid=i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(prompts)]


CASES = {
    "gemma2-bf16-prefix-chunk-inplace": ("gemma2-27b", 8, dict(
        page_size=8, prefix_cache="on")),
    "gemma2-int8-prefix-chunk-gather": ("gemma2-27b", 8, dict(
        page_size=8, prefix_cache="on", kv_dtype="int8",
        paged_attn="gather")),
    "gemma2-fp8-block-inplace": ("gemma2-27b", None, dict(
        page_size=8, kv_dtype="fp8")),
    "rwkv-prefix-chunk": ("rwkv6-7b", 8, dict(page_size=8,
                                             prefix_cache="on")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_features_match_reference(case):
    arch, chunk, kw = CASES[case]
    s = setup_for(arch)
    ref = JEngine(s["cfg"], s["params"], mesh=s["mesh"], max_len=MAX_LEN,
                  **kw)
    ours = ServeEngine(s["tcfg"], s["tparams"], max_len=MAX_LEN,
                       device="cpu", **kw)
    scheds = [JScheduler(ref, max_slots=2, prefill_chunk=chunk),
              ContinuousBatchingScheduler(ours, max_slots=2,
                                          prefill_chunk=chunk)]
    paged = arch != "rwkv6-7b"

    def tables(it):
        if paged:
            np.testing.assert_array_equal(ref._pager.pool.table,
                                          ours._pager.pool.table,
                                          err_msg=f"iteration {it}")

    rr, tr = serve_staged(scheds, [_requests(JRequest, s["prompts"]),
                                   _requests(Request, s["prompts"])], tables)
    assert [r.state for r in tr] == ["DONE"] * len(rr)
    assert [r.tokens.tolist() for r in tr] == [r.tokens.tolist() for r in rr]
    assert [r.cached_tokens for r in tr] == [0] * len(tr)
    assert [r.cached_tokens for r in rr] == [0] * len(rr)
    assert ours.meter.log == ref.meter.log
    assert ours.meter.host_log == ref.meter.host_log
    assert (ours.cache_stats(scheds[1].cache)
            == ref.cache_stats(scheds[0].cache))
    assert not ours.prefix_sharing_active()
    assert ours.prefix_cache_armed() == (kw.get("prefix_cache") == "on")


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_rwkv_refuses_a_quantized_pool(kv_dtype):
    """rwkv's cache never pages, so there is no pool to quantize: with a
    page size the slot cache refuses, without one the constructor does, as
    in the JAX package."""
    s = setup_for("rwkv6-7b")
    for make in (lambda **kw: JEngine(s["cfg"], s["params"], mesh=s["mesh"],
                                      max_len=MAX_LEN, **kw),
                 lambda **kw: ServeEngine(s["tcfg"], s["tparams"],
                                          max_len=MAX_LEN, device="cpu",
                                          **kw)):
        eng = make(page_size=8, kv_dtype=kv_dtype)
        with pytest.raises(ValueError, match="paging family"):
            eng.init_slot_cache(2)
        with pytest.raises(ValueError, match="page_size"):
            make(kv_dtype=kv_dtype)


MOE_CASES = {
    "phi-bf16-prefix-chunk-inplace": ("phi3.5-moe-42b-a6.6b", 8, dict(
        page_size=8, prefix_cache="on")),
    "phi-int8-prefix-chunk-gather": ("phi3.5-moe-42b-a6.6b", 8, dict(
        page_size=8, prefix_cache="on", kv_dtype="int8",
        paged_attn="gather")),
    "phi-fp8-prefix-block-inplace": ("phi3.5-moe-42b-a6.6b", None, dict(
        page_size=8, prefix_cache="on", kv_dtype="fp8")),
    "phi-dense-chunk": ("phi3.5-moe-42b-a6.6b", 8, {}),
    "top8-bf16-prefix-chunk-inplace": (TOP8, 8, dict(page_size=8,
                                                     prefix_cache="on")),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_features_match_reference(case):
    arch, chunk, kw = MOE_CASES[case]
    s = setup_for(arch)
    ref = JEngine(s["cfg"], s["params"], mesh=s["mesh"], max_len=MAX_LEN,
                  **kw)
    ours = ServeEngine(s["tcfg"], s["tparams"], max_len=MAX_LEN,
                       device="cpu", **kw)
    scheds = [JScheduler(ref, max_slots=4, prefill_chunk=chunk),
              ContinuousBatchingScheduler(ours, max_slots=4,
                                          prefill_chunk=chunk)]

    def tables(it):
        if kw.get("page_size"):
            np.testing.assert_array_equal(ref._pager.pool.table,
                                          ours._pager.pool.table,
                                          err_msg=f"iteration {it}")

    rr, tr = serve_staged(scheds, [_requests(JRequest, s["prompts"]),
                                   _requests(Request, s["prompts"])], tables)
    assert [r.state for r in tr] == ["DONE"] * len(rr)
    assert [r.tokens.tolist() for r in tr] == [r.tokens.tolist() for r in rr]
    assert [r.cached_tokens for r in tr] == [r.cached_tokens for r in rr]
    assert ours.meter.log == ref.meter.log
    assert ours.meter.host_log == ref.meter.host_log
    assert (ours.cache_stats(scheds[1].cache)
            == ref.cache_stats(scheds[0].cache))
    if kw.get("prefix_cache") == "on":
        # every MoE cache leaf pages: the whole-body hits share pages
        assert ours.prefix_sharing_active()
        assert max(r.cached_tokens for r in tr) >= 15


def test_moe_preemption_with_device_loss_matches_reference():
    """Two slots of reduced phi3.5-moe on a prefix-armed pool with chunked
    prefill: a priority-5 request arrives while two priority-0 requests
    decode and evicts one, then the device is lost at iteration 9.  The
    victim's resume re-prefills its prompt and tokens (other rows than its
    uninterrupted decode, so the MoE may route it otherwise than an
    uninterrupted run): every result, the recovery log and the injector's
    events equal the reference's."""
    s = setup_for("phi3.5-moe-42b-a6.6b")
    prompts = s["prompts"][:2] + [s["prompts"][-1]]
    kw = dict(max_len=MAX_LEN, page_size=8, prefix_cache="on")
    out = []
    for eng, sched_cls, req_cls, mod in (
            (JEngine(s["cfg"], s["params"], mesh=s["mesh"], **kw),
             JScheduler, JRequest, jfaults),
            (ServeEngine(s["tcfg"], s["tparams"], device="cpu", **kw),
             ContinuousBatchingScheduler, Request, faults)):
        inj = mod.FaultInjector(mod.FaultPlan(device_loss_at=9), seed=0)
        sched = sched_cls(eng, max_slots=2, preemption=True, backoff_steps=1,
                          prefill_chunk=8, faults=inj)
        sched.begin()
        for i in range(2):
            sched.submit(req_cls(uid=i, prompt=prompts[i], max_new=MAX_NEW,
                                 priority=0))
        for _ in range(4):
            sched.step()
        sched.submit(req_cls(uid=2, prompt=prompts[2], max_new=MAX_NEW,
                             priority=5))
        for _ in range(300):
            sched.step()
            if not sched.has_work():
                break
        res = sorted(sched.poll(), key=lambda r: r.uid)
        out.append(([(r.uid, r.state, r.tokens.tolist(), r.gen_len,
                      r.preemptions, r.cached_tokens) for r in res],
                    [(e["event"], e.get("uid"), e["iteration"])
                     for e in sched.recovery_log], list(inj.events)))
        pool = eng._pager.pool
        assert (pool.pages_in_use, pool.total_reserved,
                pool.total_drawn) == (0, 0, 0)
    assert out[1] == out[0]
    res, log, events = out[1]
    assert [r[1] for r in res] == ["DONE"] * 3
    assert sum(r[4] for r in res) >= 1
    assert [e[0] for e in events] == ["device_loss"]
    assert [e[0] for e in log].count("recover") == 1
