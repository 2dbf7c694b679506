"""The float ServeEngine's KV-cache features against the JAX package's
ServeEngine on the same weights: chunked prefill, the gather discipline,
shared-prefix copy-on-write pages and int8 / fp8 page pools, alone and
combined, on reduced llama2-7b (d_model 64, 4 heads of 16, 2 layers, vocab
256), ``max_len`` 64, pages of 8, chunks of 8, two slots.

Each case serves ``torch_cases.feature_prompts`` (a shared two-page prefix:
partial hits, whole-body hits, one copy-on-write copy) through each
package's scheduler in lockstep, the first request alone until it decodes.
Greedy tokens, ``cached_tokens`` and the page tables (after every
iteration) must be identical to the reference built with ``use_pallas=True``
on an Auto-axis mesh, and so must ``cache_stats`` (pages stored and in use,
prefix hits, CoW copies, pool bytes and bytes per stored token) and every
meter channel: the eq. 7-10 boundary log and the host channels
``kv_cache_read``, ``prefix_prefill_saved`` and ``page_cow_copy``.
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
from repro_torch.models.api import params_from_numpy
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import ContinuousBatchingScheduler, Request
from torch_cases import feature_prompts, serve_staged

ARCH = "llama2-7b"
MAX_LEN, PAGE, MAX_NEW = 64, 8, 4


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(get_config(ARCH).reduced(), use_pallas=True)
    params = jax.jit(japi.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return dict(cfg=cfg, tcfg=t_get_config(ARCH).reduced(), params=params,
                tparams=tparams, mesh=mesh,
                prompts=feature_prompts(cfg.vocab_size))


def _requests(cls, prompts):
    return [cls(uid=i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(prompts)]


def serve_both(s, chunk, **kw):
    """(reference results, port results, reference engine, port engine),
    served in lockstep with the page tables compared after every
    iteration."""
    ref = JEngine(s["cfg"], s["params"], mesh=s["mesh"], max_len=MAX_LEN,
                  **kw)
    ours = ServeEngine(s["tcfg"], s["tparams"], max_len=MAX_LEN,
                       device="cpu", **kw)
    scheds = [JScheduler(ref, max_slots=2, prefill_chunk=chunk),
              ContinuousBatchingScheduler(ours, max_slots=2,
                                          prefill_chunk=chunk)]

    def tables(it):
        if kw.get("page_size"):
            np.testing.assert_array_equal(ref._pager.pool.table,
                                          ours._pager.pool.table,
                                          err_msg=f"iteration {it}")

    rr, tr = serve_staged(scheds, [_requests(JRequest, s["prompts"]),
                                   _requests(Request, s["prompts"])], tables)
    return rr, tr, (ref, scheds[0]), (ours, scheds[1])


def assert_same_service(rr, tr, ref, ours):
    assert [r.state for r in tr] == ["DONE"] * len(rr)
    assert [r.tokens.tolist() for r in tr] == [r.tokens.tolist() for r in rr]
    assert [r.cached_tokens for r in tr] == [r.cached_tokens for r in rr]
    (reng, rs), (oeng, os_) = ref, ours
    assert oeng.meter.log == reng.meter.log
    assert oeng.meter.host_log == reng.meter.host_log
    assert oeng.cache_stats(os_.cache) == reng.cache_stats(rs.cache)
    assert (oeng.gather_transient_bytes_per_step()
            == reng.gather_transient_bytes_per_step())


CASES = {
    "bf16-prefix-chunk-inplace": (8, dict(prefix_cache="on")),
    "int8-prefix-chunk-inplace": (8, dict(prefix_cache="on",
                                          kv_dtype="int8")),
    "fp8-prefix-chunk-gather": (8, dict(prefix_cache="on", kv_dtype="fp8",
                                        paged_attn="gather")),
    "int8-chunk-gather": (8, dict(kv_dtype="int8", paged_attn="gather")),
    "fp8-prefix-block-inplace": (None, dict(prefix_cache="on",
                                            kv_dtype="fp8")),
    "int8-block-gather": (None, dict(kv_dtype="int8", paged_attn="gather")),
    "bf16-prefix-block-gather": (None, dict(prefix_cache="on",
                                            paged_attn="gather")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_features_match_reference(setup, case):
    chunk, kw = CASES[case]
    rr, tr, ref, ours = serve_both(setup, chunk, page_size=PAGE, **kw)
    assert_same_service(rr, tr, ref, ours)
    stats = ours[0].cache_stats(ours[1].cache)
    if kw.get("prefix_cache") == "on":
        # the partial hits need chunked prefill; the whole-body ones do not
        cached = [r.cached_tokens for r in tr]
        assert cached[4] == 15 and stats["cow_copies"] >= 1
        assert cached[1] == (16 if chunk else 0)
    if kw.get("kv_dtype", "bf16") != "bf16":
        assert stats["kv_dtype"] == kw["kv_dtype"]
        assert stats["kv_token_bytes_stored"] < stats[
            "kv_token_bytes_per_shard"] / 1.9


def test_dense_slot_cache_chunked_prefill(setup):
    """The dense slot cache (no page_size) under chunked prefill."""
    rr, tr, ref, ours = serve_both(setup, 8)
    assert_same_service(rr, tr, ref, ours)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
def test_prefix_on_and_off_give_the_same_tokens(setup, kv_dtype):
    """The prefix cache changes what is computed, not what is served: with
    chunked prefill, prefix on and off give identical tokens (under a
    quantized pool too: completed prefill pages are fake-quantized, so a
    page read from the cache holds what a fresh prefill would attend to),
    and prefix on stores fewer pages."""
    toks, stored = {}, {}
    for prefix in ("on", "off"):
        eng = ServeEngine(setup["tcfg"], setup["tparams"], max_len=MAX_LEN,
                          page_size=PAGE, prefix_cache=prefix,
                          kv_dtype=kv_dtype, device="cpu")
        sched = ContinuousBatchingScheduler(eng, max_slots=2, prefill_chunk=8)
        res = serve_staged([sched], [_requests(Request, setup["prompts"])])[0]
        toks[prefix] = [r.tokens.tolist() for r in res]
        stored[prefix] = eng.cache_stats(sched.cache)["pages_allocated"]
    assert toks["on"] == toks["off"]
    assert stored["on"] < stored["off"]
