"""The split-brain engine's KV-cache features against the JAX package's
engine on the same weights: dense slot caches, chunked prefill (the token
step from whatever state the request cache holds), the gather discipline,
shared-prefix copy-on-write pages and int8 / fp8 page pools, with LAQ W4A8
weights (``quantize=True``) and float ones, on reduced tinyllama-1.1b (2
layers, d_model 64, 4/2 heads of 16, vocab 256), ``max_len`` 64, pages of
8, chunks of 8, two slots.

The traffic is ``torch_cases.feature_prompts`` through each package's
scheduler in lockstep.  Greedy tokens, ``cached_tokens``, page tables (after
every iteration), ``cache_stats`` and every meter channel (eq. 7-10 and the
host KV channels) must be identical to the reference on an Auto-axis mesh.
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
from repro_torch.serve.splitbrain_engine import SplitBrainEngine
from torch_cases import feature_prompts, serve_staged

ARCH = "tinyllama-1.1b"
MAX_LEN, MAX_NEW = 64, 4


@pytest.fixture(scope="module")
def setup():
    cfg = get_config(ARCH).reduced()
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


def _port_engine(s, quantize, **kw):
    return SplitBrainEngine(s["tcfg"], s["tparams"], max_len=MAX_LEN,
                            quantize=quantize, device="cpu", **kw)


CASES = {
    "w4a8-int8-prefix-chunk-inplace": (True, 8, dict(
        page_size=8, prefix_cache="on", kv_dtype="int8")),
    "float-fp8-prefix-chunk-gather": (False, 8, dict(
        page_size=8, prefix_cache="on", kv_dtype="fp8", paged_attn="gather")),
    "w4a8-bf16-prefix-block-gather": (True, None, dict(
        page_size=8, prefix_cache="on", paged_attn="gather")),
    "float-int8-chunk-inplace": (False, 8, dict(page_size=8,
                                                kv_dtype="int8")),
    "w4a8-dense-chunk": (True, 8, dict()),
    "float-dense-block": (False, None, dict()),
}


@pytest.mark.parametrize("case", list(CASES))
def test_features_match_reference(setup, case):
    quantize, chunk, kw = CASES[case]
    ref = JEngine(setup["cfg"], setup["params"], max_len=MAX_LEN,
                  quantize=quantize, mesh=setup["mesh"], **kw)
    ours = _port_engine(setup, quantize, **kw)
    scheds = [JScheduler(ref, max_slots=2, prefill_chunk=chunk),
              ContinuousBatchingScheduler(ours, max_slots=2,
                                          prefill_chunk=chunk)]

    def tables(it):
        if "page_size" in kw:
            np.testing.assert_array_equal(ref._pager.pool.table,
                                          ours._pager.pool.table,
                                          err_msg=f"iteration {it}")

    rr, tr = serve_staged(scheds, [_requests(JRequest, setup["prompts"]),
                                   _requests(Request, setup["prompts"])],
                          tables)
    assert [r.state for r in tr] == ["DONE"] * len(rr)
    assert [r.tokens.tolist() for r in tr] == [r.tokens.tolist() for r in rr]
    assert [r.cached_tokens for r in tr] == [r.cached_tokens for r in rr]
    assert ours.meter.log == ref.meter.log
    assert ours.meter.host_log == ref.meter.host_log
    assert (ours.cache_stats(scheds[1].cache)
            == ref.cache_stats(scheds[0].cache))
    if kw.get("prefix_cache") == "on":
        assert sum(r.cached_tokens for r in tr) > 0


@pytest.mark.parametrize("quantize", [True, False])
def test_dense_and_paged_slot_caches_give_the_same_tokens(setup, quantize):
    """At one kv_dtype (bf16), a dense slot cache and a paged pool serve the
    same tokens, with block and chunked prefill alike."""
    toks = []
    for kw, chunk in ((dict(), None), (dict(page_size=8), None),
                      (dict(), 8), (dict(page_size=8), 8)):
        sched = ContinuousBatchingScheduler(_port_engine(setup, quantize,
                                                         **kw),
                                            max_slots=2, prefill_chunk=chunk)
        res = serve_staged([sched], [_requests(Request, setup["prompts"])])[0]
        toks.append([r.tokens.tolist() for r in res])
    assert toks[1:] == toks[:1] * 3
