"""The float ServeEngine serving the MoE configs, against the JAX package's
ServeEngine on the same weights (Auto-axis mesh, ``use_pallas=True``).

Reduced phi3.5-moe-42b-a6.6b, reduced qwen3-moe-235b-a22b (4 experts,
top-2; weights from two seeds) and the top-8 override (16 experts, top-8,
GQA 16/1).  The MoE FFN couples the rows of a call, so the port must feed
the reference's rows: every slot of a decode step (free ones included), the
zero padding of a prompt body's bucket and the copies of row 0 that pad
``generate()``'s batch.  Six requests whose prompts cross bucket edges go
through each package's scheduler on 4 or 8 slots: tokens identical, page
tables equal after every iteration, the eq. 7-10 meter exact, and the
port's drop log shows that capacity dropped assignments in its decode
steps and prefills.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")   # the parity tests need the JAX package

from jax.sharding import AxisType

from repro.configs import get_config
from repro.configs.base import MoEConfig as JMoE
from repro.models import api as japi
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.scheduler import ContinuousBatchingScheduler as JScheduler
from repro.serve.scheduler import Request as JRequest
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs.base import MoEConfig
from repro_torch.core.splitbrain import TrafficModel
from repro_torch.models import moe
from repro_torch.models.api import params_from_numpy
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import ContinuousBatchingScheduler, Request

CASES = {"phi": ("phi3.5-moe-42b-a6.6b", 0, {}),
         "qwen": ("qwen3-moe-235b-a22b", 1, {}),
         "top8": ("qwen3-moe-235b-a22b", 2,
                  dict(num_heads=16, num_kv_heads=1))}
LENS = [5, 9, 17, 24, 3, 12]
MAX_NEW = 6
MAX_LEN = 64
_SETUPS = {}


def setup_for(case):
    if case not in _SETUPS:
        arch, seed, kw = CASES[case]
        jkw, tkw = dict(kw), dict(kw)
        if case == "top8":
            jkw["moe"], tkw["moe"] = JMoE(16, 8), MoEConfig(16, 8)
        cfg = dataclasses.replace(get_config(arch).reduced(**jkw),
                                  use_pallas=True)
        params = jax.jit(japi.init_params, static_argnums=0)(
            cfg, jax.random.PRNGKey(seed))
        mesh = jax.make_mesh((1, 1), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        _SETUPS[case] = dict(
            cfg=cfg, tcfg=t_get_config(arch).reduced(**tkw), params=params,
            mesh=mesh, tparams=params_from_numpy(
                jax.tree.map(np.asarray, params), "cpu"))
    return _SETUPS[case]


def _prompts(vocab=256):
    # rows share most tokens, so their experts coincide and capacity binds
    base = (np.arange(1, 40) * 7) % vocab
    return [np.where(np.arange(n) % 4 == 3, (i * 31 + 5) % vocab,
                     base[:n]).astype(np.int32) for i, n in enumerate(LENS)]


def _requests(cls):
    return [cls(uid=i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(_prompts())]


def _engines(s, **kw):
    ref = JEngine(s["cfg"], s["params"], mesh=s["mesh"], max_len=MAX_LEN,
                  **kw)
    ours = ServeEngine(s["tcfg"], s["tparams"], max_len=MAX_LEN,
                       device="cpu", **kw)
    return ref, ours


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("page_size,slots", [(8, 8), (None, 4)],
                         ids=["paged-8slots", "dense-4slots"])
def test_scheduler_tokens_tables_meter_and_drops_match_reference(
        case, page_size, slots):
    s = setup_for(case)
    ref, ours = _engines(s, page_size=page_size)
    scheds = (JScheduler(ref, max_slots=slots),
              ContinuousBatchingScheduler(ours, max_slots=slots))
    for sch, cls in zip(scheds, (JRequest, Request)):
        sch.begin()
        for r in _requests(cls):
            assert sch.submit(r)
    log = moe.drop_log()
    steps = 0
    try:
        while any(sch.has_work() for sch in scheds):
            for sch in scheds:
                sch.step()
            steps += 1
            if page_size is not None:
                np.testing.assert_array_equal(
                    ref._pager.pool.table, ours._pager.pool.table,
                    err_msg=f"iteration {steps}")
            assert steps < 200
    finally:
        moe.drop_log(False)
    res = [sorted(sch.poll(), key=lambda r: r.uid) for sch in scheds]
    assert [r.state for r in res[1]] == ["DONE"] * len(LENS)
    assert ([r.tokens.tolist() for r in res[1]]
            == [r.tokens.tolist() for r in res[0]])
    n_tok = sum(n - 1 for n in LENS) + MAX_NEW * len(LENS)
    assert ours.measured_bytes()["total"] == \
        TrafficModel.for_config(s["tcfg"]).bytes_per_token() * n_tok
    assert ours.meter.log == ref.meter.log
    assert ours.meter.host_log == ref.meter.host_log
    n_layers = s["tcfg"].num_layers
    dec = [int(e["dropped"]) for e in log if e["rows"] == slots]
    pre = [int(e["dropped"]) for e in log if e["rows"] != slots]
    # every decode step runs every slot through each layer's MoE
    assert len(dec) % n_layers == 0 and len(dec) // n_layers >= MAX_NEW
    assert sum(dec) > 0 and sum(pre) > 0
    if page_size is not None:
        assert ours._pager.pool.pages_in_use == 0


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("T0,fused,eos", [(7, True, None), (20, True, 9),
                                          (7, False, None)],
                         ids=["fused", "fused-bucket-eos", "stepwise"])
def test_generate_matches_reference(case, T0, fused, eos):
    """``generate()`` on 3 prompts: the fused path pads the batch to 4
    with copies of row 0 and the body to its bucket (6 -> 8, 19 -> 32), as
    the reference does; the stepwise path pads nothing."""
    s = setup_for(case)
    ref, ours = _engines(s)
    prompts = np.stack([p[:T0] if len(p) >= T0 else np.resize(p, T0)
                        for p in _prompts()[1:4]]).astype(np.int32)
    prompts[1, 2] = 101
    with s["mesh"]:
        want = ref.generate(prompts, max_new=MAX_NEW, fused=fused,
                            eos_id=eos)
    got = ours.generate(prompts, max_new=MAX_NEW, fused=fused, eos_id=eos)
    np.testing.assert_array_equal(got["tokens"], np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["gen_len"],
                                  np.asarray(want["gen_len"]))
    assert got["tokens"].shape == (3, MAX_NEW)
    assert ours.meter.log == ref.meter.log


def test_prefill_slot_feeds_the_reference_rows():
    """A MoE request's prefill: the body zero-padded to its bucket in a
    ``max_len`` cache (so the MoE sees the reference's padding rows), for
    the dense and the paged layout alike; a dense config keeps its
    true-length, page-rounded cache."""
    s = setup_for("phi")
    prompt = _prompts()[2]                        # 17 tokens: body 16
    for page_size in (8, None):
        eng = ServeEngine(s["tcfg"], s["tparams"], max_len=MAX_LEN,
                          page_size=page_size, device="cpu")
        eng.init_slot_cache(2)
        log = moe.drop_log()
        try:
            cache, tok = eng.prefill_slot(prompt)
        finally:
            moe.drop_log(False)
        assert tok == int(prompt[-1]) and int(cache["len"][0]) == 16
        assert cache["k"][0].shape[4] == MAX_LEN
        assert {e["rows"] for e in log} == {16}
        np.testing.assert_array_equal(eng._body(prompt[None, :10]),
                                      np.pad(prompt[None, :9], ((0, 0),
                                                                (0, 7))))
