"""The port's float ServeEngine serving reduced rwkv6-7b, against the JAX
package's ServeEngine on the same weights.

Reduced rwkv6-7b: 2 layers, d_model 64 (one 64-wide head), d_ff 128, vocab
256.  The reference runs with ``use_pallas=True`` on an Auto-axis mesh; its
serve path never reaches the Pallas scan (every ``decode_step`` carries the
WKV state), and neither does the port's: its prefill is one ``decode_step``
per prompt token, as the JAX package's bucketed scan of ``decode_step`` is.

``generate()`` fused and stepwise, with and without an ``eos_id`` that stops
some rows early, and a continuous-batching trace of six requests over three
slots with and without ``page_size``: greedy tokens and ``gen_len``
identical to the reference's, the eq. 7-10 meter exact and entry for entry
the reference's.  With ``page_size`` both engines keep the dense slot
layout (rwkv's state does not grow with the sequence): the same cache
accounting, no page pool.  The CLI serves ``--arch rwkv6-7b``, and the
eq. 7-10 traffic model of every config in the port's registry equals the
JAX package's.
"""
import dataclasses
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")   # the parity tests need the JAX package

from jax.sharding import AxisType

from repro.configs import get_config
from repro.core.splitbrain import TrafficModel as JTrafficModel
from repro.models import api as japi
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.scheduler import ContinuousBatchingScheduler as JScheduler
from repro.serve.scheduler import Request as JRequest
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs.registry import CONFIGS
from repro_torch.core.splitbrain import TrafficModel
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models.api import params_from_numpy
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import ContinuousBatchingScheduler, Request

MAX_LEN = 64
MAX_NEW = 8
LENS = [5, 9, 17, 24, 3, 12]


def _prompts(B=3, T0=9):
    return np.stack([((np.arange(1, T0 + 1) * (5 + i) + 3 * i) % 256)
                     .astype(np.int32) for i in range(B)])


def _requests(cls):
    return [cls(uid=i, prompt=((np.arange(1, n + 1) * 7 + i) % 256)
                .astype(np.int32), max_new=MAX_NEW)
            for i, n in enumerate(LENS)]


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(get_config("rwkv6-7b").reduced(),
                              use_pallas=True)
    params = jax.jit(japi.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(1))
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    tcfg = t_get_config("rwkv6-7b").reduced()

    def engines(**kw):
        return (JEngine(cfg, params, mesh=mesh, max_len=MAX_LEN, **kw),
                ServeEngine(tcfg, tparams, max_len=MAX_LEN, device="cpu",
                            **kw))

    ref, ours = engines()
    base = ref.generate(_prompts(), max_new=MAX_NEW)["tokens"]
    # a stop token that some rows emit mid-way and others never do
    eos = next(int(t) for t in base[:, 1:].ravel()
               if not (base == t).any(axis=1).all())
    return dict(tcfg=tcfg, ref=ref, ours=ours, eos=eos, engines=engines)


@pytest.mark.parametrize("with_eos", [False, True], ids=["no_eos", "eos"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "stepwise"])
def test_generate_tokens_and_gen_len_identical(setup, fused, with_eos):
    ref, ours = setup["ref"], setup["ours"]
    eos = setup["eos"] if with_eos else None
    prompts = _prompts()
    ours.meter.reset()
    a = ref.generate(prompts, max_new=MAX_NEW, fused=fused, eos_id=eos)
    ops.reset_launch_counts()
    b = ours.generate(prompts, max_new=MAX_NEW, fused=fused, eos_id=eos)
    assert ops.launch_counts()["rwkv6_scan"] == 0
    np.testing.assert_array_equal(b["tokens"], a["tokens"])
    np.testing.assert_array_equal(b["gen_len"], a["gen_len"])
    if with_eos:
        assert b["gen_len"].min() < MAX_NEW     # the stop token fired
    n_tok = prompts.shape[0] * (prompts.shape[1] - 1) + int(b["gen_len"].sum())
    bpt = TrafficModel.for_config(ours.cfg).bytes_per_token()
    assert ours.measured_bytes()["total"] == bpt * n_tok


@pytest.mark.parametrize("page_size", [None, 8], ids=["dense", "page_size"])
def test_scheduler_tokens_meter_and_dense_layout_match_reference(
        setup, page_size):
    ref, ours = setup["engines"](page_size=page_size)
    jsched = JScheduler(ref, max_slots=3)
    a = jsched.run(_requests(JRequest))
    sched = ContinuousBatchingScheduler(ours, max_slots=3)
    b = sched.run(_requests(Request))
    assert b["by_state"] == {"DONE": len(LENS)}
    assert ([r.tokens.tolist() for r in b["results"]]
            == [r.tokens.tolist() for r in a["results"]])
    assert [r.gen_len for r in b["results"]] == [MAX_NEW] * len(LENS)
    assert b["steps"] == a["steps"]
    n_tok = sum(n - 1 for n in LENS) + MAX_NEW * len(LENS)
    bpt = TrafficModel.for_config(setup["tcfg"]).bytes_per_token()
    assert ours.measured_bytes()["total"] == bpt * n_tok
    assert ours.meter.log == ref.meter.log
    assert ours.meter.host_log == ref.meter.host_log
    # the dense slot layout either way: no pool, the reference's accounting
    assert not ours._paging_active and not ref._paging_active
    assert ours.cache_stats(sched.cache) == ref.cache_stats(jsched.cache)


def test_cli_serves_rwkv(capsys):
    smoke = ["--arch", "rwkv6-7b", "--smoke", "--device", "cpu",
             "--max-new", "4"]
    out = serve.main([*smoke, "--continuous", "--requests", "5",
                      "--slots", "2", "--page-size", "8"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["arch"] == "rwkv6-7b-smoke" and rep["by_state"] == {"DONE": 5}
    assert rep["gen_len"] == [4] * 5 and "page_size" not in rep["cache"]
    paged = [r.tokens.tolist() for r in out["results"]]
    out = serve.main([*smoke, "--continuous", "--requests", "5",
                      "--slots", "2"])
    assert [r.tokens.tolist() for r in out["results"]] == paged
    capsys.readouterr()
    out = serve.main([*smoke, "--batch", "3", "--prompt-len", "6"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["batch"] == 3 and out["tokens"].shape == (3, 4)


@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_traffic_model_matches_the_jax_package(arch):
    """eq. 7-10 per-token and prefill bytes of every config the port
    serves, full and reduced, equal the JAX package's."""
    for jcfg, tcfg in ((get_config(arch), t_get_config(arch)),
                       (get_config(arch).reduced(),
                        t_get_config(arch).reduced())):
        a, b = JTrafficModel.for_config(jcfg), TrafficModel.for_config(tcfg)
        assert b.bytes_per_token() == a.bytes_per_token()
        assert b.prefill_bytes(37) == a.prefill_bytes(37)
