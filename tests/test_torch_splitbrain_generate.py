"""The port's ``SplitBrainEngine.generate()`` against the JAX package's.

Reduced tinyllama-1.1b (2 layers, d_model 64, 4 heads, 2 KV heads, hd 16),
LAQ W4A8 or float weights, the same weights in both packages
(``params_from_numpy``), the reference on an Auto-axis mesh.  Three
prompts of 5 tokens are teacher-forced through the per-token step on the
dense cache and 6 tokens free-run.

The port's ``fused=True`` loop is held to the reference's jitted
``lax.scan`` (``jit=True``) and its ``fused=False`` stepwise loop to the
reference's eager loop (``jit=False``): tokens, ``gen_len`` and the eq.
7-10 meter identical, entry for entry, with and without ``eos_id``.  The
two meters differ once a row stops, as the reference's do: the fused loop
replays boundary bytes per active token, the stepwise loop meters every
executed step for the whole batch.  The stop token is one the model emits
early in one row, taken from a run without ``eos_id``, so that rows stop
at different steps.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")   # the parity tests need the JAX package

from jax.sharding import AxisType

from repro.configs import get_config
from repro.models import api as japi
from repro.serve.splitbrain_engine import SplitBrainEngine as JEngine
from repro_torch.configs import get_config as t_get_config
from repro_torch.models.api import params_from_numpy
from repro_torch.serve.splitbrain_engine import (
    SplitBrainEngine, traffic_model_for)

ARCH = "tinyllama-1.1b"
PROMPTS = np.stack([(np.arange(1, 6) * (5 + 2 * i) + i) % 256
                    for i in range(3)]).astype(np.int32)
MAX_NEW = 6
MAX_LEN = 12


@pytest.fixture(scope="module")
def setup():
    cfg = get_config(ARCH).reduced()
    params = jax.jit(japi.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return dict(cfg=cfg, tcfg=t_get_config(ARCH).reduced(), params=params,
                tparams=tparams, mesh=mesh, engines={}, eos={})


def _engines(s, quantize, jit):
    """Both packages' engines, built once per (quantize, jit) and shared
    (the reference's compiled programs with them); meters reset."""
    key = (quantize, jit)
    if key not in s["engines"]:
        s["engines"][key] = (
            JEngine(s["cfg"], s["params"], max_len=MAX_LEN,
                    quantize=quantize, jit=jit, mesh=s["mesh"]),
            SplitBrainEngine(s["tcfg"], s["tparams"], max_len=MAX_LEN,
                             quantize=quantize, fused=jit, device="cpu"))
    for eng in s["engines"][key]:
        eng.meter.reset()
    return s["engines"][key]


def _eos(s, quantize):
    """The token row 1 emits at its third step: rows then stop at
    different steps."""
    if quantize not in s["eos"]:
        _, ours = _engines(s, quantize, True)
        toks = ours.generate(PROMPTS, max_new=MAX_NEW)["tokens"]
        s["eos"][quantize] = int(toks[1, 2])
    return s["eos"][quantize]


@pytest.mark.parametrize("with_eos", [False, True], ids=["no_eos", "eos"])
@pytest.mark.parametrize("jit", [False, True], ids=["stepwise", "fused"])
@pytest.mark.parametrize("quantize", [False, True], ids=["float", "w4a8"])
def test_generate_matches_reference(setup, quantize, jit, with_eos):
    eos = _eos(setup, quantize) if with_eos else None
    ref, ours = _engines(setup, quantize, jit)
    r = ref.generate(PROMPTS, max_new=MAX_NEW, eos_id=eos)
    o = ours.generate(PROMPTS, max_new=MAX_NEW, eos_id=eos)
    assert set(o) == set(r)
    np.testing.assert_array_equal(o["tokens"], np.asarray(r["tokens"]))
    np.testing.assert_array_equal(o["gen_len"], np.asarray(r["gen_len"]))
    assert o["tokens"].dtype == np.int32 and o["tokens"].shape == (3, MAX_NEW)
    if with_eos:
        assert 3 <= o["gen_len"].min() < MAX_NEW    # row 1 stopped early
        assert o["gen_len"].max() > o["gen_len"].min()
        for row, n in zip(o["tokens"], o["gen_len"]):
            assert (row[n:] == eos).all() and (n == MAX_NEW or row[n - 1] == eos)
    else:
        assert o["gen_len"].tolist() == [MAX_NEW] * 3
    assert ours.meter.log == ref.meter.log
    assert ours.meter.measured_bytes() == ref.meter.measured_bytes()
    assert int(o["cache"]["len"][0]) == int(np.asarray(r["cache"]["len"])[0])
    if jit:     # the replayed meter: per active token
        n_tok = 3 * (PROMPTS.shape[1] - 1) + int(o["gen_len"].sum())
        assert ours.meter.measured_bytes()["total"] == \
            traffic_model_for(setup["tcfg"]).bytes_per_token() * n_tok


def test_generate_fills_the_cache_and_refuses_overlong(setup):
    """Both loops return the dense cache with ``T0 - 1 + max_new``
    positions written (the fused loop with the same ``len`` in every row,
    the stepwise loop until every row stops), and a request longer than
    the cache raises ValueError in both."""
    for fused in (True, False):
        eng = SplitBrainEngine(setup["tcfg"], setup["tparams"],
                               max_len=MAX_LEN, fused=fused, device="cpu")
        out = eng.generate(PROMPTS, max_new=MAX_NEW)
        n = PROMPTS.shape[1] - 1 + MAX_NEW
        assert out["cache"]["len"].tolist() == [n] * 3
        assert out["cache"]["k"][:, :, :, :n].abs().sum(-1).all()
        assert not out["cache"]["k"][:, :, :, n:].any()
        with pytest.raises(ValueError, match="does not fit the cache"):
            eng.generate(PROMPTS, max_new=MAX_LEN - PROMPTS.shape[1] + 2)


def test_scheduler_steps_follow_the_compiled_reference(setup):
    """The scheduler's steps on a page pool follow the reference's
    compiled programs (``jit=True``: its reciprocal quantizer scale and
    float32 residual sum), so random requests get its tokens; the eager
    numerics miss them on most request sets."""
    from repro.serve.scheduler import ContinuousBatchingScheduler as JSched
    from repro.serve.scheduler import Request as JRequest
    from repro_torch.serve.scheduler import (ContinuousBatchingScheduler,
                                             Request)
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, 256, int(rng.integers(2, 12))).astype(np.int32),
             8) for _ in range(4)]
    ref = JEngine(setup["cfg"], setup["params"], max_len=32, quantize=True,
                  page_size=8, mesh=setup["mesh"])
    ours = SplitBrainEngine(setup["tcfg"], setup["tparams"], max_len=32,
                            quantize=True, page_size=8, device="cpu")
    toks = [[r.tokens.tolist() for r in sched.run(
        [cls(uid=i, prompt=p, max_new=m) for i, (p, m) in enumerate(reqs)]
        )["results"]]
        for sched, cls in ((JSched(ref, max_slots=2), JRequest),
                           (ContinuousBatchingScheduler(ours, max_slots=2),
                            Request))]
    assert toks[1] == toks[0]
