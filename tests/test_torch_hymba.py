"""hymba on the port against the JAX package, on the same weights.

Reduced hymba-1.5b: 2 layers, d_model 64, GQA 4/2 heads of 16, d_ff 128,
vocab 256, SSM state 8 with dt_rank 8, attention window 16.  The reference
runs jitted on an Auto-axis mesh with ``use_pallas=True`` (its flash and
paged kernels in interpret mode).

Tolerances, each beside its check:
* XLA's CPU ``exp`` (``ref.exp``) and hymba's softplus: bit-identical;
* the sequential selective scan: outputs and final state bit-identical;
  the associative form's outputs bit-identical, its final state within 8
  float32 ulps of its largest entry (XLA picks its own FMA contractions
  inside the associative combine);
* ``forward`` logits (T past the window): bit-identical;
* decode logits (dense ring across its wrap, and through the page pool):
  bit-identical for most steps, and within one bf16 ulp of the largest
  |logit| at every step, with the same greedy token: XLA's CPU sin / cos in
  rope and its ``rsqrt`` in the norms differ from PyTorch's in the last
  float32 bit now and then, and the recurrent SSM state carries such a
  difference on;
* the ServeEngine: greedy tokens, ``gen_len``, scheduler steps, page
  tables after every iteration, ``cache_stats`` and every meter channel
  identical.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the parity tests need the JAX package

import jax.numpy as jnp
from jax.sharding import AxisType

from repro.configs import get_config
from repro.kernels import ref as jref
from repro.models import api as japi
from repro.models import hymba as jhymba
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.faults import FaultInjector as JInjector
from repro.serve.faults import FaultPlan as JPlan
from repro.serve.scheduler import ContinuousBatchingScheduler as JScheduler
from repro.serve.scheduler import Request as JRequest
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.splitbrain import TrafficModel
from repro_torch.kernels import ops, ref
from repro_torch.models import api, hymba
from repro_torch.models.api import params_from_numpy
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.faults import FaultInjector, FaultPlan
from repro_torch.serve.scheduler import ContinuousBatchingScheduler, Request
from torch_cases import bf16_ulp_of

ARCH = "hymba-1.5b"
WINDOW = 16
MAX_NEW = 6


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(get_config(ARCH).reduced(), use_pallas=True)
    tcfg = t_get_config(ARCH).reduced()
    assert tcfg.layer_pattern[0].window == WINDOW and tcfg.ssm.state_dim == 8
    params = jax.jit(japi.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return dict(cfg=cfg, tcfg=tcfg, params=params, tparams=tparams, mesh=mesh)


def _t(a):
    return torch.from_numpy(np.asarray(jnp.asarray(a).astype(jnp.float32)))


def test_xla_exp_and_softplus_bit_identical():
    """``ref.exp`` against ``jax.jit(jnp.exp)`` on 400,000 float32 inputs in
    [-110, 88.37] (through the flush to zero below 2^-126); hymba's
    softplus against ``jax.jit(jax.nn.softplus)`` on every finite bfloat16."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-110, 88.37, 300_000),
                        rng.uniform(-1, 1, 100_000)]).astype(np.float32)
    want = np.asarray(jax.jit(jnp.exp)(x))
    np.testing.assert_array_equal(ref.exp(torch.from_numpy(x)).numpy(), want)
    assert (torch.exp(torch.from_numpy(x)).numpy() != want).mean() > 0.05
    bits = np.arange(1 << 16, dtype=np.uint32) << 16
    f = bits.view(np.float32)
    f = f[np.isfinite(f)]
    xb = jnp.asarray(f).astype(jnp.bfloat16)
    want = np.asarray(jax.jit(jax.nn.softplus)(xb).astype(jnp.float32))
    got = hymba._softplus(_t(xb).to(torch.bfloat16)).float().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("carried", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("T", [1, 5, 37])
def test_selective_scans_match_jax(T, carried):
    rng = np.random.default_rng(T)
    B, D, N = 2, 64, 8
    x = jnp.asarray(rng.standard_normal((B, T, D)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    delta = np.log1p(np.exp(rng.standard_normal((B, T, D)))).astype(np.float32)
    A = -np.tile(np.arange(1, N + 1, dtype=np.float32), (D, 1))
    Bm, Cm = (rng.standard_normal((B, T, N)).astype(np.float32)
              for _ in range(2))
    st = rng.standard_normal((B, D, N)).astype(np.float32) if carried else None
    targs = [_t(x).to(torch.bfloat16)] + [torch.from_numpy(a)
                                          for a in (delta, A, Bm, Cm)]
    tst = None if st is None else torch.from_numpy(st)
    for jfn, algo in ((jref.selective_scan, "sequential"),
                      (jref.selective_scan_assoc, "associative")):
        jy, jh = jax.jit(jfn)(x, delta, A, Bm, Cm,
                              None if st is None else jnp.asarray(st))
        ty, th = ops.selective_scan(*targs, tst, algorithm=algo)
        assert ty.dtype == torch.bfloat16 and th.dtype == torch.float32
        np.testing.assert_array_equal(ty.float().numpy(), _t(jy).numpy())
        if algo == "sequential" or T == 1 and not carried:
            np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        else:
            bound = 8 * 2.0 ** -23 * np.abs(np.asarray(jh)).max()
            assert np.abs(th.numpy() - np.asarray(jh)).max() <= bound


def test_forward_logits_bit_identical(setup):
    """Two rows of 40 tokens, past the 16-token window: the reference's
    jitted forward with its Pallas flash kernel (interpret mode) against
    ``api.forward`` (the plain flash version, one per layer)."""
    cfg, tcfg = setup["cfg"], setup["tcfg"]
    toks = np.random.default_rng(1).integers(1, 256, (2, 40)).astype(np.int32)
    with setup["mesh"]:
        jl, _ = jax.jit(lambda p, t: japi.forward(p, t, cfg))(
            setup["params"], jnp.asarray(toks))
    tl, aux = api.forward(setup["tparams"], torch.from_numpy(toks), tcfg)
    assert aux == 0.0 and tl.dtype == torch.float32
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def _hold_logits(tl, jl):
    """One decode step's logits: within one bf16 ulp of the largest
    |logit| (module docstring), the same greedy token; True when they are
    bit-identical."""
    jl = np.asarray(jl)
    assert np.abs(tl.numpy() - jl).max() <= bf16_ulp_of(np.abs(jl).max())
    np.testing.assert_array_equal(tl.numpy().argmax(-1), jl.argmax(-1))
    return bool((tl.numpy() == jl).all())


def test_decode_step_logits_across_the_ring_wrap(setup):
    """Three rows, 24 decode steps of seeded tokens on a 32-position cache
    whose K/V ring holds the 16-token window, so the ring wraps at step
    16."""
    cfg, tcfg = setup["cfg"], setup["tcfg"]
    toks = np.random.default_rng(0).integers(1, 256, (3, 24)).astype(np.int32)
    jc = japi.init_cache(cfg, 3, 32)
    tc = api.init_cache(tcfg, 3, 32, device="cpu")
    assert tuple(tc["k"].shape) == (2, 3, 2, WINDOW, 16)
    step = jax.jit(lambda p, c, t: jhymba.decode_step(p, c, t, cfg))
    exact = 0
    for t in range(24):
        jl, jc = step(setup["params"], jc, jnp.asarray(toks[:, t]))
        tl, tc = api.decode_step(setup["tparams"], tc,
                                 torch.from_numpy(toks[:, t]), tcfg)
        exact += _hold_logits(tl, jl)
    assert exact >= 16
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


def test_paged_decode_step_logits_and_pool(setup):
    """The same model through the page pool: 3 slots of 3 pages of 4 (max_len
    12 plus a page fits the window, so K/V page), a shuffled page table,
    slot 1 frozen on every third step; pool, SSM state, ``len`` and logits
    against the reference's jitted ``paged_decode_step`` with its Pallas
    kernel (interpret mode)."""
    cfg, tcfg = setup["cfg"], setup["tcfg"]
    rng = np.random.default_rng(2)
    B, P, ps, NP = 3, 3, 4, 10
    table = (rng.permutation(NP - 1)[:B * P] + 1).reshape(B, P).astype(np.int32)
    toks = rng.integers(1, 256, (B, 12)).astype(np.int32)
    dense = api.init_cache(tcfg, B, 12, device="cpu")
    pool = lambda: np.zeros((2, NP, ps, 2, 16), np.float32)  # noqa: E731
    jc = {"k": jnp.asarray(pool()).astype(jnp.bfloat16),
          "v": jnp.asarray(pool()).astype(jnp.bfloat16),
          "ssm": jnp.zeros(tuple(dense["ssm"].shape), jnp.float32),
          "len": jnp.zeros((B,), jnp.int32)}
    tc = {"k": torch.zeros(jc["k"].shape, dtype=torch.bfloat16),
          "v": torch.zeros(jc["v"].shape, dtype=torch.bfloat16),
          "ssm": dense["ssm"].clone(), "len": dense["len"].clone()}
    step = jax.jit(lambda p, c, tb, t, w: jhymba.paged_decode_step(
        p, c, tb, t, cfg, write=w))
    exact, n = 0, 0
    for t in range(11):
        write = np.array([True, t % 3 != 2, True])
        jl, jc = step(setup["params"], jc, jnp.asarray(table),
                      jnp.asarray(toks[:, t]), jnp.asarray(write))
        tl, tc = api.paged_decode_step(
            setup["tparams"], tc, torch.from_numpy(table),
            torch.from_numpy(toks[:, t]), tcfg,
            write=torch.from_numpy(write))
        rows = np.flatnonzero(write)
        exact += _hold_logits(tl[rows], np.asarray(jl)[rows])
        n += 1
        np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    assert exact >= n - 3
    live = table.ravel()
    diff = (tc["k"].float().numpy()[:, live] != _t(jc["k"]).numpy()[:, live])
    assert diff.mean() < 0.01
    assert int(tc["len"][1]) < int(tc["len"][0]) == 11


def _requests(cls, lens, seed=0):
    return [cls(uid=i, prompt=((np.arange(1, n + 1) * (7 + seed) + i) % 256)
                .astype(np.int32), max_new=MAX_NEW)
            for i, n in enumerate(lens)]


@pytest.mark.parametrize("layout", ["ring", "paged", "paged_prefix"])
def test_engine_matches_reference(setup, layout):
    """Under each package's scheduler (3 slots): on the ring layout
    (max_len 40, a dense 16-token ring per slot that decode wraps), and on
    the paged layout (max_len 12, page 4: K/V page, the SSM state stays a
    dense slot leaf), with the prefix cache armed (a no-op: the SSM state
    cannot be shared by prefix).  Tokens, steps, page tables after every
    iteration, ``cache_stats`` and the meter identical."""
    paged = layout != "ring"
    max_len = 12 if paged else 40
    lens = [3, 5, 2, 7, 4] if paged else [5, 9, 17, 24, 3, 12]
    kw = dict(page_size=4 if paged else None,
              prefix_cache="on" if layout == "paged_prefix" else "off")
    ref_eng = JEngine(setup["cfg"], setup["params"], mesh=setup["mesh"],
                      max_len=max_len, **kw)
    ours = ServeEngine(setup["tcfg"], setup["tparams"], max_len=max_len,
                       device="cpu", **kw)
    assert ours._sa == {"k": 3 if paged else -1, "v": 3 if paged else -1,
                        "ssm": -1, "len": -1}
    scheds = (JScheduler(ref_eng, max_slots=3),
              ContinuousBatchingScheduler(ours, max_slots=3))
    for s, cls in zip(scheds, (JRequest, Request)):
        s.begin()
        for r in _requests(cls, lens):
            assert s.submit(r)
    assert ours._paging_active == ref_eng._paging_active == paged
    it = 0
    ops.reset_launch_counts()
    while any(s.has_work() for s in scheds):
        for s in scheds:
            s.step()
        it += 1
        if paged:
            np.testing.assert_array_equal(ref_eng._pager.pool.table,
                                          ours._pager.pool.table)
        assert it < 200
    res = [sorted(s.poll(), key=lambda r: r.uid) for s in scheds]
    assert [r.state for r in res[1]] == ["DONE"] * len(lens)
    assert ([r.tokens.tolist() for r in res[1]]
            == [r.tokens.tolist() for r in res[0]])
    assert [r.cached_tokens for r in res[1]] == [0] * len(lens)
    assert ours.cache_stats(scheds[1].cache) == ref_eng.cache_stats(
        scheds[0].cache)
    assert ours.meter.log == ref_eng.meter.log
    assert ours.meter.host_log == ref_eng.meter.host_log
    n_tok = sum(n - 1 for n in lens) + MAX_NEW * len(lens)
    bpt = TrafficModel.for_config(setup["tcfg"]).bytes_per_token()
    assert ours.measured_bytes()["total"] == bpt * n_tok
    assert ops.launch_counts()["flash_attention"] == 0


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "stepwise"])
def test_generate_matches_reference(setup, fused):
    """Three prompts of 20 tokens (past the window) and 8 new tokens."""
    prompts = np.stack([((np.arange(1, 21) * (5 + i) + 3 * i) % 256)
                        for i in range(3)]).astype(np.int32)
    ref_eng = JEngine(setup["cfg"], setup["params"], mesh=setup["mesh"],
                      max_len=32)
    ours = ServeEngine(setup["tcfg"], setup["tparams"], max_len=32,
                       device="cpu")
    a = ref_eng.generate(prompts, max_new=8, fused=fused)
    b = ours.generate(prompts, max_new=8, fused=fused)
    np.testing.assert_array_equal(b["tokens"], np.asarray(a["tokens"]))
    np.testing.assert_array_equal(b["gen_len"], np.asarray(a["gen_len"]))


def test_paged_device_loss_rebuilds_pool_and_ssm_state(setup):
    """A device loss mid-decode on the paged layout: ``rebuild()`` gives a
    fresh pool and a zeroed SSM leaf, the requests re-prefill from host
    state, and tokens, recovery log and injector events equal the
    reference's under the same (plan, seed)."""
    kw = dict(page_size=4)
    lens = [3, 5, 2, 7]
    ref_eng = JEngine(setup["cfg"], setup["params"], mesh=setup["mesh"],
                      max_len=12, **kw)
    ours = ServeEngine(setup["tcfg"], setup["tparams"], max_len=12,
                       device="cpu", **kw)
    out = []
    for eng, sched_cls, req_cls, inj in (
            (ref_eng, JScheduler, JRequest,
             JInjector(JPlan(device_loss_at=5), seed=0)),
            (ours, ContinuousBatchingScheduler, Request,
             FaultInjector(FaultPlan(device_loss_at=5), seed=0))):
        sched = sched_cls(eng, max_slots=2, faults=inj)
        run = sched.run(_requests(req_cls, lens, seed=1))
        assert inj.fired("device_loss") == 1 and run["recoveries"] == 1
        assert eng._pager.pool.pages_in_use == 0
        out.append(([r.tokens.tolist() for r in run["results"]],
                    [(e["event"], e.get("uid"), e["iteration"])
                     for e in sched.recovery_log], inj.events))
    assert out[1] == out[0]
