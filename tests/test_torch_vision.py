"""The VLM cross-attention path (llama-3.2-vision-11b) on the port against
the JAX package, on the same weights and frontends.

Reduced llama-3.2-vision-11b: 4 layers in 2 groups of 2, a cross block
after each group, d_model 64, GQA 4/2 heads of 16, d_ff 128, vocab 256, 8
frontend tokens.  The cross gates start at zero in both packages
(``tanh(0) = 0`` hides the cross path), so the shared numpy tree sets them
to 0.7 and -0.9.  The reference runs jitted on an Auto-axis mesh with
``use_pallas=True`` (its flash kernel in interpret mode); its ServeEngine's
runs are shared by the tests through a module fixture.

Tolerances, each beside its check:
* ``attn_apply(kv=)`` and the cross K/V of ``init_cache``: bit-identical;
* block-prefill, decode-step and ``forward`` logits: within ULPS bf16 ulps
  of the largest |logit|, with the same greedy tokens.  The first
  difference is one bf16 rounding of the first layer's roped K in one row
  (XLA's sin / cos and its contraction of the rope inside the compiled
  program; the same K from a standalone rope, and every norm's output,
  are the port's bits), which the later layers carry; measured: at most
  one ulp;
* ``generate()`` fused and stepwise, with and without ``eos_id``: tokens,
  ``gen_len`` and meter bytes identical.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the parity tests need the JAX package

import jax.numpy as jnp
from jax.sharding import AxisType

from repro.configs import get_config
from repro.models import api as japi
from repro.models import layers as jL
from repro.models import transformer as jtr
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.models.api import params_from_numpy
from repro_torch.serve.engine import ServeEngine
from torch_cases import bf16_ulp_of

ARCH = "llama-3.2-vision-11b"
GATES = (0.7, -0.9)
ULPS = 2
MAX_LEN, MAX_NEW = 32, 6


def _jax_params(cfg, gates):
    params = jax.jit(japi.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    tree["cross"]["gate"] = np.asarray(gates, np.float32)
    return tree


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(get_config(ARCH).reduced(), use_pallas=True)
    tcfg = t_get_config(ARCH).reduced()
    assert tcfg.cross_attn_every == 2 and tcfg.num_layers == 4
    tree = _jax_params(cfg, GATES)
    params = jax.tree.map(jnp.asarray, tree)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, 256, (3, 7)).astype(np.int32)
    frontend = rng.standard_normal(
        (3, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    jeng = JEngine(cfg, params, mesh=mesh, max_len=MAX_LEN)
    teng = ServeEngine(tcfg, params_from_numpy(tree, "cpu"), max_len=MAX_LEN,
                       device="cpu")
    return dict(cfg=cfg, tcfg=tcfg, params=params,
                tparams=params_from_numpy(tree, "cpu"), mesh=mesh,
                prompts=prompts, frontend=frontend, jeng=jeng, teng=teng,
                runs={})


def _hold(tl, jl):
    """Logits within ULPS bf16 ulps of the largest |logit| and the same
    argmax (module docstring); True when bit-identical."""
    jl = np.asarray(jl)
    tl = tl.numpy()
    assert np.abs(tl - jl).max() <= ULPS * bf16_ulp_of(np.abs(jl).max())
    np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))
    return bool((tl == jl).all())


def test_attn_apply_cross_matches_jax(setup):
    """Cross-attention of 5 query rows over 9 keys at 4/2 heads of 16
    (the reference projects and drops wk / wv of x; the port skips them):
    bit-identical."""
    rng = np.random.default_rng(3)
    p = {k: rng.uniform(-0.1, 0.1, s).astype(np.float32)
         for k, s in (("wq", (64, 64)), ("wk", (64, 32)), ("wv", (64, 32)),
                      ("wo", (64, 64)))}
    x = jnp.asarray(rng.standard_normal((2, 5, 64)), jnp.bfloat16)
    k, v = (jnp.asarray(rng.standard_normal((2, 2, 9, 16)), jnp.bfloat16)
            for _ in range(2))
    want = jax.jit(lambda p, x, k, v: jL.attn_apply(
        p, x, num_heads=4, num_kv_heads=2, head_dim=16,
        positions=jnp.zeros((1,), jnp.int32), rope_theta=1e4, kv=(k, v),
        use_pallas=True))({k_: jnp.asarray(a) for k_, a in p.items()},
                          x, k, v)

    def t(a):
        return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(
            torch.bfloat16)
    got = L.attn_apply({k_: torch.from_numpy(a) for k_, a in p.items()},
                       t(x), num_heads=4, num_kv_heads=2, head_dim=16,
                       positions=None, rope_theta=1e4, kv=(t(k), t(v)))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_init_cache_cross_kv_bit_identical(setup):
    s = setup
    with s["mesh"]:
        jc = japi.init_cache(s["cfg"], 3, MAX_LEN,
                             frontend=jnp.asarray(s["frontend"]),
                             params=s["jeng"].params)
    tc = api.init_cache(s["tcfg"], 3, MAX_LEN,
                        frontend=torch.from_numpy(s["frontend"]),
                        params=s["teng"].params, device="cpu")
    for key in ("cross_k", "cross_v"):
        assert tuple(tc[key].shape) == (2, 3, 2, 8, 16)
        np.testing.assert_array_equal(
            tc[key].float().numpy(),
            np.asarray(jc[key].astype(jnp.float32)))
        assert tc[key][1].is_contiguous()      # no copy before the kernel


def test_prefill_and_decode_logits(setup):
    """The jitted reference prefill (8 tokens) and 4 decode steps against
    the port's, from the same cross K/V."""
    s = setup
    cfg, tcfg = s["cfg"], s["tcfg"]
    toks = np.random.default_rng(4).integers(1, 256, (3, 12)).astype(np.int32)
    with s["mesh"]:
        jc = japi.init_cache(cfg, 3, MAX_LEN,
                             frontend=jnp.asarray(s["frontend"]),
                             params=s["jeng"].params)
        jl, jc = jax.jit(lambda p, c, t: jtr.prefill(p, c, t, cfg))(
            s["jeng"].params, jc, jnp.asarray(toks[:, :8]))
    tc = api.init_cache(tcfg, 3, MAX_LEN,
                        frontend=torch.from_numpy(s["frontend"]),
                        params=s["teng"].params, device="cpu")
    tl, tc = api.prefill(s["teng"].params, tc, torch.from_numpy(toks[:, :8]),
                         tcfg)
    _hold(tl, jl)
    step = jax.jit(lambda p, c, t: jtr.decode_step(p, c, t, cfg))
    for t in range(8, 12):
        with s["mesh"]:
            jl, jc = step(s["jeng"].params, jc, jnp.asarray(toks[:, t]))
        tl, tc = api.decode_step(s["teng"].params, tc,
                                 torch.from_numpy(toks[:, t]), tcfg)
        _hold(tl, jl)
    assert int(tc["len"][0]) == 12


def test_forward_matches_jax(setup):
    """Two rows of 12 tokens: the jitted reference forward against
    ``api.forward`` on the converted float32 params."""
    s = setup
    cfg = s["cfg"]
    toks = np.random.default_rng(5).integers(1, 256, (2, 12)).astype(np.int32)
    fe = s["frontend"][:2]
    with s["mesh"]:
        jl, _ = jax.jit(lambda p, t, f: japi.forward(p, t, cfg, frontend=f))(
            s["params"], jnp.asarray(toks), jnp.asarray(fe))
    tl, aux = api.forward(s["tparams"], torch.from_numpy(toks), s["tcfg"],
                          frontend=torch.from_numpy(fe))
    assert aux == 0.0 and tl.shape == (2, 12, 256)
    _hold(tl, jl)


def _generate(setup, which, fused, eos):
    key = (which, fused, eos)
    if key not in setup["runs"]:
        eng = setup["jeng" if which == "jax" else "teng"]
        eng.meter.reset()
        fe = setup["frontend"]
        if which == "jax":
            with setup["mesh"]:
                out = eng.generate(setup["prompts"], max_new=MAX_NEW,
                                   frontend=jnp.asarray(fe), fused=fused,
                                   eos_id=eos)
        else:
            out = eng.generate(setup["prompts"], max_new=MAX_NEW,
                               frontend=fe, fused=fused, eos_id=eos)
        setup["runs"][key] = (out, eng.measured_bytes())
    return setup["runs"][key]


@pytest.mark.parametrize("eos", [None, 174], ids=["no_eos", "eos"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "stepwise"])
def test_generate_matches_jax(setup, fused, eos):
    """Three prompts of 7 tokens, 6 new: tokens, ``gen_len`` and meter bytes
    identical; rows 1 and 2 emit 174 at their first step and row 0 never
    does, so ``eos_id`` stops rows at different steps."""
    (jo, jb), (to, tb) = (_generate(setup, w, fused, eos)
                          for w in ("jax", "port"))
    np.testing.assert_array_equal(to["tokens"], jo["tokens"])
    np.testing.assert_array_equal(to["gen_len"], np.asarray(jo["gen_len"]))
    assert tb == jb
    if eos is not None:
        assert sorted(set(to["gen_len"].tolist())) != [MAX_NEW]


def test_fused_and_stepwise_agree(setup):
    a, _ = _generate(setup, "port", True, None)
    b, _ = _generate(setup, "port", False, None)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_init_slot_cache_refused_as_in_jax(setup):
    with pytest.raises(ValueError) as jerr:
        setup["jeng"].init_slot_cache(2)
    with pytest.raises(ValueError) as terr:
        setup["teng"].init_slot_cache(2)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("gates", [(0.0, 0.0), GATES], ids=["zero", "set"])
def test_zero_gate_hides_the_frontend(setup, gates):
    """With both gates 0 (a fresh model's) two frontends give the same
    logits, bit for bit; with the gates set they do not: a port that
    dropped the cross block would pass the parity tests of a zero-gate
    model."""
    s = setup
    tree = _jax_params(s["cfg"], gates)
    eng = ServeEngine(s["tcfg"], params_from_numpy(tree, "cpu"),
                      max_len=MAX_LEN, device="cpu")
    toks = torch.from_numpy(s["prompts"])
    logits = []
    other = np.random.default_rng(6).standard_normal(
        s["frontend"].shape).astype(np.float32)
    for fe in (s["frontend"], other):
        lg, _ = api.forward(eng.params, toks, s["tcfg"],
                            frontend=torch.from_numpy(fe))
        logits.append(lg)
    same = torch.equal(logits[0], logits[1])
    assert same == (gates == (0.0, 0.0))
