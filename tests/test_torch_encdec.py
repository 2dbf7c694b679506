"""The encoder-decoder family (seamless-m4t-medium) on the port against the
JAX package, on the same weights and frontends.

Reduced seamless-m4t-medium: 2 encoder and 2 decoder layers, d_model 64,
4/4 heads of 16, d_ff 128, vocab 256, 8 frontend frames.  The reference
runs jitted on an Auto-axis mesh with ``use_pallas=True`` (its flash kernel
in interpret mode), and its ``init_cache`` eagerly, as its ServeEngine
calls it; its ServeEngine's runs are shared by the tests through a module
fixture.

Tolerances, each beside its check:
* the encoder output, the cross K/V and the decode-step logits:
  bit-identical (each layer is a scan body in the reference, inside which
  XLA keeps the residual sums that reach the next norm in float32:
  ``encdec._residual`` follows it, and rounding them instead changes the
  cross K/V and every decode logit);
* ``forward`` logits: within ULPS bf16 ulps of the largest |logit|, with
  the same argmax.  On some token rows (5 of 12 seeds tried) one position
  of the decoder's self-attention path flips a bf16 rounding that the
  later positions carry; it stays with the cross blocks' output zeroed
  and under ``--xla_allow_excess_precision=false`` against a port that
  rounds every sum, so it is neither the cross path nor excess precision
  (the known ``rmsnorm`` rsqrt difference inside the compiled program is
  the likely source, ROADMAP queue 3, item 8); measured: at most 0.75 ulp;
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
from repro.models import encdec as jed
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import api, encdec
from repro_torch.models.api import params_from_numpy
from repro_torch.serve.engine import ServeEngine
from torch_cases import bf16_ulp_of

ARCH = "seamless-m4t-medium"
MAX_LEN, MAX_NEW = 32, 6
ULPS = 2


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(get_config(ARCH).reduced(), use_pallas=True)
    tcfg = t_get_config(ARCH).reduced()
    assert tcfg.num_encoder_layers == 2 and tcfg.frontend_tokens == 8
    params = jax.jit(japi.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, 256, (3, 7)).astype(np.int32)
    frontend = rng.standard_normal(
        (3, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    jeng = JEngine(cfg, params, mesh=mesh, max_len=MAX_LEN)
    teng = ServeEngine(tcfg, tparams, max_len=MAX_LEN, device="cpu")
    return dict(cfg=cfg, tcfg=tcfg, params=params, tparams=tparams,
                mesh=mesh, prompts=prompts, frontend=frontend, jeng=jeng,
                teng=teng, runs={})


def test_params_layout_matches(setup):
    """``init_params`` draws the reference's tree: the same keys and
    shapes, stacked by layer."""
    ours = encdec.init_params(setup["tcfg"], torch.Generator().manual_seed(0),
                              device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(setup["params"])[0]

    def at(tree, path):
        for k in path:
            tree = tree[k.key]
        return tree
    for path, leaf in flat:
        assert tuple(at(ours, path).shape) == leaf.shape, path
    assert len(flat) == sum(1 for _ in jax.tree_util.tree_leaves(
        jax.tree.map(np.asarray, setup["params"])))


def test_encode_bit_identical(setup):
    s = setup
    with s["mesh"]:
        want = jax.jit(lambda p, f: jed.encode(p, f, s["cfg"]))(
            s["params"], jnp.asarray(s["frontend"]))
    got = encdec.encode(s["tparams"], torch.from_numpy(s["frontend"]),
                        s["tcfg"])
    np.testing.assert_array_equal(got.float().numpy(), _f32(want))


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
        assert tuple(tc[key].shape) == (2, 3, 4, 8, 16)
        np.testing.assert_array_equal(tc[key].float().numpy(), _f32(jc[key]))
    assert tuple(tc["k"].shape) == (2, 3, 4, MAX_LEN, 16)


def test_decode_step_logits_bit_identical(setup):
    """Twelve jitted reference decode steps against the port's, from the
    same cross K/V."""
    s = setup
    cfg, tcfg = s["cfg"], s["tcfg"]
    toks = np.random.default_rng(4).integers(1, 256, (3, 12)).astype(np.int32)
    with s["mesh"]:
        jc = japi.init_cache(cfg, 3, MAX_LEN,
                             frontend=jnp.asarray(s["frontend"]),
                             params=s["jeng"].params)
    tc = api.init_cache(tcfg, 3, MAX_LEN,
                        frontend=torch.from_numpy(s["frontend"]),
                        params=s["teng"].params, device="cpu")
    step = jax.jit(lambda p, c, t: jed.decode_step(p, c, t, cfg))
    for t in range(12):
        with s["mesh"]:
            jl, jc = step(s["jeng"].params, jc, jnp.asarray(toks[:, t]))
        tl, tc = api.decode_step(s["teng"].params, tc,
                                 torch.from_numpy(toks[:, t]), tcfg)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert int(tc["len"][0]) == 12


def test_forward_matches_jax(setup):
    """Two rows of 12 tokens (a case with the flip of the module
    docstring): the jitted reference forward against ``api.forward`` on the
    converted float32 params."""
    s = setup
    cfg = s["cfg"]
    toks = np.random.default_rng(5).integers(1, 256, (2, 12)).astype(np.int32)
    fe = s["frontend"][:2]
    with s["mesh"]:
        jl, _ = jax.jit(lambda p, t, f: japi.forward(p, t, cfg, frontend=f))(
            s["params"], jnp.asarray(toks), jnp.asarray(fe))
    tl, aux = api.forward(s["tparams"], torch.from_numpy(toks), s["tcfg"],
                          frontend=torch.from_numpy(fe))
    assert aux == 0.0 and tl.dtype == torch.float32
    jl = np.asarray(jl)
    assert np.abs(tl.numpy() - jl).max() <= ULPS * bf16_ulp_of(
        np.abs(jl).max())
    np.testing.assert_array_equal(tl.numpy().argmax(-1), jl.argmax(-1))


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


@pytest.mark.parametrize("eos", [None, 114], ids=["no_eos", "eos"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "stepwise"])
def test_generate_matches_jax(setup, fused, eos):
    """Three prompts of 7 tokens, 6 new: tokens, ``gen_len`` and meter bytes
    identical; row 2 emits 114 at its third step and rows 0 and 1 never
    do, so ``eos_id`` stops one row early."""
    (jo, jb), (to, tb) = (_generate(setup, w, fused, eos)
                          for w in ("jax", "port"))
    np.testing.assert_array_equal(to["tokens"], jo["tokens"])
    np.testing.assert_array_equal(to["gen_len"], np.asarray(jo["gen_len"]))
    assert tb == jb
    if eos is not None:
        assert to["gen_len"].tolist() == [MAX_NEW, MAX_NEW, 3]


def test_init_slot_cache_refused_as_in_jax(setup):
    with pytest.raises(ValueError) as jerr:
        setup["jeng"].init_slot_cache(2)
    with pytest.raises(ValueError) as terr:
        setup["teng"].init_slot_cache(2)
    assert str(terr.value) == str(jerr.value)


def test_decode_step_needs_the_cross_cache(setup):
    cache = api.init_cache(setup["tcfg"], 1, 8, device="cpu")
    with pytest.raises(ValueError, match="cross K/V"):
        api.decode_step(setup["teng"].params, cache,
                        torch.tensor([3], dtype=torch.int32), setup["tcfg"])
