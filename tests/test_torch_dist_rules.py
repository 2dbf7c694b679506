"""The training rules of the port's ``distributed/sharding.py`` and its
``launch/mesh.py`` against the JAX package's.

``train_param_cuts`` is held to ``param_pspecs`` leaf by leaf -- the dim
each puts on "model" and the dim on "data" -- for every registry config's
reduced params (the port's own tree, made on the meta device) and for its
whole AdamW state (``{"step", "m", "v"}``, which exercises the
reference's ``m/`` / ``v/`` key rewriting) with float32 and with int8
moments (their ``q`` / ``scale`` leaves), on Auto ``AbstractMesh`` es of
``(2, 1)``, ``(1, 2)``, ``(2, 2)`` and ``(1, 4)`` (no devices).
``batch_cuts`` and ``logits_cut`` are held to ``batch_pspecs`` and
``logits_pspec`` for every kind; ``launch/mesh.py``'s validation raises
the reference's messages.  Every comparison is exact.
"""
import dataclasses
import os

import pytest
import torch

jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh, AxisType, PartitionSpec as P

from repro.configs import CONFIGS, get_config
from repro.distributed import sharding as shd
from repro.launch import mesh as jmesh
from repro.models import api as japi
from repro.train import optimizer as jopt
from repro_torch.configs import get_config as t_get_config
from repro_torch.distributed import runtime, sharding
from repro_torch.launch import mesh as tmesh
from repro_torch.models import api
from repro_torch.train import optimizer as topt

SHAPES = [(2, 1), (1, 2), (2, 2), (1, 4)]
ARCHS = sorted(CONFIGS)


def grid_mesh(shape):
    return AbstractMesh(tuple(shape), ("data", "model"),
                        axis_types=(AxisType.Auto,) * 2)


def _axis_dim(spec, axis):
    dims = [i for i, a in enumerate(tuple(spec))
            if a == axis or (isinstance(a, tuple) and axis in a)]
    assert len(dims) <= 1, spec
    return dims[0] if dims else None


def _jax_cuts(spec_tree):
    """{path: (the dim on "model", the dim on "data")} of a spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {shd._path_str(path): (_axis_dim(s, "model"), _axis_dim(s, "data"))
            for path, s in flat}


def _flat(tree, prefix=""):
    """The same flattening of the port's cut tree: an int8 moment's
    ``q`` / ``scale`` and a QuantizedLinear's ``(codes, scales)`` pair of
    cuts as two paths each."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
    elif isinstance(tree, topt.QMoment):
        out.update(_flat(tree.q, prefix + "q/"))
        out.update(_flat(tree.scale, prefix + "scale/"))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
    elif tree and isinstance(tree[0], tuple):
        out.update(_flat(tree[0], prefix + "codes/"))
        out.update(_flat(tree[1], prefix + "scales/"))
    else:
        out[prefix[:-1]] = tree
    return out


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    name = request.param
    cfg = get_config(name).reduced()
    jparams = jax.eval_shape(lambda: japi.init_params(cfg,
                                                      jax.random.PRNGKey(0)))
    tcfg = t_get_config(name).reduced()
    tparams = api.init_params(tcfg, torch.Generator(), device="meta")
    return dict(cfg=cfg, tcfg=tcfg, jparams=jparams, tparams=tparams)


@pytest.mark.parametrize("shape", SHAPES)
def test_param_cuts_equal_param_pspecs(arch, shape):
    want = _jax_cuts(shd.param_pspecs(arch["jparams"], arch["cfg"],
                                      grid_mesh(shape)))
    got = _flat(sharding.train_param_cuts(arch["tparams"], *shape,
                                          arch["tcfg"]))
    assert got == want
    if shape[1] > 1:
        assert any(m is not None for m, _ in got.values())


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_state_cuts_equal_param_pspecs(arch, shape, quantize):
    """The whole AdamW state, float32 or int8 moments: the rules reach the
    moments through the reference's key rewriting."""
    kw = dict(quantize_moments=quantize, moment_block=64)
    jstate = jax.eval_shape(lambda p: jopt.init_state(p, jopt.AdamWConfig(
        **kw)), arch["jparams"])
    tstate = topt.init_state(arch["tparams"], topt.AdamWConfig(**kw))
    want = _jax_cuts(shd.param_pspecs(jstate, arch["cfg"], grid_mesh(shape)))
    got = _flat(sharding.train_param_cuts(tstate, *shape, arch["tcfg"]))
    assert got == want


@pytest.mark.parametrize("shape", SHAPES)
def test_batch_and_logits_cuts_equal_the_specs(shape):
    for name in ARCHS:
        cfg, tcfg = get_config(name).reduced(), t_get_config(name).reduced()
        # a vocabulary that no model axis divides keeps the logits whole
        for v in (cfg.vocab_size, 255):
            cfg_v = dataclasses.replace(cfg, vocab_size=v)
            tcfg_v = dataclasses.replace(tcfg, vocab_size=v)
            mesh = grid_mesh(shape)
            for kind in ("train", "prefill", "decode"):
                want = {k: _axis_dim(s, "data") for k, s in
                        shd.batch_pspecs(cfg_v, mesh, kind).items()}
                assert sharding.batch_cuts(tcfg_v, *shape, kind) == want
                spec = shd.logits_pspec(cfg_v, mesh, kind)
                assert sharding.logits_cut(tcfg_v, *shape, kind) == (
                    _axis_dim(spec, "data"), _axis_dim(spec, "model"))


def _message(fn, *a, **kw):
    with pytest.raises(ValueError) as e:
        fn(*a, **kw)
    return str(e.value)


@pytest.mark.parametrize("shape, n", [((2, 2), 3), ((0, 2), 0), ((3, 1), 4),
                                      ((1, -1), 1)])
def test_mesh_validation_raises_the_reference_messages(shape, n):
    want = _message(jmesh._validate_shape, shape, list(range(n)),
                    what="make_test_mesh")
    assert _message(tmesh.make_test_mesh, ["cpu"] * n, shape) == want
    assert _message(tmesh._validate_shape, shape, ["cpu"] * n,
                    what="make_test_mesh") == want


def test_mesh_plans():
    """The default shape is (1, n); the ranks are placed by
    ``runtime.plan`` (gloo, the CPU); a shape of three axes and a
    production mesh without cards raise as in the reference."""
    plan = tmesh.make_test_mesh(["cpu"] * 4)
    assert (plan.shape, plan.backend, plan.axes) == ((1, 4), "gloo",
                                                     ("data", "model"))
    plan = tmesh.make_test_mesh(shape=(2, 2), device="cpu")
    assert plan.shape == (2, 2) and plan.devices == ("cpu",) * 4
    assert "must be (dp, tp)" in _message(tmesh.make_test_mesh, ["cpu"] * 8,
                                          (2, 2, 2))
    n = torch.cuda.device_count()
    want = _message(jmesh._validate_shape, (2, 2), list(range(n)),
                    what="make_production_mesh")
    if n != 4:
        assert _message(tmesh.make_production_mesh, (2, 2)) == want
    assert "must have 2 axes" in _message(tmesh.make_production_mesh,
                                          (2, 2, 2))
    assert (plan.backend, list(plan.devices)) == runtime.plan((2, 2), "cpu")


def test_make_test_mesh_defaults_to_the_card(monkeypatch):
    """An entry point of the port: without ``device=`` (and without
    ``devices``) the grid is placed on the card, so a host without one
    raises; the CPU is asked for explicitly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"shape": (1, 2)}, {"shape": (2, 2)}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_test_mesh(**kw)
    assert tmesh.make_test_mesh(shape=(1, 2), device="cpu").devices == (
        "cpu", "cpu")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ["llama2-7b", "tinyllama-1.1b"])
def test_quantized_param_cuts_equal_param_pspecs(name, shape):
    """LAQ-quantized params (``quantize_model``): a QuantizedLinear's codes
    are cut as its weight, its scales on their out dim."""
    cfg, tcfg = get_config(name).reduced(), t_get_config(name).reduced()
    jq = jax.eval_shape(lambda: japi.quantize_model(
        japi.init_params(cfg, jax.random.PRNGKey(0)), cfg))
    tq = api.quantize_model(api.init_params(
        tcfg, torch.Generator().manual_seed(0), device="cpu"), tcfg)
    want = _jax_cuts(shd.param_pspecs(jq, cfg, grid_mesh(shape)))
    got = _flat(sharding.train_param_cuts(tq, *shape, tcfg))
    assert got == want
    assert any(k.endswith("/scales") and m is not None
               for k, (m, _) in got.items()) or shape[1] == 1


@pytest.mark.parametrize("devices, added", [(["cuda:0"] * 2, True),
                                            (["cpu"] * 2, False)])
def test_gloo_ranks_on_a_card_start_with_pinned_buffer_settings(
        monkeypatch, devices, added):
    """``spawn``'s rank environment: gloo's ranks on a card get
    ``GLOO_CUDA_ALLOC_CONF`` after the caller's own settings, ranks on the
    CPU nothing; the caller's environment is restored after."""
    key = "PYTORCH_CUDA_ALLOC_CONF"
    monkeypatch.setenv(key, "expandable_segments:True")
    with runtime._rank_env("gloo", devices):
        got = os.environ[key]
    assert os.environ[key] == "expandable_segments:True"
    want = ",".join(["expandable_segments:True"]
                    + (list(runtime.GLOO_CUDA_ALLOC_CONF) if added else []))
    assert got == want
    monkeypatch.delenv(key)
    with runtime._rank_env("gloo", devices):
        assert (key in os.environ) == added
    assert key not in os.environ


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
@pytest.mark.parametrize("name", ARCHS)
def test_full_width_param_cuts_equal_param_pspecs(name, shape):
    """The published widths (meta tensors and abstract shapes: nothing is
    allocated), where ``_fit``'s shape check decides: hymba-1.5b's
    vocabulary of 32,001 keeps its embedding and head whole at tp 2 while
    its 25/5 heads' columns (1,600 and 320) are cut, seamless's 256,206
    is cut, and a MoE config's experts are cut over "model"."""
    cfg, tcfg = get_config(name), t_get_config(name)
    jparams = jax.eval_shape(lambda: japi.init_params(cfg,
                                                      jax.random.PRNGKey(0)))
    tparams = api.init_params(tcfg, torch.Generator(), device="meta")
    want = _jax_cuts(shd.param_pspecs(jparams, cfg, grid_mesh(shape)))
    got = _flat(sharding.train_param_cuts(tparams, *shape, tcfg))
    assert got == want
    if name == "hymba-1.5b":
        assert got["embed"][0] is None and got["lm_head"][1] is None
        assert got["blocks/attn/wq"][0] is not None
    if name == "seamless-m4t-medium":
        assert got["embed"][0] == 0 and got["lm_head"][0] == 1
    if tcfg.moe:
        assert got["blocks/moe/w1"][0] == 2
        assert got["blocks/moe/router"][0] is None
