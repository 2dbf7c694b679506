"""The port's training path against the JAX package's, on the CPU at the
reduced configs: the data pipeline, AdamW (float32 and int8 moments), the
loss of every family, and three train steps (the gradients are in
``tests/test_torch_train_grads.py``).

Tolerances, each with the value measured when it was set:

* batches: bit-identical (numpy in both packages).
* ``apply_updates`` against the jitted JAX one (``make_train_step`` jits
  it), 12 steps through warmup and the cosine, float32 and int8 moments,
  gradients below and above ``grad_clip``.  ``lr`` within one float32 ulp
  (XLA's CPU ``cos`` is not correctly rounded; measured 1, at a few
  steps), ``grad_norm`` within 4 ulps (measured 3: XLA sums each leaf's
  squares in a shape-dependent order, its tree-reduction rewrite with
  fused multiply-adds, that the port does not follow), the int8 codes and
  the step identical (measured: no code of 188,928 moved).  With float32
  moments and no clipping (the clip factor exactly 1), ``m``, ``v`` and
  the params are bit-identical, the params until ``lr`` first differs
  (measured: step 4).  Otherwise each float leaf is held to a relative norm
  error of 1e-6 (measured 8.5e-9 after the ``lr`` ulp, 2.2e-7 clipping,
  3.0e-7 int8 moments clipping): one ulp of the clip factor moves every
  later value, and XLA picks which product of an int8 moment's update it
  fuses into an FMA by the leaf's shape and padding.
* the loss value against the jitted JAX ``loss_fn`` at ``use_pallas=True``
  (its flash kernel in interpret mode), bf16 compute: relative 1e-4
  (measured 0 stablelm, 8.6e-8 gemma2, 1.7e-7 hymba, 1.0e-5 MoE, 2.9e-5
  rwkv6, 3.2e-5 the VLM, 5.3e-5 seamless: their forward logits sit within
  the bf16 ulps their forward tests allow, and MoE's ``aux`` sums its 16
  experts in another order, 5.9e-6).
* three ``make_train_step`` steps against the JAX ``make_train_step``
  from the same params and state, float32 compute
  (``torch_train_cases.assert_step_close``): loss, total and grad_norm
  within a relative 1e-5, each param's update within a relative norm error
  of 2e-2 (measured 1.3e-5 here, 7.2e-3 at the second step of
  ``tests/test_torch_ckpt.py``), ``lr`` equal.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the parity tests need the JAX package

import jax.numpy as jnp

from repro.data import pipeline as jpipe
from repro.models import api as japi
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch.data import pipeline as tpipe
from repro_torch.models import api
from repro_torch.models.api import opt_state_from_numpy, params_from_numpy
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep
from torch_train_cases import (FAMILIES, assert_step_close, auto_mesh,
                               configs, jax_batch, jax_leaves, numpy_batch,
                               numpy_params, torch_batch)


@pytest.fixture(scope="module")
def mesh():
    return auto_mesh()


# ----------------------------------------------------------------------------
# data
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("seed, step, shard, num_shards, frontend", [
    (0, 0, 0, 1, 0), (3, 17, 1, 4, 0), (7, 2, 0, 2, 5)])
def test_batches_are_bit_identical(seed, step, shard, num_shards, frontend):
    kw = dict(vocab_size=512, seq_len=33, global_batch=8, seed=seed,
              frontend_tokens=frontend, d_model=16 if frontend else 0)
    want = jpipe.global_batch_at_step(jpipe.DataConfig(**kw), step, shard,
                                      num_shards)
    got = tpipe.global_batch_at_step(tpipe.DataConfig(**kw), step, shard,
                                     num_shards)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    loader = tpipe.DataLoader(tpipe.DataConfig(**kw), start_step=step,
                              shard=shard, num_shards=num_shards)
    np.testing.assert_array_equal(next(loader)["tokens"], want["tokens"])
    assert loader.state_dict() == {"step": step + 1}


# ----------------------------------------------------------------------------
# optimizer
# ----------------------------------------------------------------------------
SHAPES = {"blocks": {"w": (2, 1, 48, 40), "ln": (2, 1, 48)},
          "embed": (50, 64), "cross": [(7, 9, 11)]}


def _tree(rng, scale, shapes=SHAPES):
    if isinstance(shapes, dict):
        return {k: _tree(rng, scale, v) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_tree(rng, scale, v) for v in shapes]
    return (rng.standard_normal(shapes) * scale).astype(np.float32)


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _run_both(quantize, grad_scale, steps=12):
    rng = np.random.default_rng(0)
    params = _tree(rng, 0.5)
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=steps,
              quantize_moments=quantize, moment_block=64)
    cfg, tcfg = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init_state(jp, cfg)
    tp = params_from_numpy(params, "cpu")
    ts = topt.init_state(tp, tcfg)
    upd = jax.jit(jopt.apply_updates, static_argnums=3)
    for _ in range(steps):
        grads = _tree(rng, grad_scale)
        jp, js, jm = upd(jp, jax.tree.map(jnp.asarray, grads), js, cfg)
        tp, ts, tm = topt.apply_updates(tp, params_from_numpy(grads, "cpu"),
                                        ts, tcfg)
        yield ({"params": jp, "opt": js}, {"params": tp, "opt": ts},
               {k: np.float32(v) for k, v in jm.items()},
               {k: np.float32(v.numpy()) for k, v in tm.items()})


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("clip", [False, True])
def test_apply_updates_matches_jitted_jax(quantize, clip):
    exact = not (quantize or clip)
    lr_off = False
    for j, t, jm, tm in _run_both(quantize, 0.5 if clip else 2e-3):
        assert (jm["grad_norm"] > 1.0) == clip    # whether the clip acts
        assert _ulps(jm["grad_norm"], tm["grad_norm"]) <= 4
        lr_ulps = int(_ulps(jm["lr"], tm["lr"]))
        assert lr_ulps <= 1
        lr_off |= lr_ulps == 1
        port = dict(topt.leaves(t))
        for key, a in jax_leaves(j):
            b = port[key].numpy()
            if a.dtype != np.float32:             # int8 codes, the step
                np.testing.assert_array_equal(b, a, err_msg=key)
            elif exact and (key.startswith("opt/") or not lr_off):
                np.testing.assert_array_equal(b, a, err_msg=key)
            else:
                err = np.linalg.norm(b - a) / np.linalg.norm(a)
                assert err <= 1e-6, (key, err)
    assert int(t["opt"]["step"]) == 12 and (lr_off or not exact)


# ----------------------------------------------------------------------------
# loss and gradients, every family
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_value_matches_jitted_jax(arch, mesh):
    cfg, tcfg = configs(arch, use_pallas=True)
    tree, batch = numpy_params(cfg), numpy_batch(cfg)
    with mesh:
        jt, jm = jax.jit(lambda p, b: japi.loss_fn(p, b, cfg))(
            jax.tree.map(jnp.asarray, tree), jax_batch(batch))
    with torch.no_grad():
        tt, tm = api.loss_fn(params_from_numpy(tree, "cpu"),
                             torch_batch(batch), tcfg)
    for a, b in ((jt, tt), (jm["loss"], tm["loss"]), (jm["aux"], tm["aux"])):
        np.testing.assert_allclose(float(b), float(a), rtol=1e-4, atol=0)
    assert (float(tm["aux"]) > 0) == bool(cfg.moe)


# ----------------------------------------------------------------------------
# the train step
# ----------------------------------------------------------------------------
def test_three_train_steps_match_jax_make_train_step(mesh):
    cfg, tcfg = configs("stablelm-1.6b", dtype="float32")
    optkw = dict(lr=1e-2, warmup_steps=2, total_steps=3)
    tree = numpy_params(cfg)
    with mesh:
        jp = jax.tree.map(jnp.asarray, tree)
        js = jopt.init_state(jp, jopt.AdamWConfig(**optkw))
        jfn = jstep.make_train_step(cfg, jopt.AdamWConfig(**optkw), mesh, jp,
                                    js)
    tp = params_from_numpy(tree, "cpu")
    ts = topt.init_state(tp, topt.AdamWConfig(**optkw))
    tfn = tstep.make_train_step(tcfg, topt.AdamWConfig(**optkw))
    for i in range(3):
        batch = numpy_batch(cfg, seed=10 + i)
        before = dict(jax_leaves({"params": jp}))
        with mesh:
            jp, js, jm = jfn(jp, js, jax_batch(batch))
        tp, ts, tm = tfn(tp, ts, batch)
        assert_step_close(jp, jm, tp, tm, before)
        assert float(tm["lr"]) == float(jm["lr"])
        np.testing.assert_allclose(float(tm["total"]), float(jm["total"]),
                                   rtol=1e-5)
    assert int(ts["step"]) == int(js["step"]) == 3
    # the carried state continues the reference's run
    ts2 = opt_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    assert int(ts2["step"]) == 3
