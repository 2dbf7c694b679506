"""Training at tp > 1 for every family, on gloo ranks on the CPU, against the
JAX package's partitioned ``make_train_step`` and the port's own
one-device step.

The configs are ``torch_dist_cases.TP_FAMILIES``: reduced (d 64, 4/2
heads of 16, d_ff 128, vocab 256: every rule cuts at tp 2), float32
compute, the JAX package's seeded params (the VLM's cross gates 0.7 /
-0.9: a zero gate hides the cross path), batches of 4 x 16 with a masked
tenth and, for the VLM and seamless, their frontend.  rwkv6 runs at d 128,
two heads of 64, so that tp 2 cuts its heads; qwen3-moe at 16 experts and
top-8.  Two configs cut no head: hymba at 5/1 heads (as hymba-1.5b's
25/5) with a vocabulary of 257 and d_model 63 (its head and SSM branch
whole on every rank), and rwkv6 at its reduced width (one head).
The JAX package runs on an Auto ``(1, 2)`` mesh of two forced host
devices, in one subprocess started before the ranks; the ranks are one
spawn per grid shape, the two spawns side by side.

Bounds, each with the value measured when it was set:

* ``(1, 2)`` against the JAX ``make_train_step`` on the (1, 2) mesh, 2
  steps, each side from its own previous step: ``torch_train_cases.
  assert_step_close`` (loss and grad_norm within a relative 1e-5, each
  update within a relative norm error of 2e-2), ``lr`` equal, for rwkv6,
  hymba, seamless, phi3.5-moe, the VLM and qwen3-moe.  Measured: loss at
  most 1.7e-7, grad_norm at most 2.7e-6 at step 1 and 8.0e-6 at step 2
  (phi3.5-moe), updates at most 1.9e-4.
* against the port's one-device step, 2 steps, at ``(1, 2)`` (every
  config) and ``(2, 2)`` (all but qwen3-moe and the two configs that cut
  no head): loss within a relative 1e-6, each param leaf within a
  relative norm error of 1e-4, as ``test_torch_dist_train.py`` holds
  granite-8b (measured: loss 4.2e-7, leaves 3.7e-5); grad_norm within
  2e-6 and a MoE's ``aux`` within 1e-6 absolute at step 1 (measured:
  1.3e-7 and equal), and at step 2 within 2e-5 and 5e-6 relative.  The
  looser second-step bounds: AdamW's first update is about ``lr *
  sign(g)`` where ``|g|`` is near ``eps``, so a gradient's float32
  sum-order difference (the row cuts' partial sums, at most 1.2e-6 per
  leaf at step 1) moves such elements of the update by up to its whole
  size, and step 2's values with them: measured grad_norm 7.5e-6 and
  ``aux`` 1.2e-6 (2.6e-6 absolute), both phi3.5-moe at (1, 2).  Every
  rank's metrics are the same, and each rank's leaves are cut as
  ``train_param_cuts`` says.
* the MoE's ``router`` gradient (step 1's first moment, ``(1 - b1) g``
  on both sides) within the leaf bound of the one-device step's, and the
  expert stacks cut on the expert dim (E / 2 a rank).
* a phi3.5-moe state saved at (1, 2) restores at (1, 1) bit for bit, and
  a one-device state restores at (1, 2) bit for bit.
* the CLI at ``--tp 2`` for rwkv6-7b ``--smoke``: a JSON last line,
  ``"mesh": [1, 2]`` in the checkpoint's metadata, its first loss within a
  relative 1e-3 of the one-device CLI's (bf16 compute).
"""
import concurrent.futures
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import get_config
from repro.configs.base import MoEConfig as JMoE
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.distributed import runtime
from repro_torch.models import api
from repro_torch.train import optimizer as topt
from torch_dist_cases import (OPT, TP_FAMILIES, numpy_batch, one_device,
                              port_cfg, train_rank)
from torch_train_cases import assert_step_close, jax_leaves, numpy_params

F32 = {"dtype": "float32"}
JAX_CASES = ("rwkv6", "hymba", "seamless", "phi_moe", "vlm", "qwen_moe")
GRID_22 = ("rwkv6", "hymba", "seamless", "phi_moe", "vlm")
SHAPES = [(name, (1, 2)) for name in TP_FAMILIES] + [
    (name, (2, 2)) for name in GRID_22]
MOE = "phi_moe"

_JAX = """
    import dataclasses, pickle
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.configs.base import MoEConfig
    from repro.train import optimizer as jopt
    from repro.train import step as jstep

    with open({path!r}, "rb") as f:
        inp = pickle.load(f)
    mesh = jax.make_mesh((1, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    ocfg = jopt.AdamWConfig(**inp["opt"])
    out = {{}}
    for name, (arch, over, params, batches) in inp["cases"].items():
        over = dict(over)
        if "moe" in over:
            over["moe"] = MoEConfig(*over["moe"])
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  dtype="float32", use_pallas=False, **over)
        try:
            with mesh:
                jp = jax.tree.map(jnp.asarray, params)
                js = jopt.init_state(jp, ocfg)
                fn = jstep.make_train_step(cfg, ocfg, mesh, jp, js)
                hist = []
                for b in batches:
                    jp, js, m = fn(jp, js, {{k: jnp.asarray(v)
                                            for k, v in b.items()}})
                    hist.append(({{k: float(v) for k, v in m.items()}},
                                 jax.tree.map(np.asarray, jp)))
            out[name] = hist
        except Exception as e:          # a refusal is recorded, not hidden
            out[name] = repr(e)
    with open({path!r} + ".out", "wb") as f:
        pickle.dump(out, f)
"""


def _jax_cfg(arch, over):
    over = dict(over)
    if "moe" in over:
        over["moe"] = JMoE(*over["moe"])
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                               use_pallas=False, **over)


def _batches(cfg):
    fe = ((cfg.frontend_tokens, cfg.d_model) if cfg.frontend_tokens
          else None)
    return [numpy_batch(cfg.vocab_size, seed=40 + i, frontend=fe)
            for i in range(2)]


def _spawn(shape, cases):
    return runtime.spawn(train_rank, shape, (cases,), backend="gloo",
                         devices=["cpu"] * (shape[0] * shape[1]),
                         timeout=600)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_train")
    inputs = {}
    for name, (arch, over) in TP_FAMILIES.items():
        jcfg = _jax_cfg(arch, over)
        inputs[name] = dict(arch=arch, over=over, params=numpy_params(jcfg),
                            batches=_batches(port_cfg(arch, **over)))
    path = str(tmp / "in.pkl")
    with open(path, "wb") as f:
        pickle.dump({"opt": OPT, "cases": {
            n: (inputs[n]["arch"], inputs[n]["over"], inputs[n]["params"],
                inputs[n]["batches"]) for n in JAX_CASES}}, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=2 "
               + os.environ.get("XLA_FLAGS", ""))
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX.format(path=path))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        moe = inputs[MOE]
        moe_kw = dict(F32, **moe["over"])
        # the one-device state that a (1, 2) rank restores
        _, p1, s1 = one_device(moe["arch"], moe_kw, OPT, moe["batches"][:1],
                               moe["params"])
        one_dir = str(tmp / "one")
        CheckpointManager(one_dir).save(0, {"params": p1, "opt": s1})
        grid_dir = str(tmp / "grid")
        cases = {}
        for name, shape in SHAPES:
            c = inputs[name]
            cases[(name, shape)] = dict(
                arch=c["arch"], params=c["params"], batches=c["batches"],
                cfg=dict(F32, **c["over"]), shape=shape)
        cases[(MOE, (1, 2))]["ckpt_save"] = grid_dir
        cases["restore"] = dict(cases[(MOE, (1, 2))], batches=[],
                                ckpt_restore=one_dir)
        del cases["restore"]["ckpt_save"]
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            futures = {s: pool.submit(_spawn, s, cases)
                       for s in ((1, 2), (2, 2))}
            ranks = {s: f.result() for s, f in futures.items()}
        one = {name: one_device(c["arch"], dict(F32, **c["over"]), OPT,
                                c["batches"], c["params"])[0]
               for name, c in inputs.items()}
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out + err
    with open(path + ".out", "rb") as f:
        jax_out = pickle.load(f)
    return dict(inputs=inputs, jax=jax_out, ranks=ranks, one=one,
                one_restored=dict(p=p1, s=s1), grid_dir=grid_dir)


def _case(setup, name, shape):
    return [r[(name, shape)] for r in setup["ranks"][shape]]


def _params_tree(flat):
    """{path: array} of ``params/...`` leaves as a nested torch tree."""
    tree = {}
    for k, a in flat.items():
        if not k.startswith("params/"):
            continue
        node = tree
        parts = k.split("/")[1:]
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(a)
    return tree


def _before(tree):
    return dict(jax_leaves({"params": tree}))


@pytest.mark.parametrize("name", JAX_CASES)
def test_tp2_step_matches_jax_make_train_step(setup, name):
    jhist = setup["jax"][name]
    assert not isinstance(jhist, str), f"the JAX package refused: {jhist}"
    per_rank = _case(setup, name, (1, 2))
    before = _before(setup["inputs"][name]["params"])
    for (jm, jp), rec in zip(jhist, per_rank[0]["hist"]):
        tp = _params_tree(rec["state"])
        assert_step_close(jp, jm, tp, rec["metrics"], before)
        assert rec["metrics"]["lr"] == jm["lr"]
        before = _before(jp)


def _check_ranks_agree(per_rank):
    for r in per_rank:
        for a, b in zip(r["hist"], per_rank[0]["hist"]):
            assert a["metrics"] == b["metrics"]


def _check_shapes(per_rank, shape, whole):
    """Each rank's leaves are the whole leaves cut where the rules cut, and
    at tp 2 the rules cut some."""
    dp, tp = shape
    for r in per_rank:
        assert any(m is not None for m, _ in r["cuts"].values())
        for rec in r["hist"]:
            for k, s in rec["shapes"].items():
                want = list(whole[k])
                m, d = r["cuts"][k]
                if m is not None:
                    want[m] //= tp
                if d is not None:
                    want[d] //= dp
                assert list(s) == want, k


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("name, shape", SHAPES,
                         ids=[f"{n}-{s[0]}x{s[1]}" for n, s in SHAPES])
def test_tp_step_matches_the_one_device_step(setup, name, shape):
    per_rank = _case(setup, name, shape)
    _check_ranks_agree(per_rank)
    inp = setup["inputs"][name]
    whole = {k: tuple(t.shape) for k, t in topt.leaves(
        api.params_from_numpy(inp["params"], "cpu"))}
    _check_shapes(per_rank, shape, whole)
    one = setup["one"][name]
    for i, (o, g) in enumerate(zip(one, per_rank[0]["hist"])):
        np.testing.assert_allclose(g["metrics"]["loss"],
                                   o["metrics"]["loss"], rtol=1e-6)
        np.testing.assert_allclose(g["metrics"]["grad_norm"],
                                   o["metrics"]["grad_norm"],
                                   rtol=2e-6 if i == 0 else 2e-5)
        if i == 0:
            np.testing.assert_allclose(g["metrics"]["aux"],
                                       o["metrics"]["aux"], rtol=0, atol=1e-6)
        else:
            np.testing.assert_allclose(g["metrics"]["aux"],
                                       o["metrics"]["aux"], rtol=5e-6)
        assert g["metrics"]["lr"] == o["metrics"]["lr"]
        for k, a in o["state"].items():
            if k.startswith("params/"):
                err = _rel(g["state"][k], a)
                assert err <= 1e-4, (k, err)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_moe_experts_cut_and_router_gradient(setup, shape):
    """The expert stacks hold E / 2 experts a rank (the router whole), the
    router's gradient (step 1's first moment) and ``aux`` are the
    one-device step's."""
    per_rank = _case(setup, MOE, shape)
    for r in per_rank:
        assert r["cuts"]["blocks/moe/w1"][0] == 2
        assert r["cuts"]["blocks/moe/router"][0] is None
        shapes = r["hist"][0]["shapes"]
        assert shapes["blocks/moe/w1"][2] == port_cfg(
            TP_FAMILIES[MOE][0]).moe.num_experts // 2
    o, g = setup["one"][MOE][0], per_rank[0]["hist"][0]
    key = "opt/m/blocks/moe/router"
    assert np.any(o["state"][key] != 0)
    assert _rel(g["state"][key], o["state"][key]) <= 1e-4
    assert g["metrics"]["aux"] > 0
    np.testing.assert_allclose(g["metrics"]["aux"], o["metrics"]["aux"],
                               rtol=0, atol=1e-6)


def test_moe_checkpoints_cross_grid_shapes(setup):
    inp = setup["inputs"][MOE]
    cfg = port_cfg(inp["arch"], **F32)
    # (1, 2) -> (1, 1)
    final = _case(setup, MOE, (1, 2))[0]["hist"][-1]["state"]
    like = {"params": api.init_params(cfg, torch.Generator(), device="cpu")}
    like["opt"] = topt.init_state(like["params"], topt.AdamWConfig(**OPT))
    got, meta = CheckpointManager(setup["grid_dir"]).restore(like)
    assert meta == {"mesh": [1, 2]}
    flat = dict(topt.leaves(got))
    assert sorted(flat) == sorted(final)
    for k, t in flat.items():
        np.testing.assert_array_equal(t.numpy(), final[k], err_msg=k)
    # (1, 1) -> (1, 2)
    per_rank = [r["restore"] for r in setup["ranks"][(1, 2)]]
    want = {k: t.detach().numpy() for k, t in topt.leaves(
        {"params": setup["one_restored"]["p"],
         "opt": setup["one_restored"]["s"]})}
    back = per_rank[0]["restored"]["state"]
    assert sorted(back) == sorted(want)
    for k, a in want.items():
        np.testing.assert_array_equal(back[k], a, err_msg=k)
    for r in per_rank:
        shapes = r["restored"]["shapes"]
        assert shapes["params/blocks/moe/w2"][2] == cfg.moe.num_experts // 2


@pytest.mark.parametrize("name", sorted(TP_FAMILIES))
def test_check_grid_refuses_no_config(name):
    cfg = port_cfg(TP_FAMILIES[name][0])
    for shape in ((2, 1), (1, 2), (2, 2), (1, 4)):
        api.check_grid(cfg, shape)
    with pytest.raises(ValueError, match="positive sizes"):
        api.check_grid(cfg, (0, 2))


def test_cli_trains_rwkv6_at_tp2(tmp_path):
    from repro_torch.launch import train as train_cli
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=src)
    ckpt = str(tmp_path / "ckpt")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "rwkv6-7b", "--smoke", "--device", "cpu", "--tp", "2", "--steps",
         "2", "--log-every", "1", "--ckpt-dir", ckpt, "--ckpt-every", "2"],
        env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert sorted(result) == ["first_loss", "last_loss", "steps"]
    assert result["steps"] == 2
    with open(os.path.join(ckpt, "step_1", "manifest.json")) as f:
        assert json.load(f)["metadata"]["mesh"] == [1, 2]
    one = train_cli.main(["--arch", "rwkv6-7b", "--smoke", "--device", "cpu",
                          "--steps", "1"])
    np.testing.assert_allclose(result["first_loss"], one["first_loss"],
                               rtol=1e-3)
