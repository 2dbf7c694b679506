"""The port's train step on a ``(data, model)`` grid of gloo ranks on the
CPU, against the JAX package's partitioned ``make_train_step`` and the
port's own one-device step.

granite-8b reduced (2 layers, d 64, 4/2 heads, d_ff 128, vocab 256: every
rule cuts at tp 2), float32 compute, batches of 4 x 16 with a masked
tenth.  The JAX package runs on an Auto ``(2, 2)`` mesh of four forced host
devices, in a subprocess started before the ranks; the ranks are one spawn
per grid shape, the (2, 2) grid's beside the others'.

Bounds, each with the value measured when it was set:

* ``(2, 2)`` against the JAX ``make_train_step`` on the (2, 2) mesh, 2
  steps from the JAX package's params: ``torch_train_cases.
  assert_step_close`` (loss and grad_norm within a relative 1e-5, each
  update within a relative norm error of 2e-2; measured: loss and
  grad_norm equal at step 1, 8.4e-8 and 1.6e-7 at step 2, updates 1.5e-4
  and 1.1e-4), ``lr`` equal.  With int8 moments each step starts from the
  same params and state on both sides (step 1 from the init, step 2 from
  the port's one-device step 1): a moment code that flips on a last-bit
  difference of the gradients would otherwise change the next update by up
  to m / eps (the reference's own int8 moments do so, ROADMAP queue 3,
  item 13); measured: loss and grad_norm equal, updates 1.5e-4 and 7.4e-3
  (the compiled int8 update fuses its products by leaf shape, queue 3,
  item 12).
* against the port's one-device step, 2 steps: loss within a relative
  1e-6 (measured 8.4e-8), grad_norm 2e-6 (measured 3.3e-7), each param
  leaf within a relative norm error of 1e-4 of the one-device step's
  (measured 1.1e-5), at (2, 2), (1, 2) and (2, 1); under remat "full" at
  (2, 2) the same values as without it, bit for bit; every rank's metrics
  the same, each rank's leaves cut as ``train_param_cuts`` says.
* every other family at (2, 1) (stablelm, gemma2, phi3.5-moe with its
  ``aux``, rwkv6 through ``RWKV6ScanFn``'s CPU path, hymba, the VLM, the
  encoder-decoder; the port's seeded params, float32 compute): the same
  bounds against the one-device step, ``aux`` within 1e-6 absolute
  (measured: loss 1.7e-7, grad_norm 3.2e-7, aux 2.4e-7, params 1.8e-5).
  Their training at tp > 1 is ``test_torch_tp_train_families.py``'s.
* checkpoints: a state saved at (2, 2) restores at (1, 1) bit for bit, and
  a one-device state restores at (2, 2) bit for bit.
* the CLI at ``--dp 2 --tp 2``: the reference's log lines, a JSON last
  line, ``"mesh": [2, 2]`` in the checkpoint's metadata, its first loss
  within a relative 1e-3 of the one-device CLI's (bf16 compute).
"""
import concurrent.futures
import dataclasses
import json
import os
import pickle
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.distributed import runtime
from repro_torch.launch import train as train_cli
from repro_torch.models import api
from repro_torch.train import optimizer as topt
from torch_dist_cases import (ARCH, OPT, numpy_batch, one_device, port_cfg,
                              train_rank)
from torch_train_cases import (FAMILIES, assert_step_close, configs,
                               numpy_params)

F32 = {"dtype": "float32"}
Q8 = dict(OPT, quantize_moments=True)
REMAT = {"dtype": "float32",
         "parallel": dataclasses.replace(port_cfg().parallel, remat="full")}

_JAX = """
    import dataclasses, pickle
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.train import optimizer as jopt
    from repro.train import step as jstep

    with open({path!r}, "rb") as f:
        inp = pickle.load(f)
    cfg = dataclasses.replace(get_config({arch!r}).reduced(),
                              dtype="float32", use_pallas=False)
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    out = {{}}
    for name, opt in inp["opts"].items():
        ocfg = jopt.AdamWConfig(**opt)
        with mesh:
            jp = jax.tree.map(jnp.asarray, inp["params"])
            js = jopt.init_state(jp, ocfg)
            fn = jstep.make_train_step(cfg, ocfg, mesh, jp, js)
            hist = []
            for b in inp["batches"]:
                jp, js, m = fn(jp, js, {{k: jnp.asarray(v)
                                        for k, v in b.items()}})
                hist.append(({{k: float(v) for k, v in m.items()}},
                             jax.tree.map(np.asarray, jp),
                             jax.tree.map(np.asarray, js)))
        out[name] = hist
    # int8 moments: one step from a given params and state
    def q8(node):
        if isinstance(node, dict) and "__q8__" in node:
            return jopt._QMoment(*node["__q8__"])
        if isinstance(node, dict):
            return {{k: q8(v) for k, v in node.items()}}
        return node
    p1, s1 = inp["q8_from"]
    ocfg = jopt.AdamWConfig(**inp["opts"]["q8"])
    with mesh:
        jp = jax.tree.map(jnp.asarray, p1)
        js = jax.tree.map(jnp.asarray, q8(s1))
        fn = jstep.make_train_step(cfg, ocfg, mesh, jp, js)
        jp, js, m = fn(jp, js, {{k: jnp.asarray(v)
                                for k, v in inp["batches"][1].items()}})
    out["q8_from"] = [({{k: float(v) for k, v in m.items()}},
                       jax.tree.map(np.asarray, jp),
                       jax.tree.map(np.asarray, js))]
    with open({path!r} + ".out", "wb") as f:
        pickle.dump(out, f)
"""


def _numpy_tree(tree, q8=lambda m: topt.QMoment(m.q.numpy(),
                                                   m.scale.numpy())):
    """A port tree as numpy, each int8 moment as ``q8(moment)``."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v, q8) for k, v in tree.items()}
    if isinstance(tree, topt.QMoment):
        return q8(tree)
    return tree.detach().numpy().copy()


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


def _spawn(shape, cases):
    return runtime.spawn(train_rank, shape, (cases,), backend="gloo",
                         devices=["cpu"] * (shape[0] * shape[1]),
                         timeout=600)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_train")
    cfg, _ = configs(ARCH, dtype="float32")
    params = numpy_params(cfg)
    batches = [numpy_batch(cfg.vocab_size, seed=10 + i) for i in range(2)]
    # int8 moments' second step starts, on both sides, from the port's
    # one-device first step
    _, q8p, q8s = one_device(ARCH, F32, Q8, batches[:1], params)
    q8_from = (_numpy_tree(q8p), _numpy_tree(q8s))
    path = str(tmp / "in.pkl")
    with open(path, "wb") as f:
        pickle.dump({"params": params, "batches": batches,
                     "opts": {"f32": OPT, "q8": Q8},
                     "q8_from": (q8_from[0], _numpy_tree(
                         q8s, lambda m: {"__q8__": (m.q.numpy(),
                                                    m.scale.numpy())}))}, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
               + os.environ.get("XLA_FLAGS", ""))
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX.format(path=path,
                                                           arch=ARCH))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        # the one-device state that a (2, 2) rank restores
        one_hist, p1, s1 = one_device(ARCH, F32, OPT, batches[:1], params)
        one_dir = str(tmp / "one")
        CheckpointManager(one_dir).save(0, {"params": p1, "opt": s1})
        grid_dir = str(tmp / "grid")
        common = dict(params=params, batches=batches, cfg=F32)
        cases = {
            "f32": dict(common, shape=(2, 2), ckpt_save=grid_dir),
            "q8_step1": dict(common, shape=(2, 2), opt=Q8,
                             batches=batches[:1]),
            "q8_step2": dict(common, shape=(2, 2), opt=Q8,
                             params=q8_from[0], state=q8_from[1],
                             batches=batches[1:]),
            "remat": dict(common, shape=(2, 2), cfg=REMAT),
            "restore": dict(common, shape=(2, 2), batches=[],
                            ckpt_restore=one_dir),
            "f32_12": dict(common, shape=(1, 2)),
            "f32_21": dict(common, shape=(2, 1)),
        }
        for arch in FAMILIES:
            cases[arch] = dict(arch=arch, params=None, batches=[
                numpy_batch(port_cfg(arch).vocab_size, seed=30 + i,
                            frontend=_frontend(arch)) for i in range(2)],
                shape=(2, 1), cfg=F32)
        # the (2, 2) grid beside the two grids of two ranks
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            big = pool.submit(_spawn, (2, 2), cases)
            small = pool.submit(lambda: {s: _spawn(s, cases)
                                         for s in ((1, 2), (2, 1))})
            ranks = {(2, 2): big.result(), **small.result()}
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out + err
    with open(path + ".out", "rb") as f:
        jax_out = pickle.load(f)
    one, _, _ = one_device(ARCH, F32, OPT, batches, params)
    return dict(params=params, batches=batches, jax=jax_out, ranks=ranks,
                one=one, one_restored=dict(p=p1, s=s1), grid_dir=grid_dir,
                cases=cases, q8_from=q8_from)


def _frontend(arch):
    cfg = port_cfg(arch)
    return (cfg.frontend_tokens, cfg.d_model) if cfg.frontend_tokens else None


def _case(setup, name, shape=None):
    shape = shape or tuple(setup["cases"][name]["shape"])
    ranks = setup["ranks"][shape]
    return [r[name] for r in ranks]


def _check_ranks_agree(per_rank):
    for r in per_rank:
        for a, b in zip(r["hist"], per_rank[0]["hist"]):
            assert a["metrics"] == b["metrics"]


def _check_shapes(per_rank, shape, whole):
    """Each rank's leaves are the whole leaves cut where the rules cut."""
    dp, tp = shape
    for r in per_rank:
        for rec in r["hist"]:
            for k, s in rec["shapes"].items():
                want = list(whole[k])
                m, d = r["cuts"][k]
                if m is not None:
                    want[m] //= tp
                if d is not None:
                    want[d] //= dp
                assert list(s) == want, k


def _assert_jax_step(jax_hist, port_rec, before):
    jm, jp, _ = jax_hist
    tp = _params_tree(port_rec["state"])
    assert_step_close(jp, jm, tp, port_rec["metrics"], before)
    assert port_rec["metrics"]["lr"] == jm["lr"]


def _before(tree):
    from torch_train_cases import jax_leaves
    return dict(jax_leaves({"params": tree}))


def test_grid_step_matches_jax_make_train_step(setup):
    per_rank = _case(setup, "f32")
    _check_ranks_agree(per_rank)
    hist = per_rank[0]["hist"]
    before = _before(setup["params"])
    for i, (jh, rec) in enumerate(zip(setup["jax"]["f32"], hist)):
        _assert_jax_step(jh, rec, before)
        before = _before(jh[1])


def test_grid_step_int8_moments_match_jax(setup):
    jq = setup["jax"]["q8"]
    step1 = _case(setup, "q8_step1")
    step2 = _case(setup, "q8_step2")
    for runs in (step1, step2):
        _check_ranks_agree(runs)
    _assert_jax_step(jq[0], step1[0]["hist"][0], _before(setup["params"]))
    _assert_jax_step(setup["jax"]["q8_from"][0], step2[0]["hist"][0],
                     _before(setup["q8_from"][0]))
    # the codes and scales of the reference's whole-leaf blocks
    port = step2[0]["hist"][0]["state"]
    assert any(k.endswith("/.q") for k in port)


def _assert_close_to_one_device(one, hist, loss=1e-6, gnorm=2e-6,
                                leaf=1e-4):
    for o, g in zip(one, hist):
        for k, rtol in (("loss", loss), ("grad_norm", gnorm)):
            np.testing.assert_allclose(g["metrics"][k], o["metrics"][k],
                                       rtol=rtol)
        np.testing.assert_allclose(g["metrics"]["aux"], o["metrics"]["aux"],
                                   rtol=0, atol=1e-6)
        assert g["metrics"]["lr"] == o["metrics"]["lr"]
        for k, a in o["state"].items():
            if k.startswith("params/"):
                b = g["state"][k]
                err = np.linalg.norm(b - a) / max(np.linalg.norm(a), 1e-30)
                assert err <= leaf, (k, err)


@pytest.mark.parametrize("name", ["f32", "f32_12", "f32_21"])
def test_grid_step_matches_the_one_device_step(setup, name):
    per_rank = _case(setup, name)
    _check_ranks_agree(per_rank)
    shape = tuple(setup["cases"][name]["shape"])
    whole = {k: tuple(t.shape) for k, t in topt.leaves(
        api.params_from_numpy(setup["params"], "cpu"))}
    _check_shapes(per_rank, shape, whole)
    _assert_close_to_one_device(setup["one"], per_rank[0]["hist"])


def test_remat_full_gives_the_same_step(setup):
    plain = _case(setup, "f32")[0]["hist"]
    remat = _case(setup, "remat")
    _check_ranks_agree(remat)
    for a, b in zip(plain, remat[0]["hist"]):
        assert a["metrics"] == b["metrics"]
        for k in a["state"]:
            np.testing.assert_array_equal(a["state"][k], b["state"][k])


@pytest.mark.parametrize("arch", FAMILIES)
def test_every_family_at_dp2_matches_the_one_device_step(setup, arch):
    api.check_grid(port_cfg(arch), (2, 1))
    per_rank = _case(setup, arch)
    _check_ranks_agree(per_rank)
    one, _, _ = one_device(arch, F32, OPT, setup["cases"][arch]["batches"])
    _assert_close_to_one_device(one, per_rank[0]["hist"])


def test_checkpoints_cross_grid_shapes(setup):
    # (2, 2) -> (1, 1)
    final = _case(setup, "f32")[0]["hist"][-1]["state"]
    like = {"params": api.params_from_numpy(setup["params"], "cpu")}
    like["opt"] = topt.init_state(like["params"], topt.AdamWConfig(**OPT))
    got, meta = CheckpointManager(setup["grid_dir"]).restore(like)
    assert meta == {"mesh": [2, 2]}
    flat = dict(topt.leaves(got))
    assert sorted(flat) == sorted(final)
    for k, t in flat.items():
        np.testing.assert_array_equal(t.numpy(), final[k], err_msg=k)
    # (1, 1) -> (2, 2)
    per_rank = _case(setup, "restore")
    want = {k: t.detach().numpy() for k, t in topt.leaves(
        {"params": setup["one_restored"]["p"],
         "opt": setup["one_restored"]["s"]})}
    back = per_rank[0]["restored"]["state"]
    assert sorted(back) == sorted(want)
    for k, a in want.items():
        np.testing.assert_array_equal(back[k], a, err_msg=k)
    for r in per_rank:
        for k, s in r["restored"]["shapes"].items():
            whole = list(want[k].shape)
            m, d = r["state_cuts"][k]
            if m is not None:
                whole[m] //= 2
            if d is not None:
                whole[d] //= 2
            assert list(s) == whole, k


_LOG = re.compile(r"^step +\d+ loss \d+\.\d{4} lr \d\.\d{2}e[-+]\d{2} gnorm "
                  r"\d+\.\d{3} med_step \d+ms stragglers \d+$")


def test_cli_trains_on_a_2x2_grid(tmp_path):
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=src)
    ckpt = str(tmp_path / "ckpt")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--dp", "2", "--tp", "2", "--steps",
         "4", "--log-every", "1", "--ckpt-dir", ckpt, "--ckpt-every", "4"],
        env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.strip().splitlines()
    result = json.loads(lines[-1])
    assert sorted(result) == ["first_loss", "last_loss", "steps"]
    assert result["steps"] == 4
    logs = lines[:-1]
    assert len(logs) == 4 and all(_LOG.match(line) for line in logs), logs
    with open(os.path.join(ckpt, "step_3", "manifest.json")) as f:
        assert json.load(f)["metadata"]["mesh"] == [2, 2]
    one = train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                          "--steps", "1"])
    np.testing.assert_allclose(result["first_loss"], one["first_loss"],
                               rtol=1e-3)
