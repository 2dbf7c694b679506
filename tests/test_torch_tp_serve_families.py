"""Tensor-parallel serving of the rest of the registry and of the rest of
the entry points, on gloo ranks on the CPU, against the JAX package.

Built as ``tests/test_torch_tp_serve.py`` is built: reduced configs
(vocab 128), numpy params from one seed per case carried across by
``api.params_from_numpy``, the port's ranks spawned once per tp while the
JAX engines run in two background subprocesses (one forced host device,
and two on an Auto ``(1, 2)`` mesh) on the same params.

* The MoE configs through the slot protocol (``torch_tp_cases.slot_run``:
  prompts of 7 and 12 tokens, 8 steps, page 8): reduced phi3.5-moe
  (GQA 4/2: heads cut at tp 2, every head on every rank at tp 4) and
  qwen3-moe with 16 experts, top-8 and GQA 16/4 (cut at tp 2 and 4).
  Every rank's tokens and meter bytes equal the JAX one-device engine's,
  and at tp 2 its TP engine's; the ranks' drop logs are equal.
* The VLM (cross gates 0.7 / -0.9: zero gates hide the cross path) and
  seamless through ``generate()``, fused and stepwise, at tp 2 and 4:
  tokens and meter bytes equal the JAX one-device ``generate()``'s, and at
  tp 2 its TP engine's; a rank's cache (cross K/V projected by its own
  blocks) is the whole cache cut by the serve cache rules.
* ``generate()`` at tp 2 for lm, gemma2, rwkv, hymba (fused and stepwise)
  and split-brain (fused and eager): the port's tp 1 tokens, and the meter
  bytes of the JAX package's TP engine (whose tokens the fused runs also
  equal; the JAX side runs its compiled ``generate()`` only).
* The online layer at tp 2: priorities, preemption, a deadline and a
  seeded chaos plan (a transient NaN corruption, a stalled step and a
  device loss, which rebuilds every rank's cut cache) under
  the scheduler, each rank's loop clock source a ``StepClock`` and rank 1's
  running apart from rank 0's; through the group's shared clock the ranks'
  tokens, request states and recovery events are equal, and equal those
  of one device on rank 0's clock.  With each rank deciding by its own
  source instead the ranks expire the deadline at different iterations
  and leave lockstep.
"""
import json
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.configs import get_config
from repro.configs.base import MoEConfig as JMoE
from repro.models import api as japi
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs.base import MoEConfig
from repro_torch.distributed import runtime, sharding
from repro_torch.models import api
from torch_tp_cases import (StepClock, build_engine, families_rank,
                            generate_run, lockstep_run, mesh_prompts)

KW = dict(max_len=48, page_size=8, paged_attn="inplace")
GEN_KW = dict(max_len=32)
GATES = (0.7, -0.9)
# name: (arch, PRNG key, overrides beside vocab 128, (JAX, port) MoE)
MOE = {"phi": ("phi3.5-moe-42b-a6.6b", 0, {}, None),
       "qwen": ("qwen3-moe-235b-a22b", 1, dict(num_heads=16, num_kv_heads=4),
                (JMoE(16, 8), MoEConfig(16, 8)))}
XATTN = {"vlm": "llama-3.2-vision-11b", "seamless": "seamless-m4t-medium"}
FAMILIES = {"lm": "llama2-7b", "gemma2": "gemma2-27b", "rwkv": "rwkv6-7b",
            "hymba": "hymba-1.5b", "splitbrain": "llama2-7b"}
# the online layer: (prompt length, priority, deadline_s) per request
SCHED = dict(lens=(9, 5, 12, 7, 10, 6, 8),
             prio=(0, 0, 1, 0, 1, 0, 0),
             deadline=(None, 0.12, None, None, None, None, None),
             plan=dict(step_corrupt_at=4, step_corrupt_iters=2,
                       device_loss_at=10, step_stall_at=6,
                       step_stall_s=0.01),
             slots=2, max_new=6)
SKEW = (0.037, 5.0)        # rank 1's clock source: (dt, t0)


def _cases():
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, 127, (3, 7)).astype(np.int32)
    return prompts, rng


# the JAX side: the MoE configs' slot protocol, the cross-attention
# configs' generate() (fused, stepwise) and, on the TP mesh, the families'
# fused generate(); prints one JSON line
_JAX = """
    import dataclasses, json, pickle
    import numpy as np
    import jax
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.configs.base import MoEConfig
    from repro.serve.engine import ServeEngine
    from repro.serve.splitbrain_engine import SplitBrainEngine

    mesh = jax.make_mesh((1, {devices}), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    with open({path!r}, "rb") as f:
        cases = pickle.load(f)
    prompts = [np.asarray(p, np.int32) for p in cases["mesh_prompts"]]

    def cfg_of(arch, over):
        over = dict(over)
        if "moe" in over:
            over["moe"] = MoEConfig(*over["moe"])
        return get_config(arch).reduced(vocab_size=128, **over)

    def slot_run(eng, steps=8):
        cache = eng.init_slot_cache(2)
        toks = np.zeros((2,), np.int32)
        for i, p in enumerate(prompts):
            assert eng.reserve_slot(i, len(p), steps + 2)
            c1, tok = eng.prefill_slot(p)
            cache = eng.insert_slot(cache, c1, i)
            toks[i] = tok
        outs = []
        for _ in range(steps):
            nxt, ok, cache = eng.decode_slots(cache, toks,
                                              np.array([True, True]))
            eng.meter_tokens(2)
            toks = np.asarray(nxt)
            outs.append(toks.tolist())
        return outs, eng.measured_bytes(), eng.cache_stats(cache).get(
            "kv_shards")

    out = {{"moe": {{}}, "gen": {{}}}}
    for name, (arch, over, tree) in cases["moe"].items():
        cfg = dataclasses.replace(cfg_of(arch, over), use_pallas=True)
        eng = ServeEngine(cfg, jax.tree.map(jax.numpy.asarray, tree),
                          mesh=mesh, max_len=48, page_size=8,
                          paged_attn="inplace")
        out["moe"][name] = slot_run(eng)
    for name, (arch, tree, fe, modes) in cases[{which!r}].items():
        sb = name == "splitbrain"
        cfg = dataclasses.replace(cfg_of(arch, {{}}), use_pallas=not sb)
        params = jax.tree.map(jax.numpy.asarray, tree)
        res = {{}}
        for fused in modes:
            if sb:
                eng = SplitBrainEngine(cfg, params, mesh=mesh, max_len=32,
                                       jit=fused)
                got = eng.generate(cases["prompts"], max_new=6)
                nbytes = eng.measured_bytes_per_token()
            else:
                eng = ServeEngine(cfg, params, mesh=mesh, max_len=32)
                got = eng.generate(cases["prompts"], max_new=6,
                                   frontend=fe, fused=fused)
                nbytes = eng.measured_bytes()
            res[str(fused)] = (np.asarray(got["tokens"]).tolist(), nbytes)
        out["gen"][name] = res
    print("JAX_OUT " + json.dumps(out))
"""


def _start_jax(devices, which, path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"),
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices} "
               + os.environ.get("XLA_FLAGS", ""))
    script = textwrap.dedent(_JAX.format(devices=devices, which=which,
                                         path=path))
    return subprocess.Popen([sys.executable, "-c", script], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _jax_result(setup, which):
    if which not in setup["jax"]:
        proc = setup["procs"][which]
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, out + err
        setup["jax"][which] = json.loads(
            out.split("JAX_OUT ", 1)[1].splitlines()[0])
    return setup["jax"][which]


def _jax_tree(arch, key, over=None, moe=None, gates=False):
    kw = dict(over or {})
    if moe is not None:
        kw["moe"] = moe
    cfg = get_config(arch).reduced(vocab_size=128, **kw)
    tree = jax.tree.map(np.asarray, jax.jit(japi.init_params,
                                            static_argnums=0)(
        cfg, jax.random.PRNGKey(key)))
    if gates:
        tree["cross"]["gate"] = np.asarray(GATES, np.float32)
    return cfg, tree


def _sched_spec():
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(1, 127, n).astype(np.int32), p, d)
            for n, p, d in zip(SCHED["lens"], SCHED["prio"],
                               SCHED["deadline"])]
    return dict(arch="llama2-7b", overrides=dict(vocab_size=128),
                params=None, kw=KW, requests=reqs, plan=SCHED["plan"],
                slots=SCHED["slots"], max_new=SCHED["max_new"])


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The numpy params of every case, the JAX subprocesses on them, and
    the port's two spawns (tp 2 with every part, tp 4 with the MoE and
    cross-attention parts), started before anything waits."""
    prompts, rng = _cases()
    moe_specs, jmoe = {}, {}
    for name, (arch, key, over, moe) in MOE.items():
        _, tree = _jax_tree(arch, key, over, moe and moe[0])
        jover = dict(over, **({"moe": (16, 8)} if moe else {}))
        jmoe[name] = (arch, jover, tree)
        moe_specs[name] = dict(
            arch=arch, params=tree, kw=KW,
            overrides=dict(vocab_size=128, **over,
                           **({"moe": moe[1]} if moe else {})))
    xattn, jx = {}, {}
    for name, arch in XATTN.items():
        cfg, tree = _jax_tree(arch, 0, gates=name == "vlm")
        fe = rng.standard_normal((3, cfg.frontend_tokens, cfg.d_model)
                                 ).astype(np.float32)
        jx[name] = (arch, tree, fe, (True, False))
        xattn[name] = dict(arch=arch, params=tree, kw=GEN_KW, prompts=prompts,
                           frontend=fe, overrides=dict(vocab_size=128))
    fams, jf = {}, {}
    for name, arch in FAMILIES.items():
        sb = name == "splitbrain"
        _, tree = _jax_tree(arch, 1 if sb else 0)
        jf[name] = (arch, tree, None, (True,))
        fams[name] = dict(arch=arch, params=tree, kw=GEN_KW, prompts=prompts,
                          splitbrain=sb, overrides=dict(vocab_size=128))
    path = str(tmp_path_factory.mktemp("tp_families") / "cases.pkl")
    with open(path, "wb") as f:
        pickle.dump({"moe": jmoe, "xattn": jx,
                     "tp": {**jx, **jf}, "prompts": prompts,
                     "mesh_prompts": [p.tolist() for p in mesh_prompts()]},
                    f)
    procs = {"one": _start_jax(1, "xattn", path),
             "tp": _start_jax(2, "tp", path)}
    sched = _sched_spec()
    ranks = {}
    for tp in (2, 4):
        gen = {**xattn, **(fams if tp == 2 else {})}
        ranks[tp] = runtime.spawn(
            families_rank, (1, tp),
            (moe_specs, gen, (), sched if tp == 2 else None, SKEW),
            backend="gloo", devices=["cpu"] * tp, timeout=600)
    # one device, in this process: the families' generate() and the
    # online layer on rank 0's clock source
    one = {name: {fused: generate_run(build_engine(spec, None), prompts,
                                      fused)
                  for fused in (True, False)}
           for name, spec in fams.items()}
    one_sched = lockstep_run(build_engine(sched, None), sched,
                             StepClock(0.01))
    state = dict(procs=procs, jax={}, ranks=ranks, one=one,
                 one_sched=one_sched, xattn=xattn)
    yield state
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _want_moe(setup, name, tp):
    return [_jax_result(setup, w)["moe"][name]
            for w in (("one", "tp") if tp == 2 else ("one",))]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", list(MOE))
def test_moe_slot_protocol_matches_the_jax_engines(setup, name, tp):
    """Tokens and meter bytes of every rank equal the JAX one-device
    engine's (and at tp 2 its TP engine's, whose pool ``kv_shards`` the
    port's equals); the ranks route, pad and drop alike."""
    ranks = setup["ranks"][tp]
    for want in _want_moe(setup, name, tp):
        for r, got in enumerate(ranks):
            toks, nbytes, kv, _ = got["moe"][name]
            assert toks.tolist() == want[0], (name, tp, r)
            assert nbytes == want[1], (name, tp, r)
    if tp == 2:
        assert ranks[0]["moe"][name][2] == _want_moe(setup, name, 2)[1][2]
    drops = [got["moe"][name][3] for got in ranks]
    assert drops[0] and all(d == drops[0] for d in drops)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", list(XATTN))
def test_cross_attention_generate_matches_the_jax_engines(setup, name, tp):
    """Fused and stepwise ``generate()``: every rank's tokens and meter
    bytes equal the JAX one-device engine's, and at tp 2 its TP engine's;
    the rank's cache is the whole cache cut by the serve cache rules."""
    ranks = setup["ranks"][tp]
    sources = ["one"] + (["tp"] if tp == 2 else [])
    for which in sources:
        want = _jax_result(setup, which)["gen"][name]
        for r, got in enumerate(ranks):
            for fused in (True, False):
                toks, nbytes = got["gen"][name][fused]
                assert toks.tolist() == want[str(fused)][0], (which, r, fused)
                assert nbytes == want[str(fused)][1], (which, r, fused)
    spec = setup["xattn"][name]
    cfg = t_get_config(spec["arch"]).reduced(vocab_size=128)
    import torch
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    whole = api.init_cache(cfg, 3, GEN_KW["max_len"], device="cpu",
                           frontend=torch.from_numpy(spec["frontend"]),
                           params=params)
    cuts = sharding.serve_cache_cuts(whole, tp)
    want = {}

    def put(path, t):
        shape = list(t.shape)
        c = cuts
        for k in path.split("/"):
            c = c[int(k)] if isinstance(c, list) else c[k]
        if c is not None:
            shape[c] //= tp
        want[path] = shape

    sharding._map_paths(put, whole)
    assert any(k.startswith("cross_") for k in want)
    for got in ranks:
        assert got["cache"][name] == want


@pytest.mark.parametrize("name", list(FAMILIES))
def test_generate_at_tp2_equals_tp1(setup, name):
    """Every rank's ``generate()`` tokens (fused and stepwise / eager)
    equal the one-device engine's, and its meter bytes the JAX package's
    TP engine's (the per-shard entries sum to its totals); the fused
    tokens equal the JAX TP engine's too."""
    want = _jax_result(setup, "tp")["gen"][name]
    for r, got in enumerate(setup["ranks"][2]):
        for fused in (True, False):
            toks, nbytes = got["gen"][name][fused]
            one_toks, one_bytes = setup["one"][name][fused]
            assert np.array_equal(toks, one_toks), (name, r, fused)
            assert nbytes == one_bytes == want["True"][1], (name, r, fused)
        assert got["gen"][name][True][0].tolist() == want["True"][0]


def test_online_layer_keeps_the_ranks_in_lockstep(setup):
    """Priorities with preemption, a deadline and a seeded chaos plan at
    tp 2, rank 1's clock source running apart from rank 0's: through the
    group's loop clock every rank's tokens, request states and recovery
    events are equal and equal one device's on rank 0's source; the plan's
    faults fired on every rank (the stall too), a victim was preempted and
    the deadline expired a request."""
    one = setup["one_sched"]
    got = [r["sched"] for r in setup["ranks"][2]]
    for r in got:
        assert r == one
    assert {"step_corrupt", "device_loss", "step_stall"} <= set(one["fired"])
    assert one["preemptions"] > 0 and "TIMEOUT" in one["states"]
    assert any(e["event"] == "recover" for e in one["events"])
