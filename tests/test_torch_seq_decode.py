"""The sequence-cut dense decode (``parallel.decode_attn="shard_map"``, the
JAX package's log-sum-exp ``distributed_decode_attention``) in the port,
against the JAX package.

At tp 1 the JAX package already takes that body on an Auto (1, 1) mesh
(its decode steps pass ``dist_axis`` for every layer without a window, and
its ops find the mesh's sequence axis): the body keeps p in float32 for
the sum but rounds it to bf16 for the PV product, which moves the decode
logits off the plain ``ref.decode_attention``'s.  The port took the plain
version whatever the knob said; its decode logits under the knob were up
to 2.20 bf16 ulps of the largest |logit| from the JAX step's (reduced
llama2-7b, below), past the one ulp that the family tests allow.  Now its
dense decode takes the body wherever the reference does (gemma2's step
logits, with prompts past its 16-token rings, and seamless's are then
bit for bit the JAX step's), and ``ServeEngine`` refuses in-place paging
under the knob as the reference does.

At tp 2 and 4 (gloo ranks on the CPU) each rank holds ``(B, Hkv, S / tp,
D)`` of every K/V leaf: every KV head of its block of positions.  Reduced
llama2-7b (generate() fused, and stepwise at tp 1 and 2; the scheduler on
the dense slot cache with and without chunked prefill, the gather
discipline on a page pool), gemma2-27b (its local rings and global layers
both cut, softcap 50; the gather discipline with its rings in the pool; a
cache shorter than its window), phi3.5-moe (the slot protocol, experts
whole on every rank) and seamless-m4t-medium (generate() with the cross
K/V cut on frames): every rank's tokens equal the JAX ``ServeEngine``'s
with the knob on an Auto (1, tp) mesh, and the port's at tp 1.  The JAX
side runs in five subprocesses (the engines at tp 1, 2 in two halves and
4 on forced host devices, and the tp 1 step logits), started together
while the port's ranks serve."""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp
from jax.sharding import AxisType

from repro.configs import get_config
from repro.models import api as japi
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs import get_config as t_get_config
from repro.distributed import collectives as jcollectives
from repro_torch.distributed import collectives, runtime
from repro_torch.models import api
from repro_torch.models.api import params_from_numpy
from repro_torch.serve.engine import ServeEngine
from torch_cases import bf16_ulp_of
from torch_tp_cases import seq_decode_rank

ARCHS = {"lm": "llama2-7b", "gemma2": "gemma2-27b",
         "moe": "phi3.5-moe-42b-a6.6b", "encdec": "seamless-m4t-medium"}
MAX_LEN = 48
NEW = 6
KNOB = "shard_map"
# the decode logits' bound at tp 1, in bf16 ulps of the largest |logit|:
# the MoE family tests' (tests/test_torch_moe.py), whose cause is this
# one: XLA's rsqrt in rmsnorm, which nothing portable reproduces, flips a
# norm output's last bit where the step's input differs from the plain
# decode's, and the FFN carries it on (the attention itself is bit for bit
# the JAX package's, below)
ULPS = 2


def knob(cfg, use_pallas=None):
    """``cfg`` with ``parallel.decode_attn="shard_map"``."""
    cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(
        cfg.parallel, decode_attn=KNOB))
    if use_pallas is not None:
        cfg = dataclasses.replace(cfg, use_pallas=use_pallas)
    return cfg


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 127, n).astype(np.int32) for n in lens]


def _cases():
    """name -> one engine (its family and options) and the runs it serves
    in turn, ``generate()`` (fused, and stepwise at the tps ``stepwise``
    names) or the scheduler (2 slots), each at the tps it names: every
    family at 1, 2 and 4, the features at 1 and 2 (the JAX side at 2
    alone: ``jax_tp``)."""
    sched = _prompts(2, (7, 12, 15))
    fe = np.random.default_rng(3).standard_normal((2, 8, 64)).astype(
        np.float32)
    dense = dict(max_len=MAX_LEN)
    gather = dict(max_len=MAX_LEN, page_size=8, paged_attn="gather")
    every, two = (1, 2, 4), (1, 2)
    feature = dict(tp=two, jax_tp=(2,))
    gen = dict(kind="generate", new=NEW, tp=every, stepwise=two)
    sch = dict(kind="sched", prompts=sched, new=NEW, tp=every)
    return {
        "lm": dict(spec="lm", kw=dense, runs=[
            dict(gen, prompts=np.stack(_prompts(1, (9, 9, 9)))),
            dict(sch, tp=two), dict(sch, chunk=8, **feature)]),
        "lm_gather": dict(spec="lm", kw=gather, runs=[dict(sch, **feature)]),
        "gemma2": dict(spec="gemma2", kw=dense, runs=[sch]),
        "gemma2_gather": dict(spec="gemma2", kw=gather,
                              runs=[dict(sch, **feature)]),
        # a cache shorter than the 16-token window: the local layers stay
        # plain (the reference passes the window), their cut positions
        # gathered for the step
        "gemma2_narrow": dict(spec="gemma2", kw=dict(max_len=12), runs=[
            dict(gen, prompts=np.stack(_prompts(6, (5, 5))), **feature)]),
        "moe": dict(spec="moe", kw=dense, runs=[sch]),
        "encdec": dict(spec="encdec", kw=dense, runs=[
            dict(gen, prompts=np.stack(_prompts(5, (6, 6))), frontend=fe)]),
    }


# the JAX side: the runs at tp of the ``_cases`` named, on an Auto (1, tp)
# mesh with the knob (the Pallas kernels in interpret mode, which the port
# follows), then the decode logits of the ``_logit_jobs`` named on an Auto
# (1, 1) mesh (_jax_step_logits); prints one JSON line of {"runs": {name:
# {run index: {mode: tokens}}}, "logits": {name: [step logits]}}
_JAX = """
    import dataclasses, json, pickle
    import numpy as np
    import jax
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.serve.engine import ServeEngine
    from repro.serve.scheduler import ContinuousBatchingScheduler, Request

    with open({path!r}, "rb") as f:
        trees, cases, jobs = pickle.load(f)
    mesh = jax.make_mesh((1, {tp}), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)

    def knob(arch, pallas):
        cfg = get_config(arch).reduced(vocab_size=128)
        return dataclasses.replace(
            cfg, use_pallas=pallas, parallel=dataclasses.replace(
                cfg.parallel, decode_attn="shard_map"))

    def run(eng, r):
        if r["kind"] == "generate":
            fe = r.get("frontend")
            fe = None if fe is None else jax.numpy.asarray(fe)
            modes = (True, False) if {tp} in r["stepwise"] else (True,)
            return {{str(f): np.asarray(eng.generate(
                r["prompts"], max_new=r["new"], frontend=fe,
                fused=f)["tokens"]).tolist() for f in modes}}
        res = ContinuousBatchingScheduler(
            eng, max_slots=2, prefill_chunk=r.get("chunk")).run(
            [Request(uid=i, prompt=p, max_new=r["new"])
             for i, p in enumerate(r["prompts"])])["results"]
        return {{"sched": [np.asarray(x.tokens).tolist() for x in
                          sorted(res, key=lambda x: x.uid)]}}

    out = {{"runs": {{}}, "logits": {{}}}}
    for name in {names!r}:
        case = cases[name]
        runs = {{str(i): r for i, r in enumerate(case["runs"])
                if {tp} in r.get("jax_tp", r["tp"])}}
        if not runs:
            continue
        params = jax.tree.map(jax.numpy.asarray, trees[case["spec"]])
        eng = ServeEngine(knob({archs!r}[case["spec"]], True), params,
                          mesh=mesh, **case["kw"])
        out["runs"][name] = {{i: run(eng, r) for i, r in runs.items()}}
{step_logits}
    for name in {logits!r}:
        prompts, fe = jobs[name]
        params = jax.tree.map(jax.numpy.asarray, trees[name])
        out["logits"][name] = [l.tolist() for l in _jax_step_logits(
            knob({archs!r}[name], True), params, prompts, {new}, mesh, fe)]
    print("JAX_OUT " + json.dumps(out))
"""

# the reference's jitted block prefill of ``prompts[:, :-1]`` (a decode
# step per token for encdec), then ``steps`` greedy decode steps: every
# decode step's logits (in _JAX's script)
_STEP_LOGITS = """
def _jax_step_logits(cfg, params, prompts, steps, mesh, frontend=None):
    import jax.numpy as jnp
    from repro.models import api as japi
    B = prompts.shape[0]
    kw = {} if frontend is None else {"frontend": jnp.asarray(frontend),
                                      "params": params}
    with mesh:
        jc = japi.init_cache(cfg, B, MAX_LEN, **kw)
        step = jax.jit(lambda p, c, t: japi.decode_step(p, c, t, cfg))
        if frontend is None:
            _, jc = jax.jit(lambda p, c, t: japi.prefill(p, c, t, cfg))(
                params, jc, jnp.asarray(prompts[:, :-1]))
        else:
            for t in range(prompts.shape[1] - 1):
                _, jc = step(params, jc, jnp.asarray(prompts[:, t]))
        out, tok = [], jnp.asarray(prompts[:, -1])
        for _ in range(steps):
            jl, jc = step(params, jc, tok)
            out.append(np.asarray(jl))
            tok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
    return out
"""


def _start_jax(tp, path, names, logits=()):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"),
               XLA_FLAGS=f"--xla_force_host_platform_device_count={tp} "
               + os.environ.get("XLA_FLAGS", ""))
    step_logits = textwrap.indent(_STEP_LOGITS.replace(
        "MAX_LEN", str(MAX_LEN)), " " * 4)
    script = textwrap.dedent(_JAX.format(
        path=path, tp=tp, archs=ARCHS, names=list(names),
        logits=list(logits), new=NEW, step_logits=step_logits))
    return subprocess.Popen([sys.executable, "-c", script], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


# the tp 1 decode logits' families, and the cases that the JAX side serves
# at tp 2 alone (in a subprocess of their own, beside the families')
LOGITS = ("lm", "gemma2", "encdec")
FEATURES = ("lm_gather", "gemma2_gather", "gemma2_narrow")


def _logit_jobs(cases):
    """name -> (prompts, frontend) of the tp 1 decode logits' test:
    gemma2's prompts of 20 tokens run past its 16-token rings."""
    prompts = np.stack(_prompts(7, (13, 13)))
    fe = cases["encdec"]["runs"][0]["frontend"]
    return {"lm": (prompts, None),
            "gemma2": (np.stack(_prompts(4, (20, 20))), None),
            "encdec": (prompts, fe)}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX params of each family as numpy, the JAX subprocesses (tp 1;
    the tp 1 logits; tp 2 in two halves; tp 4) started at once, and the
    port's ranks at tp 2 and 4 spawned at the first test."""
    trees, specs = {}, {}
    for name, arch in ARCHS.items():
        cfg = get_config(arch).reduced(vocab_size=128)
        params = jax.jit(japi.init_params, static_argnums=0)(
            cfg, jax.random.PRNGKey(0))
        trees[name] = jax.tree.map(np.asarray, params)
        specs[name] = dict(arch=arch, overrides=dict(vocab_size=128),
                           params=trees[name], decode_attn=KNOB)
    cases = _cases()
    path = str(tmp_path_factory.mktemp("seq_decode") / "cases.pkl")
    with open(path, "wb") as f:
        pickle.dump((trees, cases, _logit_jobs(cases)), f)
    families = [n for n in cases if n not in FEATURES]
    procs = {(1, "runs"): _start_jax(1, path, cases),
             (1, "logits"): _start_jax(1, path, (), LOGITS),
             (2, "families"): _start_jax(2, path, families),
             (2, "features"): _start_jax(2, path, FEATURES),
             (4, "runs"): _start_jax(4, path, cases)}
    state = dict(specs=specs, cases=cases, trees=trees, procs=procs,
                 jax={}, ranks={})
    yield state
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _jax_out(setup, key):
    """What the JAX subprocess ``key`` printed (waiting for it once)."""
    if key not in setup["jax"]:
        proc = setup["procs"][key]
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, out + err
        setup["jax"][key] = json.loads(
            out.split("JAX_OUT ", 1)[1].splitlines()[0])
    return setup["jax"][key]


def _jax(setup, tp):
    """The JAX side's runs at ``tp``: {name: {run index: {mode: tokens}}}."""
    runs = {}
    for key in setup["procs"]:
        if key[0] == tp and key[1] != "logits":
            runs.update(_jax_out(setup, key)["runs"])
    return runs


def _ranks(setup, tp):
    """Every rank's results at ``tp`` (1: this process)."""
    if not setup["ranks"]:
        args = (setup["specs"], setup["cases"])
        # both tps' ranks at once, beside the JAX subprocesses
        with ThreadPoolExecutor(2) as pool:
            spawned = {n: pool.submit(
                runtime.spawn, seq_decode_rank, (1, n), args + (n,),
                backend="gloo", devices=["cpu"] * n, timeout=600)
                for n in (2, 4)}
            setup["ranks"][1] = [seq_decode_rank(None, *args, 1)]
            for n, fut in spawned.items():
                setup["ranks"][n] = fut.result()
    return setup["ranks"][tp]


def _tokens(res):
    return {name: runs for name, (runs, _) in res.items()}


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_tokens_match_the_jax_engine_and_tp1(setup, tp):
    """Every run's tokens on every rank equal the JAX engine's with the
    knob on an Auto (1, tp) mesh (the features' at tp 2).  They equal the
    port's at tp 1 wherever the JAX engine's at tp equal its own at tp 1,
    and for the features, which the JAX side serves at tp 2 alone: where
    the reference itself parts from tp 1 (its partials summed over other
    blocks of positions), the port parts with it, and the test says how
    often."""
    want, want1 = _jax(setup, tp), _jax(setup, 1)
    one = _tokens(_ranks(setup, 1)[0])
    parted = set()
    for r, res in enumerate(_ranks(setup, tp)):
        got = _tokens(res)
        for name, runs in got.items():
            for i, toks in runs.items():
                # the modes served at tp (generate() stepwise at 1 and 2)
                at = lambda d: {m: d[m] for m in toks}     # noqa: E731
                if i in want.get(name, {}):
                    assert toks == want[name][i], (name, i, tp, r)
                else:
                    assert tp == 1, (name, i, "no JAX run")
                if i not in want1.get(name, {}) or (
                        want[name][i] == at(want1[name][i])):
                    assert toks == at(one[name][i]), (name, i, tp, r)
                else:
                    parted.add((name, i))
    print(f"tp {tp}: runs where the JAX engine parts from its tp 1 "
          f"tokens: {sorted(parted)}")


@pytest.mark.parametrize("tp", [2, 4])
def test_a_rank_holds_its_block_of_positions(setup, tp):
    """A rank's dense K/V leaves are ``(..., Hkv, S / tp, hd)``: every KV
    head of its block of positions (gemma2's rings of 16 too; seamless's
    cross K/V of its frames)."""
    for got in _ranks(setup, tp):
        for name, (_, shapes) in got.items():
            case = setup["cases"][name]
            cfg = t_get_config(ARCHS[case["spec"]]).reduced(vocab_size=128)
            for path, shape in shapes.items():
                leaf = path.split("/")[0]
                if leaf == "len":
                    continue
                whole = case["kw"]["max_len"]
                if case["spec"] == "gemma2" and path.endswith("/0"):
                    whole = min(16, whole)
                if leaf.startswith("cross"):
                    whole = cfg.frontend_tokens
                assert shape[-3] == cfg.num_kv_heads, (name, path)
                assert shape[-2] == whole // tp, (name, path, shape)


def test_check_tp_and_an_indivisible_sequence(setup):
    """``check_tp`` refuses nothing for the knob; a cache whose sequence tp
    does not divide is refused."""
    from repro_torch.serve.engine import check_tp
    cfg = knob(t_get_config("llama2-7b").reduced(vocab_size=128))
    group = runtime.TPGroup(None, 0, 2, "gloo", torch.device("cpu"))
    check_tp(cfg, group, "cpu")
    api.init_cache(cfg, 2, 48, device="meta", tp=group)
    with pytest.raises(ValueError, match="does not divide over 2 ranks"):
        api.init_cache(cfg, 2, 47, device="meta", tp=group)


# ----------------------------------------------------------------------------
# tp 1: the repairs
# ----------------------------------------------------------------------------
def _port_step_logits(eng, prompts, steps, frontend=None):
    B = prompts.shape[0]
    fe = None if frontend is None else torch.from_numpy(frontend)
    c = api.init_cache(eng.cfg, B, MAX_LEN, device="cpu", frontend=fe,
                       params=eng.params if fe is not None else None)
    body = torch.from_numpy(prompts[:, :-1])
    _, c = api.prefill_bucketed(eng.params, c, body, body.shape[1], eng.cfg)
    out, tok = [], torch.from_numpy(prompts[:, -1])
    for _ in range(steps):
        tl, c = api.decode_step(eng.params, c, tok, eng.cfg)
        out.append(tl.numpy())
        tok = torch.argmax(tl, dim=-1).to(torch.int32)
    return out


@pytest.mark.parametrize("name", ["lm", "gemma2", "encdec"])
def test_tp1_decode_logits_follow_the_jax_knob(setup, name):
    """The JAX package's decode logits under the knob on an Auto (1, 1)
    mesh against the port's, before the repair (the plain decode, which
    the port took whatever the knob said) and after: after, the same
    argmax and within ULPS bf16 ulps of the largest |logit|, closer than
    before.  And every attention call of the port's steps, replayed
    through the JAX package's jitted log-sum-exp body on the same inputs,
    gives the same bits where one query head reads each KV head (llama2-7b,
    seamless); gemma2's groups of two differ in the dots' order."""
    arch = ARCHS[name]
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    prompts, fe = _logit_jobs(setup["cases"])[name]
    want = [np.asarray(w, np.float32) for w in
            _jax_out(setup, (1, "logits"))["logits"][name]]
    tparams = params_from_numpy(setup["trees"][name], "cpu")
    tcfg = t_get_config(arch).reduced(vocab_size=128)
    calls = []
    body = collectives.distributed_decode_attention

    def record(q, k, v, valid, tp=None, **kw):
        out = body(q, k, v, valid, tp, **kw)
        calls.append((q, k, v, valid, kw, out))
        return out

    collectives.distributed_decode_attention = record
    try:
        after = _port_step_logits(ServeEngine(knob(tcfg), tparams,
                                              max_len=MAX_LEN, device="cpu"),
                                  prompts, NEW, fe)
    finally:
        collectives.distributed_decode_attention = body
    before = _port_step_logits(ServeEngine(tcfg, tparams, max_len=MAX_LEN,
                                           device="cpu"), prompts, NEW, fe)
    worst = {"before": 0.0, "after": 0.0}
    for w, a, b in zip(want, after, before):
        ulp = bf16_ulp_of(float(np.abs(w).max()))
        np.testing.assert_array_equal(a.argmax(-1), w.argmax(-1))
        worst["after"] = max(worst["after"], np.abs(a - w).max() / ulp)
        worst["before"] = max(worst["before"], np.abs(b - w).max() / ulp)
    print(f"{name}: largest logit difference in bf16 ulps: {worst}")
    assert worst["after"] <= ULPS and worst["after"] < worst["before"], worst
    differ, fns = 0, {}
    with mesh:
        for q, k, v, valid, kw, out in calls:
            key = tuple(sorted(kw.items()))
            if key not in fns:
                fns[key] = jax.jit(jcollectives.distributed_decode_attention(
                    mesh, "model", **kw))
            ref = fns[key](*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                       for t in (q, k, v)), jnp.asarray(valid.numpy()))
            differ += int((np.asarray(ref.astype(jnp.float32))
                           != out.float().numpy()).sum())
    assert calls and (differ == 0 or name == "gemma2"), differ


def test_tp1_inplace_paging_refused_as_the_reference_refuses(setup):
    """In-place paging under the knob raises the reference's ValueError
    once paging engages; a family that never pages (rwkv) keeps its dense
    slot cache, and the gather discipline serves."""
    cfg = knob(get_config("llama2-7b").reduced(vocab_size=128),
               use_pallas=True)
    params = jax.tree.map(jnp.asarray, setup["trees"]["lm"])
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    ref = JEngine(cfg, params, mesh=mesh, max_len=MAX_LEN, page_size=8)
    with pytest.raises(ValueError) as want:
        ref.init_slot_cache(2)
    tcfg = knob(t_get_config("llama2-7b").reduced(vocab_size=128))
    tparams = params_from_numpy(setup["trees"]["lm"], "cpu")
    ours = ServeEngine(tcfg, tparams, max_len=MAX_LEN, page_size=8,
                       device="cpu")
    with pytest.raises(ValueError) as got:
        ours.init_slot_cache(2)
    assert str(got.value) == str(want.value)
    ServeEngine(tcfg, tparams, max_len=MAX_LEN, page_size=8,
                paged_attn="gather", device="cpu").init_slot_cache(2)
    rcfg = knob(t_get_config("rwkv6-7b").reduced(vocab_size=128))
    rparams = api.init_params(rcfg, torch.Generator().manual_seed(0), "cpu")
    ServeEngine(rcfg, rparams, max_len=MAX_LEN, page_size=8,
                device="cpu").init_slot_cache(2)
