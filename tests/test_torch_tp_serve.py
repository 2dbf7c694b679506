"""Tensor-parallel serving of the port on gloo ranks on the CPU, against the
JAX package.

The slot protocol of ``tests/test_mesh_serve.py`` (reduced configs, vocab
128, prompts of 7 and 12 tokens, 2 slots, max_len 48, page 8, in place, 8
decode steps) for lm (llama2-7b: Hkv 4, the pool head-cut at tp 2 and 4),
gemma2-27b (Hkv 2: cut at tp 2, replicated at tp 4, where its global
layers' paged attention runs unsharded on every rank), hymba-1.5b (its
ring), rwkv6-7b (one head of 64: the WKV state whole) and the split-brain
engine (llama2-7b, LAQ W4A8, column blocks of the codes): every rank's
greedy tokens equal the JAX package's one-device engines' (Auto-axis mesh,
``use_pallas=True`` for the ServeEngine), the meter's bytes too, and
``kv_shards == tp`` for lm and split-brain.  At tp 2, lm and split-brain
also equal the JAX package's own TP engines on an Auto (1, 2) mesh of two
forced host devices.  Then the KV features at tp 2 on lm (prefix reuse
with chunks of 8, an int8 pool, the gather discipline), hymba with a
window over the whole cache (its K/V page: the windowed paged kernel on
the rank's heads), rwkv with two heads of 64 (its WKV state cut on heads) and
gemma2 at tp 4 with eight page columns (the page-split LSE merge in its
decode steps) give the tokens of the port's one-device engine, which the
other tests hold against the JAX package.

The JAX engines run in three subprocesses started by the fixture (the
one-device engines in two halves, the TP engines on two forced host
devices) while the port's ranks serve; all read the params that this
process made (a pickle of numpy arrays)."""
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
from repro.models import api as japi
from repro_torch.configs.base import LayerSpec
from repro_torch.distributed import runtime
from torch_cases import feature_prompts
from torch_tp_cases import build_engine, scheduler_run, tp_rank

KW = dict(max_len=48, page_size=8, paged_attn="inplace")
FAMILIES = {"lm": "llama2-7b", "gemma2": "gemma2-27b", "hymba": "hymba-1.5b",
            "rwkv": "rwkv6-7b", "splitbrain": "llama2-7b"}
CUT_KV = ("lm", "splitbrain")
KEYS = {"splitbrain": 1}          # PRNG key of each family's params (else 0)
ONE_DEVICE = {"one_a": ("lm", "gemma2", "splitbrain"),
              "one_b": ("hymba", "rwkv")}

# the JAX side: ``test_mesh_serve.py``'s slot protocol on a (1, DEVICES)
# Auto-axis mesh over the families NAMES, their params read from PARAMS;
# prints one JSON line of {name: [tokens, meter bytes, kv_shards]}
_JAX = """
    import dataclasses, json, pickle
    import numpy as np
    import jax
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.models import api
    from repro.serve.engine import ServeEngine
    from repro.serve.splitbrain_engine import SplitBrainEngine

    STEPS = 8
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 127, size=n).astype(np.int32) for n in (7, 12)]
    mesh = jax.make_mesh((1, {devices}), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)

    def slot_run(eng):
        cache = eng.init_slot_cache(2)
        toks = np.zeros((2,), np.int32)
        for i, p in enumerate(prompts):
            assert eng.reserve_slot(i, len(p), STEPS + 2)
            c1, tok = eng.prefill_slot(p)
            cache = eng.insert_slot(cache, c1, i)
            toks[i] = tok
        outs = []
        for _ in range(STEPS):
            nxt, ok, cache = eng.decode_slots(cache, toks,
                                              np.array([True, True]))
            assert bool(np.asarray(ok).all())
            eng.meter_tokens(2)
            toks = np.asarray(nxt)
            outs.append(toks.tolist())
        nbytes = (eng.measured_bytes_per_token()
                  if hasattr(eng, "measured_bytes_per_token")
                  else eng.measured_bytes())
        return outs, nbytes, eng.cache_stats(cache).get("kv_shards")

    with open({params!r}, "rb") as f:
        trees = pickle.load(f)
    out = {{}}
    for name, arch in {names!r}.items():
        sb = name == "splitbrain"
        cfg = dataclasses.replace(get_config(arch).reduced(vocab_size=128),
                                  use_pallas={pallas} and not sb)
        params = jax.tree.map(jax.numpy.asarray, trees[name])
        kw = dict(max_len=48, page_size=8, paged_attn="inplace", mesh=mesh)
        eng = (SplitBrainEngine(cfg, params, **kw) if sb
               else ServeEngine(cfg, params, **kw))
        out[name] = slot_run(eng)
    print("JAX_OUT " + json.dumps(out))
"""


def _start_jax(devices, names, pallas, params):
    """The JAX side in a background subprocess with ``devices`` forced host
    devices (``tests/conftest.py::run_multidev``'s environment)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"),
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices} "
               + os.environ.get("XLA_FLAGS", ""))
    script = textwrap.dedent(_JAX.format(devices=devices, names=names,
                                         pallas=pallas, params=params))
    return subprocess.Popen([sys.executable, "-c", script], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _jax_result(setup, which):
    """The JSON a JAX subprocess printed (waiting for it once)."""
    if which not in setup["jax"]:
        proc = setup["procs"][which]
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, out + err
        setup["jax"][which] = json.loads(
            out.split("JAX_OUT ", 1)[1].splitlines()[0])
    return setup["jax"][which]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Per family the JAX params as numpy (the port's engine spec), and the
    JAX subprocesses on them (one device: every family with the kernels
    the port's parity tests hold it to; two devices: the JAX TP engines
    of lm and split-brain)."""
    specs, trees = {}, {}
    for name, arch in FAMILIES.items():
        cfg = get_config(arch).reduced(vocab_size=128)
        params = jax.jit(japi.init_params, static_argnums=0)(
            cfg, jax.random.PRNGKey(KEYS.get(name, 0)))
        trees[name] = jax.tree.map(np.asarray, params)
        specs[name] = dict(arch=arch, overrides=dict(vocab_size=128),
                           params=trees[name],
                           splitbrain=name == "splitbrain", kw=KW)
    path = str(tmp_path_factory.mktemp("tp_serve") / "params.pkl")
    with open(path, "wb") as f:
        pickle.dump(trees, f)
    # three JAX processes in parallel: the one-device engines in two halves
    procs = {half: _start_jax(1, {k: FAMILIES[k] for k in names}, True, path)
             for half, names in ONE_DEVICE.items()}
    procs["tp"] = _start_jax(2, {k: FAMILIES[k] for k in CUT_KV}, False,
                             path)
    state = dict(specs=specs, procs=procs, jax={}, ranks={})
    yield state
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _feature_specs(specs, tp):
    """The scheduler cases of each tp: the KV features on lm, hymba's paged
    K/V and rwkv with two heads at tp 2, gemma2 with eight page columns
    (the merge) at 4."""
    if tp == 4:
        return {"gemma2_merge": dict(specs["gemma2"],
                                     kw=dict(KW, max_len=64))}
    lm = specs["lm"]
    hymba = dict(specs["hymba"], overrides=dict(
        vocab_size=128, layer_pattern=(LayerSpec(window=64),)))
    return {
        "prefix_chunked": dict(lm, kw=dict(KW, prefix_cache="on"), chunk=8),
        "int8_pool": dict(lm, kw=dict(KW, kv_dtype="int8")),
        "gather": dict(lm, kw=dict(KW, paged_attn="gather")),
        "hymba_paged": dict(hymba, kw=KW),
        # two heads of 64: the WKV state cut on heads (the port's weights)
        "rwkv_heads": dict(arch="rwkv6-7b", params=None, kw=KW,
                           overrides=dict(vocab_size=128, d_model=128)),
    }


# each feature case's pool cut: gemma2's 2 KV heads over 4 ranks stay
# whole; rwkv has no pool (its dense slot cache, the WKV state cut)
KV_SHARDS = {"gemma2_merge": 1, "rwkv_heads": None}


def _ranks(setup, tp):
    """Every rank's results at ``tp``, from ONE spawn per tp: the five
    families' slot protocol, then :func:`_feature_specs` under the
    scheduler.  Both tps are spawned, and the feature cases served on one
    device, at the first call, while the JAX subprocesses still run."""
    if not setup["ranks"]:
        specs = setup["specs"]
        prompts = feature_prompts(128, seed=3, page=8)
        for n in (2, 4):
            setup["ranks"][n] = runtime.spawn(
                tp_rank, (1, n), (specs, _feature_specs(specs, n), prompts),
                backend="gloo", devices=["cpu"] * n, timeout=600)
        # the feature cases' one-device tokens, also before any wait
        setup["one_device"] = {
            name: scheduler_run(build_engine(spec, None), prompts,
                                chunk=spec.get("chunk"))
            for n in (2, 4) for name, spec in _feature_specs(specs, n).items()}
    return setup["ranks"][tp]


def _assert_same(got, want, where):
    toks, nbytes = got[:2]
    assert toks.tolist() == want[0], where
    assert nbytes == want[1], where


@pytest.mark.parametrize("tp", [2, 4])
def test_five_families_match_the_jax_engines(setup, tp):
    ranks = _ranks(setup, tp)
    want = {**_jax_result(setup, "one_a"), **_jax_result(setup, "one_b")}
    for name in FAMILIES:
        for r, got in enumerate(ranks):
            _assert_same(got[0][name], want[name], (name, r, tp))
            if name in CUT_KV:
                assert got[0][name][2] == tp and got[0][name][3] == tp, name


def test_tp2_matches_the_jax_tp_engines(setup):
    """lm and split-brain at tp 2 against the JAX package's own TP engines
    (GSPMD on an Auto (1, 2) mesh of two forced host devices, its default
    backends): the same tokens, meter bytes and ``kv_shards``."""
    ranks = _ranks(setup, 2)
    for name, want in _jax_result(setup, "tp").items():
        assert want[2] == 2
        for r, got in enumerate(ranks):
            _assert_same(got[0][name], want, (name, r))
            assert got[0][name][2] == want[2], name


@pytest.mark.parametrize("tp", [2, 4])
def test_kv_features_at_tp2_and_the_merge_at_tp4(setup, tp):
    """The KV features at tp 2 and the engine's LSE merge at tp 4 give the
    tokens of the port's one-device engine (whose tokens the other parity
    tests hold to the JAX package's); the pool's KV heads are cut where
    they divide (gemma2's 2 over 4 ranks: whole)."""
    ranks = _ranks(setup, tp)
    for name in _feature_specs(setup["specs"], tp):
        want = setup["one_device"][name]
        for got in ranks:
            assert got[1][name][:2] == want, (name, tp)
        assert ranks[0][1][name][2] == KV_SHARDS.get(name, tp), name
