"""The OnlineServer on tensor-parallel ranks: two gloo ranks on the CPU,
each running ``OnlineServer(sched, watchdog_s=...)`` over its own
scheduler, as a user writes it, for the float ``ServeEngine`` (reduced
llama2-7b, a page pool) and the split-brain engine (LAQ W4A8, a page pool).

Rank 0 is the front end: a client thread submits six requests, each
streamed to a consumer thread -- two that finish, one whose deadline has
passed, one the client cancels after two streamed tokens, one whose
consumer callback raises at its second token, one of a higher priority --
while a decode step stalled for 1.5 s trips a 1 s watchdog.  On every
rank the scheduler sees the same requests, cancellations, recoveries and
stop at the same iteration: the ranks' tokens, states and recovery events
(without their seconds) are equal, rank 0's streamed tokens equal its
results, and they equal a one-device ``OnlineServer`` run of the same
requests (the client's cancellation lands when it lands: its tokens are a
prefix).  ``stop(drain=False)`` ends every rank's loop, and a loop error
on rank 1 tears the group down: rank 0's handles resolve REJECTED and
``stop()`` raises on both ranks, with no rank left waiting.

Both engines serve the JAX package's weights (its ``init_params``, through
``params_from_numpy``), and the same requests go through the JAX
package's ``OnlineServer`` over its TP engines on an Auto (1, 2) mesh of
two forced host devices (a subprocess started by the fixture, while the
port's ranks serve): the requests that finish there and here carry the
same tokens, a cancelled request's tokens here are a prefix of its tokens
there, and the request past its deadline times out on both."""
import json
import os
import pickle
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.configs import get_config
from repro.models import api as japi
from repro_torch.distributed import runtime
from torch_tp_cases import build_engine, online_rank

VOCAB = 128
ARCH = "llama2-7b"
KW = dict(max_len=64, page_size=8)
SPECS = {
    "serve": dict(arch=ARCH, overrides=dict(vocab_size=VOCAB), kw=KW),
    "splitbrain": dict(arch=ARCH, overrides=dict(vocab_size=VOCAB),
                       splitbrain=True, kw=dict(KW, quantize=True)),
}


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB - 1, int(rng.integers(4, 12))).tolist()
            for _ in range(n)]


P = _prompts(6)
SCENARIO = dict(slots=2, stall_at=3, stall_s=1.5, watchdog_s=1.0, requests=[
    (P[0], 6, {}),
    (P[1], 6, {"deadline_s": 0.0}),
    (P[2], 30, {"cancel_at": 2}),
    (P[3], 6, {"raise_at": 2}),
    (P[4], 6, {}),
    (P[5], 6, {"priority": 1}),
])
STATES = {0: "DONE", 1: "TIMEOUT", 2: "CANCELLED", 3: "CANCELLED",
          4: "DONE", 5: "DONE"}
NODRAIN = (_prompts(4, seed=1), 40)
ERROR = (_prompts(3, seed=2), 1, 3)


# the JAX side: SCENARIO's requests through the JAX package's OnlineServer
# over each engine on an Auto (1, 2) mesh (the TP engines as
# tests/test_torch_tp_serve.py builds them), no fault planted; prints one
# JSON line of {name: {uid: [state, tokens]}}
_JAX = """
    import dataclasses, json, pickle
    import numpy as np
    import jax
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.serve.engine import ServeEngine
    from repro.serve.scheduler import ContinuousBatchingScheduler
    from repro.serve.server import OnlineServer
    from repro.serve.splitbrain_engine import SplitBrainEngine

    with open({path!r}, "rb") as f:
        tree, requests = pickle.load(f)
    mesh = jax.make_mesh((1, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    cfg = get_config({arch!r}).reduced(vocab_size={vocab})
    params = jax.tree.map(jax.numpy.asarray, tree)
    out = {{}}
    for name, engine in (("serve", ServeEngine),
                         ("splitbrain", SplitBrainEngine)):
        eng = engine(cfg, params, mesh=mesh, **{kw!r})
        srv = OnlineServer(ContinuousBatchingScheduler(eng, max_slots={slots}))
        with srv:
            handles = [srv.submit(np.asarray(p, np.int32), max_new=n,
                                  priority=x.get("priority", 0),
                                  deadline_s=x.get("deadline_s"))
                       for p, n, x in requests]
            res = [h.result(timeout=300) for h in handles]
        out[name] = {{str(h.uid): [r.state, np.asarray(r.tokens).tolist()]
                     for h, r in zip(handles, res)}}
    print("JAX_OUT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX weights, the JAX OnlineServer in a subprocess on them, and
    the port's two ranks and one device on the same weights."""
    cfg = get_config(ARCH).reduced(vocab_size=VOCAB)
    tree = jax.tree.map(np.asarray, jax.jit(japi.init_params,
                                            static_argnums=0)(
        cfg, jax.random.PRNGKey(0)))
    path = str(tmp_path_factory.mktemp("tp_online") / "params.pkl")
    with open(path, "wb") as f:
        pickle.dump((tree, SCENARIO["requests"]), f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=2 "
               + os.environ.get("XLA_FLAGS", ""))
    script = textwrap.dedent(_JAX.format(path=path, arch=ARCH, vocab=VOCAB,
                                         kw=KW, slots=SCENARIO["slots"]))
    proc = subprocess.Popen([sys.executable, "-c", script], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        specs = {name: dict(spec, params=tree) for name, spec in SPECS.items()}
        # the ranks and the one-device run at once, beside the JAX side
        with ThreadPoolExecutor(1) as pool:
            spawned = pool.submit(runtime.spawn, online_rank, (1, 2),
                                  (specs, SCENARIO, NODRAIN, ERROR),
                                  backend="gloo", devices=["cpu"] * 2,
                                  timeout=600)
            one = online_rank(None, specs, SCENARIO, NODRAIN, None)
            ranks = spawned.result()
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out + err
    want = json.loads(out.split("JAX_OUT ", 1)[1].splitlines()[0])
    return ranks, one, want


@pytest.mark.parametrize("name", list(SPECS))
def test_ranks_agree_and_match_one_device(runs, name):
    ranks, one, _ = runs
    r0, r1 = (r[name]["scenario"] for r in ranks)
    ref = one[name]["scenario"]
    for key in ("tokens", "states", "events", "fired"):
        assert r0[key] == r1[key], key
    assert r0["states"] == STATES == ref["states"]
    assert r0["handles"] == STATES
    for uid, toks in r0["tokens"].items():
        assert r0["streamed"][uid] == toks, uid
        if uid == 2:        # the client's cancellation lands when it lands
            n = min(len(toks), len(ref["tokens"][uid]))
            assert n >= 2 and toks[:n] == ref["tokens"][uid][:n]
        else:
            assert toks == ref["tokens"][uid], uid
    assert len(r0["tokens"][3]) == 2 and r0["tokens"][1] == []
    assert r0["fired"] == ["step_stall"]
    assert any(e["event"] == "recover" and "watchdog" in e["reason"]
               for e in r0["events"]), r0["events"]
    assert r0["stats"]["watchdog_trips"] >= 1
    assert r0["stats"]["outstanding"] == 0


@pytest.mark.parametrize("name", list(SPECS))
def test_tokens_match_the_jax_online_server(runs, name):
    """Rank 0's results against the JAX OnlineServer's on an Auto (1, 2)
    mesh: the DONE requests' tokens are equal, the two cancelled ones'
    (the client's and the throwing consumer's) a prefix of the JAX tokens,
    and the request past its deadline times out there too."""
    ranks, _, want = runs
    got = ranks[0][name]["scenario"]
    ref = {int(u): v for u, v in want[name].items()}
    assert ref[1] == ["TIMEOUT", []]
    for uid, toks in got["tokens"].items():
        if STATES[uid] == "DONE":
            assert ref[uid] == ["DONE", toks], uid
        elif STATES[uid] == "CANCELLED":
            assert ref[uid][0] == "DONE", uid
            assert toks and toks == ref[uid][1][:len(toks)], uid


@pytest.mark.parametrize("name", list(SPECS))
def test_stop_without_drain_ends_every_rank(runs, name):
    ranks, _, _ = runs
    states = ranks[0][name]["nodrain"]
    assert set(states) <= {"CANCELLED", "DONE"} and "CANCELLED" in states
    assert ranks[1][name]["nodrain"] == []


def test_a_loop_error_on_one_rank_ends_the_group(runs):
    ranks, _, _ = runs
    for r in ranks:
        assert r["error"]["raised"] == "serve loop died"
    assert set(ranks[0]["error"]["states"]) == {"REJECTED"}


def test_submit_and_cancel_raise_on_other_ranks():
    from repro_torch.distributed.runtime import TPGroup
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler
    from repro_torch.serve.server import OnlineServer
    import torch
    eng = build_engine(dict(SPECS["serve"], params=None), None)
    eng.tp = TPGroup(None, 1, 2, "gloo", torch.device("cpu"))
    srv = OnlineServer(ContinuousBatchingScheduler(eng, max_slots=2))
    with pytest.raises(RuntimeError, match="rank 0 is the front end"):
        srv.submit(P[0])
    with pytest.raises(RuntimeError, match="rank 0 is the front end"):
        srv.cancel(0)
