"""Rank bodies of the tensor-parallel tests: module-level functions that
``repro_torch.distributed.runtime.spawn`` runs on every rank of a gloo
group on the CPU (the card tests run them on ``cuda:0``).  Imports neither
JAX nor the JAX package: the ranks are new processes, and the JAX side of
each comparison runs in the test's own process."""
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.quant import QuantizedLeaf
from repro_torch.distributed import collectives, sharding
from repro_torch.kernels import ops
from repro_torch.models import api
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import ContinuousBatchingScheduler, Request
from repro_torch.serve.splitbrain_engine import SplitBrainEngine

STEPS = 8


def mesh_prompts():
    """The two prompts of the JAX package's mesh-serving test (7 and 12
    tokens of a 128-token vocabulary)."""
    rng = np.random.default_rng(0)
    return [rng.integers(1, 127, size=n).astype(np.int32) for n in (7, 12)]


def slot_run(eng, steps=STEPS):
    """The slot protocol of ``tests/test_mesh_serve.py``: reserve, prefill
    and insert two requests, then ``steps`` masked decode steps over both
    slots with the meter replayed per step.  Returns (tokens (steps, 2),
    the meter's bytes, the slot cache's stats)."""
    cache = eng.init_slot_cache(2)
    toks = np.zeros((2,), np.int32)
    for i, p in enumerate(mesh_prompts()):
        assert eng.reserve_slot(i, len(p), steps + 2)
        c1, tok = eng.prefill_slot(p)
        cache = eng.insert_slot(cache, c1, i)
        toks[i] = tok
    active = np.array([True, True])
    outs = []
    for _ in range(steps):
        nxt, ok, cache = eng.decode_slots(cache, toks, active)
        assert bool(np.asarray(ok).all()), "finite-logits sentinel"
        eng.meter_tokens(2)
        toks = np.asarray(nxt)
        outs.append(toks.copy())
    nbytes = (eng.measured_bytes_per_token()
              if hasattr(eng, "measured_bytes_per_token")
              else eng.measured_bytes())
    return np.stack(outs), nbytes, eng.cache_stats(cache)


def build_engine(spec, tp, device="cpu"):
    """An engine of ``spec`` = dict(arch, overrides, params (numpy tree, or
    None for the port's seeded ones), splitbrain, kw, and optionally
    decode_attn, the config's ``parallel.decode_attn``) on ``device`` for
    the group ``tp`` (None: one device)."""
    cfg = get_config(spec["arch"]).reduced(**spec.get("overrides", {}))
    if spec.get("decode_attn"):
        cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(
            cfg.parallel, decode_attn=spec["decode_attn"]))
    if spec.get("params") is None:        # the port's own seeded weights
        params = api.init_params(
            cfg, torch.Generator(device=device).manual_seed(0), device)
    else:
        params = api.params_from_numpy(spec["params"], device)
    kw = dict(spec.get("kw", {}))
    if spec.get("splitbrain"):
        return SplitBrainEngine(cfg, params, device=device, tp=tp, **kw)
    return ServeEngine(cfg, params, device=device, tp=tp, **kw)


def serve_rank(group, specs):
    """Each spec's engine on this rank, through the slot protocol:
    {name: (tokens, bytes, kv_shards, traffic_shards)}."""
    torch.set_num_threads(1)
    out = {}
    for name, spec in specs.items():
        eng = build_engine(spec, group, str(group.device))
        toks, nbytes, stats = slot_run(eng)
        out[name] = (toks, nbytes, stats.get("kv_shards"),
                     eng.traffic_shards)
    return out


def scheduler_run(eng, prompts, max_new=6, slots=2, chunk=None):
    """The continuous-batching scheduler over ``prompts``: the tokens of
    each request, in uid order, and the prompt tokens served from the
    prefix cache."""
    sched = ContinuousBatchingScheduler(eng, max_slots=slots,
                                        prefill_chunk=chunk)
    out = sched.run([Request(uid=i, prompt=p, max_new=max_new)
                     for i, p in enumerate(prompts)])
    assert all(r.state == "DONE" for r in out["results"]), out["by_state"]
    res = sorted(out["results"], key=lambda r: r.uid)
    return [r.tokens.tolist() for r in res], out["cached_prompt_tokens"]


def features_rank(group, specs, prompts):
    """Each spec's engine on this rank under the scheduler (spec ``chunk``:
    the prefill chunk): {name: (tokens, cached prompt tokens, kv_shards)}."""
    torch.set_num_threads(1)
    out = {}
    for name, spec in specs.items():
        eng = build_engine(spec, group, str(group.device))
        toks, cached = scheduler_run(eng, prompts, chunk=spec.get("chunk"))
        stats_kv = eng._kv_shards if eng._paging_active else None
        out[name] = (toks, cached, stats_kv)
    return out


def paged_rank(grid, cases):
    """The paged and dense decode-attention collectives on this rank: each
    case (a dict of numpy arrays and options) cut as the serving engines
    cut it, through ``ops``' tensor-parallel dispatch; the rank's outputs
    gathered over heads where they are cut.  {name: output (numpy)}."""
    torch.set_num_threads(1)
    group = grid.model
    dev = group.device
    out = {}
    for name, c in cases.items():
        t = {k: torch.from_numpy(v).to(dev) for k, v in c.items()
             if isinstance(v, np.ndarray)}
        kw = dict(softcap=c.get("softcap"), window=c.get("window"))
        if c["kind"] == "dense":
            S = t["k"].shape[2] // group.size
            k = t["k"][:, :, group.rank * S:(group.rank + 1) * S]
            v = t["v"][:, :, group.rank * S:(group.rank + 1) * S]
            # this rank's positions [rank S, (rank + 1) S) of the cache
            pos = group.rank * S + torch.arange(S, device=dev)
            valid = pos[None, :] < t["lens"][:, None]
            got = collectives.distributed_decode_attention(
                t["q"], k.contiguous(), v.contiguous(), valid, group,
                softcap=c.get("softcap"))
            out[name] = got.cpu().numpy()
            continue
        cut = c["kind"] == "head_cut"
        q, k, v = t["q"], t["k"], t["v"]
        ks, vs = t.get("k_scale"), t.get("v_scale")
        if cut:
            q = sharding.shard(q, 1, group)
            k, v = sharding.shard(k, 2, group), sharding.shard(v, 2, group)
            if ks is not None:
                ks = sharding.shard(ks, 1, group)
                vs = sharding.shard(vs, 1, group)
        if ks is not None:
            k = QuantizedLeaf(k, ks, c["kv_dtype"], q.dtype)
            v = QuantizedLeaf(v, vs, c["kv_dtype"], q.dtype)
        got = ops.paged_decode_attention(q, k, v, t["table"], t["lens"],
                                         tp=group, head_cut=cut, **kw)
        out[name] = sharding.gather(got, group, c["q"].shape[1],
                                    dim=1).cpu().numpy()
    return out


def fail_on_rank_1(grid):
    """Rank 1 raises; rank 0 waits at a barrier for it."""
    if grid.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    grid.world.barrier()


def tp_rank(grid, specs, feature_specs, prompts):
    """:func:`serve_rank` and :func:`features_rank` in one spawn, on the
    ``(1, tp)`` grid's model group."""
    return (serve_rank(grid.model, specs),
            features_rank(grid.model, feature_specs, prompts))


def paged_card_rank(grid):
    """The head-cut and merge cases of the paged kernel's TP dispatch on
    this rank's card (bf16, 32 query heads of 128 over 8 KV heads and over
    one): the head cut bit for bit the unsharded kernel's heads, the merge
    within one bf16 ulp of the plain version plus the order bound of two
    sum orders.  Returns (bit-identical, within the bound, the merge's
    largest error) per rank."""
    from repro_torch.kernels import paged_attention as kpa
    from repro_torch.kernels import ref
    from torch_cases import paged_case
    group = grid.model
    dev = group.device
    res = {}
    for name, hkv in (("head_cut", 8), ("merge", 1)):
        c = paged_case(7, B=4, Hq=32, Hkv=hkv, D=128, ps=16, P=8,
                       lens=(0, 17, 100, 128), dtype=torch.bfloat16)
        q, k, v, table, lens = (c[n].to(dev) for n in
                                ("q", "k", "v", "table", "lens"))
        whole = kpa.paged_decode_attention(q, k, v, table, lens)
        if name == "head_cut":
            got = ops.paged_decode_attention(
                sharding.shard(q, 1, group), sharding.shard(k, 2, group),
                sharding.shard(v, 2, group), table, lens, tp=group,
                head_cut=True)
            res[name] = torch.equal(got, sharding.shard(whole, 1, group))
            continue
        got = ops.paged_decode_attention(q, k, v, table, lens, tp=group)
        plain = ref.paged_decode_attention(q, k, v, table, lens).float()
        bound = ref.paged_decode_order_bound(q, k, v, table, lens)
        ulp = torch.exp2(torch.floor(torch.log2(
            torch.clamp_min(plain.abs(), 2.0 ** -126))) - 7)
        diff = (got.float() - plain).abs()
        res[name] = bool((diff <= ulp + bound).all())
        res["merge_err"] = diff.max().item()
        res["merge_vs_unsharded"] = (got.float() - whole.float()).abs().max().item()
    return res


# ----------------------------------------------------------------------------
# The rest of the registry and entry points under TP (MoE, cross-attention,
# generate(), the online layer with one loop clock)
# ----------------------------------------------------------------------------
def generate_run(eng, prompts, fused, frontend=None, max_new=6):
    """``generate()`` on ``prompts`` (fused or stepwise) with the meter
    reset first: (tokens, the meter's bytes) -- the split-brain engine's
    per-token bytes at batch 1, as the JAX package reports them."""
    eng.meter.reset()
    if isinstance(eng, SplitBrainEngine):
        eng.fused = fused
        out = eng.generate(prompts, max_new=max_new)
        return out["tokens"], eng.measured_bytes_per_token()
    out = eng.generate(prompts, max_new=max_new, frontend=frontend,
                       fused=fused)
    return out["tokens"], eng.measured_bytes()


def _shapes(tree):
    out = {}
    sharding._map_paths(lambda p, t: out.__setitem__(p, list(t.shape)), tree)
    return out


class StepClock:
    """A clock source that advances ``dt`` seconds per reading, from
    ``t0``: the scheduler's decisions then depend on its iterations alone,
    and two ranks given different ones run apart."""

    def __init__(self, dt, t0=0.0):
        self.dt, self.t = dt, t0 - dt

    def __call__(self):
        self.t += self.dt
        return self.t


def lockstep_run(eng, spec, source, group=None):
    """The online layer on ``eng``: priorities, preemption, a deadline and
    a seeded chaos plan (``spec``: requests as (prompt, priority,
    deadline_s), ``plan``, ``slots``, ``max_new``), its loop clock read
    from ``source`` -- through the group's ``TPGroup.clock`` on ranks
    (rank 0's reading), as the scheduler's default clock reads it.
    Returns the tokens by uid, the request states, the recovery events
    without their seconds, the fired faults and the preemptions."""
    from repro_torch.serve.faults import FaultInjector, FaultPlan
    faults = FaultInjector(FaultPlan(**spec["plan"]), seed=0)
    clock = source if group is None else (lambda: group.clock(source))
    sched = ContinuousBatchingScheduler(
        eng, max_slots=spec["slots"], preemption=True, faults=faults,
        clock=clock)
    out = sched.run([Request(uid=i, prompt=p, max_new=spec["max_new"],
                             priority=prio, deadline_s=dl)
                     for i, (p, prio, dl) in enumerate(spec["requests"])])
    res = sorted(out["results"], key=lambda r: r.uid)
    return {"tokens": [r.tokens.tolist() for r in res],
            "states": [r.state for r in res],
            "events": [{k: v for k, v in e.items() if k != "recovery_s"}
                       for e in sched.recovery_log],
            "fired": [e[0] for e in faults.events],
            "preemptions": out["preemptions"]}


def families_rank(grid, moe_specs, gen_specs, fused_only, sched_spec,
                  skew):
    """One rank of ``tests/test_torch_tp_serve_families.py``: the MoE
    configs through the slot protocol (tokens, bytes, kv_shards and the
    drop log's (rows, capacity, dropped) per call), the ``gen_specs``
    through ``generate()`` fused and stepwise (except the names in
    ``fused_only``; each case's ``frontend``) with the rank's cache shapes
    of a frontend case, and, with ``sched_spec``, :func:`lockstep_run`
    with rank 1's clock source ``skew`` (dt, t0) apart from rank 0's."""
    from repro_torch.models import moe
    torch.set_num_threads(1)
    group = grid.model
    dev = str(group.device)
    out = {"moe": {}, "gen": {}, "cache": {}, "sched": None}
    for name, spec in moe_specs.items():
        eng = build_engine(spec, group, dev)
        log = moe.drop_log()
        toks, nbytes, stats = slot_run(eng)
        drops = [(e["rows"], e["capacity"], int(e["dropped"])) for e in log]
        moe.drop_log(False)
        out["moe"][name] = (toks, nbytes, stats.get("kv_shards"), drops)
    for name, spec in gen_specs.items():
        eng = build_engine(spec, group, dev)
        fe = spec.get("frontend")
        fe = None if fe is None else torch.from_numpy(fe)
        out["gen"][name] = {
            fused: generate_run(eng, spec["prompts"], fused, fe)
            for fused in ((True,) if name in fused_only else (True, False))}
        if fe is not None:
            out["cache"][name] = _shapes(api.init_cache(
                eng.cfg, len(spec["prompts"]), eng.max_len, frontend=fe,
                params=eng.params, device=dev, tp=group))
    if sched_spec is not None:
        eng = build_engine(sched_spec, group, dev)
        source = StepClock(*((0.01, 0.0) if group.rank == 0 else skew))
        out["sched"] = lockstep_run(eng, sched_spec, source, group)
    return out


def vlm_card_case(layers, B, T0, dev):
    """llama-3.2-vision-11b at full width and ``layers`` layers (bf16
    weights from a seeded generator on ``dev``, every cross gate 0.7: a
    zero gate hides the cross path), B seeded prompts of T0 tokens and B
    seeded frontends: (cfg, params, prompts, frontend)."""
    import dataclasses
    cfg = dataclasses.replace(get_config("llama-3.2-vision-11b"),
                              num_layers=layers)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = api.init_params(cfg, gen, device=dev, dtype=torch.bfloat16)
    params["cross"]["gate"] = torch.full(
        (layers // cfg.cross_attn_every,), 0.7, device=dev)
    prompts = np.random.default_rng(1).integers(
        1, cfg.vocab_size, (B, T0)).astype(np.int32)
    fe = torch.randn((B, cfg.frontend_tokens, cfg.d_model), generator=gen,
                     device=dev)
    return cfg, params, prompts, fe


def vlm_card_rank(grid, layers, B, T0, new):
    """The VLM's fused ``generate()`` on this rank's card (its shard of
    :func:`vlm_card_case`'s weights): (tokens, launch counts)."""
    dev = grid.model.device
    cfg, params, prompts, fe = vlm_card_case(layers, B, T0, dev)
    eng = ServeEngine(cfg, params, max_len=T0 + new, device=dev,
                      tp=grid.model)
    del params
    ops.reset_launch_counts()
    out = eng.generate(prompts, max_new=new, frontend=fe)
    torch.cuda.synchronize()
    return out["tokens"], ops.launch_counts()


# ----------------------------------------------------------------------------
# The sequence-cut dense decode (parallel.decode_attn="shard_map")
# ----------------------------------------------------------------------------
def seq_decode_run(eng, run, tp):
    """One run of ``tests/test_torch_seq_decode.py`` on ``eng`` at ``tp``:
    ``kind`` "generate" (fused, and stepwise where ``run["stepwise"]``
    names tp, on ``run["prompts"]``, with its ``frontend`` for encdec) or
    "sched" (the scheduler over ``run["prompts"]``, ``run["chunk"]`` its
    prefill chunk).  Returns {mode: tokens as lists}."""
    if run["kind"] == "generate":
        fe = run.get("frontend")
        fe = None if fe is None else torch.from_numpy(fe)
        modes = (True, False) if tp in run["stepwise"] else (True,)
        return {str(f): eng.generate(run["prompts"], max_new=run["new"],
                                     frontend=fe, fused=f)["tokens"].tolist()
                for f in modes}
    return {"sched": scheduler_run(eng, run["prompts"], max_new=run["new"],
                                   chunk=run.get("chunk"))[0]}


def seq_decode_rank(grid, specs, cases, tp):
    """The runs of the sequence-cut decode that run at ``tp`` (each run's
    ``tp``) on this rank (grid None: one device), each case an engine of
    ``specs[case["spec"]]`` with the case's options serving its runs in
    turn: {name: ({run index: tokens}, the rank's shapes of a fresh dense
    cache)}."""
    torch.set_num_threads(1)
    group = grid.model if grid is not None else None
    out = {}
    for name, case in cases.items():
        runs = {i: r for i, r in enumerate(case["runs"]) if tp in r["tp"]}
        if not runs:
            continue
        eng = build_engine(dict(specs[case["spec"]], kw=case["kw"]), group)
        fe = case["runs"][0].get("frontend")
        fe = None if fe is None else torch.from_numpy(fe)
        like = api.init_cache(eng.cfg, 2 if fe is None else fe.shape[0],
                              eng.max_len, frontend=fe,
                              params=None if fe is None else eng.params,
                              device="cpu", tp=group)
        out[name] = ({str(i): seq_decode_run(eng, r, tp)
                      for i, r in runs.items()},
                     _shapes(like))
    return out


# ----------------------------------------------------------------------------
# The OnlineServer on tensor-parallel ranks
# ----------------------------------------------------------------------------
class _Raises:
    """A request's stream that passes each token on to ``stream`` (the
    handle's) and then raises at its ``at``-th token: a consumer that is
    gone, which the scheduler cancels."""

    def __init__(self, stream, at):
        self.stream, self.at, self.seen = stream, at, 0

    def __call__(self, tok):
        self.stream(tok)
        self.seen += 1
        if self.seen >= self.at:
            raise ValueError("the consumer is gone")


def _raising_streams(sched, raise_at):
    """Make ``sched.submit`` give request ``uid``'s stream a consumer that
    raises at its ``raise_at[uid]``-th token (where the request has a
    stream: on rank 0, which holds the handles)."""
    submit = sched.submit

    def planted(req):
        if req.uid in raise_at and req.stream is not None:
            req.stream = _Raises(req.stream, raise_at[req.uid])
        return submit(req)

    sched.submit = planted


def _kept_results(sched):
    """Make ``sched.poll`` also keep what it returns (on every rank: a rank
    other than 0 holds no handles); returns that list."""
    kept, poll = [], sched.poll

    def keep():
        out = poll()
        kept.extend(out)
        return out

    sched.poll = keep
    return kept


def online_scenario(eng, group, spec):
    """The OnlineServer on ``eng`` (rank 0 of ``group`` the front end, or
    one device), as a user writes it: rank 0 submits ``spec["requests"]``
    (prompt, max_new, extras: ``deadline_s``, ``priority``, ``cancel_at``
    -- the client cancels after that many streamed tokens --, ``raise_at``
    -- its stream raises at that token, as a gone consumer's) from a client
    thread, one consumer thread per request reading its stream; a
    ``step_stall`` of ``spec["stall_s"]`` at iteration ``spec["stall_at"]``
    trips a ``spec["watchdog_s"]`` watchdog.  Returns the tokens, states
    and gen_len by uid (every rank's scheduler results), the recovery
    events without their seconds, the fired faults, rank 0's streamed
    tokens by uid and its handles' states, the server's stats, and the
    scheduler's prefill tokens and decode steps."""
    import threading
    from repro_torch.serve.faults import FaultInjector, FaultPlan
    from repro_torch.serve.server import OnlineServer
    inj = FaultInjector(FaultPlan(step_stall_at=spec["stall_at"],
                                  step_stall_s=spec["stall_s"]), seed=0)
    sched = ContinuousBatchingScheduler(eng, max_slots=spec["slots"],
                                        faults=inj)
    kept = _kept_results(sched)
    # uids are given in submission order, from 0
    _raising_streams(sched, {uid: extra["raise_at"] for uid, (_, _, extra)
                             in enumerate(spec["requests"])
                             if "raise_at" in extra})
    srv = OnlineServer(sched, watchdog_s=spec["watchdog_s"])
    streamed, handles = {}, {}
    front = group is None or group.rank == 0
    with srv:
        if front:
            def consume(h, cancel_at):
                toks = []
                for tok in h.stream():
                    toks.append(int(tok))
                    if cancel_at is not None and len(toks) == cancel_at:
                        h.cancel()
                streamed[h.uid] = toks

            def client():
                threads = []
                for prompt, max_new, extra in spec["requests"]:
                    h = srv.submit(
                        np.asarray(prompt, np.int32), max_new=max_new,
                        priority=extra.get("priority", 0),
                        deadline_s=extra.get("deadline_s"))
                    handles[h.uid] = h
                    t = threading.Thread(target=consume,
                                         args=(h, extra.get("cancel_at")))
                    t.start()
                    threads.append(t)
                for t in threads:
                    t.join()

            c = threading.Thread(target=client)
            c.start()
            c.join()
            for h in handles.values():
                h.result(timeout=120)
    res = sorted(kept, key=lambda r: r.uid)
    return {"tokens": {r.uid: r.tokens.tolist() for r in res},
            "states": {r.uid: r.state for r in res},
            "events": [{k: v for k, v in e.items() if k != "recovery_s"}
                       for e in sched.recovery_log],
            "fired": [e[0] for e in inj.events],
            "streamed": streamed,
            "handles": {u: h.result().state for u, h in handles.items()},
            "stats": {k: v for k, v in srv.stats().items()
                      if k in ("watchdog_trips", "recoveries",
                               "outstanding")},
            "prefill_tokens": sched._prefill_tokens,
            "decode_steps": sched._decode_steps}


def online_stop_nodrain(eng, group, prompts, max_new):
    """``stop(drain=False)`` right after rank 0 submits ``prompts``: every
    rank's loop ends; rank 0 returns its handles' states."""
    from repro_torch.serve.server import OnlineServer
    srv = OnlineServer(ContinuousBatchingScheduler(eng, max_slots=2)).start()
    handles = []
    if group is None or group.rank == 0:
        handles = [srv.submit(np.asarray(p, np.int32), max_new=max_new)
                   for p in prompts]
    srv.stop(drain=False)
    return [h.result(timeout=60).state for h in handles]


def online_loop_error(eng, group, prompts, fail_rank, fail_at):
    """A loop error on rank ``fail_rank`` (its engine's ``fail_at``-th decode
    step raises): what ``stop()`` raised on this rank, and rank 0's
    handles' states.  Tears the group down: run it last."""
    from repro_torch.serve.server import OnlineServer
    srv = OnlineServer(ContinuousBatchingScheduler(eng, max_slots=2))
    if group.rank == fail_rank:
        step, calls = eng.decode_slots, [0]

        def decode_slots(*a, **k):
            calls[0] += 1
            if calls[0] == fail_at:
                raise RuntimeError("a device step failed on this rank")
            return step(*a, **k)
        eng.decode_slots = decode_slots
    srv.start()
    handles = []
    if group.rank == 0:
        handles = [srv.submit(np.asarray(p, np.int32), max_new=8)
                   for p in prompts]
    states = [h.result(timeout=120).state for h in handles]
    try:
        srv.stop()
        raised = None
    except RuntimeError as e:
        raised = str(e)
    return {"raised": raised, "states": states}


def online_rank(grid, specs, scenario, nodrain, error):
    """One rank of ``tests/test_torch_tp_online.py`` (grid None: one
    device): per engine spec, :func:`online_scenario` and
    :func:`online_stop_nodrain`; then, with ``error`` (ranks only),
    :func:`online_loop_error` on the first spec's engine."""
    torch.set_num_threads(1)
    group = grid.model if grid is not None else None
    out = {}
    for name, spec in specs.items():
        eng = build_engine(spec, group)
        out[name] = {"scenario": online_scenario(eng, group, scenario),
                     "nodrain": online_stop_nodrain(eng, group, *nodrain)}
    if error is not None and group is not None:
        eng = build_engine(next(iter(specs.values())), group)
        out["error"] = online_loop_error(eng, group, *error)
    return out
