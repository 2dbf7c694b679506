"""Rank bodies of the tensor-parallel tests: module-level functions that
``repro_torch.distributed.runtime.spawn`` runs on every rank of a gloo
group on the CPU (the card tests run them on ``cuda:0``).  Imports neither
JAX nor the JAX package: the ranks are new processes, and the JAX side of
each comparison runs in the test's own process."""
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
    None for the port's seeded ones), splitbrain, kw) on ``device`` for the
    group ``tp`` (None: one device)."""
    cfg = get_config(spec["arch"]).reduced(**spec.get("overrides", {}))
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
