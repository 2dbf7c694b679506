"""The port's serving CLI: batched greedy decoding of an lm-family (dense,
MoE or cross-attention), an rwkv, a hymba or an encoder-decoder config with
the float ``ServeEngine``, on the card unless asked otherwise.

  # on a machine with the card: llama2-7b at full size, random weights
  python -m repro_torch.launch.serve --arch llama2-7b --continuous \
      --page-size 16 --requests 8 --slots 4 --prompt-len 64 --max-new 32

  # on the CPU, reduced config (plain versions of the kernels)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
      --smoke --device cpu --continuous --page-size 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
      --smoke --device cpu --continuous
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
      --smoke --device cpu --continuous
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch phi3.5-moe-42b-a6.6b --smoke --device cpu --continuous \
      --page-size 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
      --smoke --device cpu --continuous --page-size 8 --prefix-cache on \
      --prefill-chunk 8 --kv-dtype int8

  # the frontend configs (generate() only): a VLM, an encoder-decoder
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch llama-3.2-vision-11b --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch seamless-m4t-medium --smoke --device cpu

  # online semantics: SLA classes, deadlines, SLA-aware preemption
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
      --smoke --device cpu --continuous --page-size 8 --priority 0,0,0,1 \
      --deadline-s 5 --preemption on

  # chaos: seeded faults against the recovery seam; --recovery-log writes
  # the quarantine / recover event stream as JSON
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
      --smoke --device cpu --continuous --page-size 8 --prefill-chunk 8 \
      --prefix-cache on --chaos-seed 0 --recovery-log events.json \
      --chaos-plan "step_corrupt_at=4,step_corrupt_iters=2,device_loss_at=10"

  # tensor-parallel serving over two ranks (gloo on the CPU; on a machine
  # with one card both ranks share it over gloo, with two or more NCCL)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
      --smoke --device cpu --continuous --page-size 8 --tp 2
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch llama-3.2-vision-11b --smoke --device cpu --tp 2

Without ``--continuous`` it runs ``ServeEngine.generate`` on ``--batch``
prompts of ``--prompt-len`` tokens (with, for a VLM or encoder-decoder
config, a float32 ``frontend`` of ``frontend_tokens`` standard-normal
vectors per prompt, drawn after the prompts from the same seeded
generator, as the JAX package's CLI draws them); with it, ``--requests`` ragged prompts
go through the continuous-batching scheduler over ``--slots`` slots (a page
pool with ``--page-size`` where some cache leaf grows with the sequence,
else a dense slot cache: rwkv's recurrent state, hymba's ring once the
window binds), with chunked prefill (``--prefill-chunk``), prefix reuse
(``--prefix-cache on``), an int8 / fp8 pool (``--kv-dtype``), the gather
discipline (``--paged-attn gather``), SLA classes (``--priority``),
deadlines (``--deadline-s``), SLA-aware preemption (``--preemption on``)
and seeded fault injection (``--chaos-plan``, ``--chaos-seed``,
``--recovery-log``) as asked.  Weights come from ``api.init_params`` with
a ``torch.Generator`` seeded by ``--seed``.  Prints one JSON report, as
the JAX package's ``repro.launch.serve`` does.

``--tp N`` (N > 1) serves on N ranks of a ``torch.distributed`` group, one
process each (``distributed/runtime.py``): every rank builds the engine
over its shard of the same seeded weights and serves the same requests;
rank 0's report is printed, with ``tp``, ``tp_backend`` and
``tp_devices``, and the run fails if any rank raises or if the ranks'
tokens, request states (``by_state``) or recovery events (the
``--recovery-log`` stream without its seconds) differ.  The ranks share
``cuda:0`` over gloo where the host has fewer than N cards, and take one
card each over NCCL otherwise.  Every config and every flag serves under
``--tp``: ``generate()`` without ``--continuous``, and the continuous
scheduler with the KV-cache, online and chaos flags, its deadlines and
arrivals decided on rank 0's loop clock (``serve/scheduler.py``).  Only
rank 0 writes ``--recovery-log``.

The MoE configs at full depth do not fit one 80 GB card (phi3.5-moe-42b-a6.6b
holds 2.6 GB of bf16 weights per layer, 83 GB at its 32 layers;
qwen3-moe-235b-a22b 4.9 GB per layer at 94 layers): run them with
``--smoke`` here, and at full width on the card through ``chip_smoke.py``'s
``moe_path``, which cuts their depth.  llama-3.2-vision-11b and
seamless-m4t-medium serve through ``generate()`` only: with
``--continuous`` the CLI exits with the engine's refusal, as the JAX
package's engine refuses their slot caches.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.registry import CONFIGS
from repro_torch.core.device import matmul_settings, resolve_device
from repro_torch.distributed import runtime
from repro_torch.models import api
from repro_torch.serve import pages
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.faults import FaultInjector, FaultPlan
from repro_torch.serve.scheduler import ContinuousBatchingScheduler, Request

# families the float ServeEngine serves
SERVED = ("lm", "rwkv", "hymba", "encdec")


def _parse_chaos_plan(spec: str, ap: argparse.ArgumentParser) -> FaultPlan:
    """``key=val,key=val`` over FaultPlan's fields, coerced per field type
    (tuple fields take ``+``-separated uids, e.g. ``step_corrupt_uids=1+3``),
    as the JAX package's CLI parses it."""
    fields = {f.name: f for f in dataclasses.fields(FaultPlan)}
    kwargs = {}
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        key, sep, val = item.partition("=")
        key, val = key.strip(), val.strip()
        if not sep or key not in fields:
            ap.error(f"--chaos-plan: unknown or malformed entry {item!r} "
                     f"(fields: {', '.join(sorted(fields))})")
        ftype = str(fields[key].type)
        try:
            if "Tuple" in ftype:
                kwargs[key] = tuple(int(v) for v in val.split("+") if v)
            elif ftype == "float":
                kwargs[key] = float(val)
            else:
                kwargs[key] = int(val)
        except ValueError:
            ap.error(f"--chaos-plan: bad value {val!r} for {key} ({ftype})")
    if not kwargs:
        ap.error("--chaos-plan named no fault points")
    return FaultPlan(**kwargs)


def _priorities(args, ap: argparse.ArgumentParser):
    if args.priority is None:
        return [0]
    try:
        out = [int(p) for p in args.priority.split(",") if p != ""]
    except ValueError:
        ap.error(f"--priority must be comma-separated integers, "
                 f"got {args.priority!r}")
    if not out:
        ap.error("--priority must name at least one SLA class")
    return out


def _setup(argv):
    """Parse and check ``argv``: (parser, args, config, fault injector or
    None, priority classes)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-7b",
                    help="config name; the MoE configs "
                         "(phi3.5-moe-42b-a6.6b, qwen3-moe-235b-a22b) do "
                         "not fit one 80 GB card at full depth: serve them "
                         "with --smoke, or at full width at cut depth "
                         "through chip_smoke.py's moe_path")
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced config of --arch")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions (default: cuda, which needs a card)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--continuous", action="store_true",
                    help="serve --requests ragged prompts via the "
                         "slot-based continuous-batching scheduler")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=None,
                    help="enable the paged KV cache with this page size "
                         "(tokens per page; must divide max_len)")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="page-pool capacity (default: dense-equivalent)")
    ap.add_argument("--paged-attn", choices=("inplace", "gather"),
                    default="inplace",
                    help="paged decode discipline: 'inplace' attends through "
                         "the page table (the paged kernel on the card); "
                         "'gather' runs the dense decode step on the "
                         "gathered view")
    ap.add_argument("--kv-dtype", choices=("bf16", "int8", "fp8"),
                    default="bf16",
                    help="page-pool storage format: int8/fp8 pages quantize "
                         "on write with per-page per-KV-head scales and are "
                         "dequantized by the paged kernel; requires "
                         "--page-size")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked prefill width (prompt chunks interleaved "
                         "with decode steps)")
    ap.add_argument("--prefix-cache", choices=("on", "off"), default="off",
                    help="shared-prefix KV reuse through the pool's radix "
                         "index (copy-on-write pages); requires --page-size")
    ap.add_argument("--priority", default=None,
                    help="comma-separated SLA classes cycled over the "
                         "request stream (higher wins admission and may "
                         "preempt lower), e.g. '0,0,0,1'")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request deadline in seconds from serve-loop "
                         "start; a request not finished by then terminates "
                         "as TIMEOUT (slot and pages freed)")
    ap.add_argument("--preemption", choices=("on", "off"), default="off",
                    help="SLA-aware preemption: when a higher-priority "
                         "request cannot be admitted, evict a lower-"
                         "priority victim (publishing its full pages to "
                         "the prefix cache first) and re-queue it with "
                         "bounded exponential backoff")
    ap.add_argument("--chaos-plan", default=None,
                    help="seeded fault injection: comma-separated "
                         "FaultPlan fields (repro_torch/serve/faults.py), "
                         "e.g. 'step_corrupt_at=4,step_corrupt_iters=2,"
                         "device_loss_at=10'")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="PRNG seed for --chaos-plan: same (plan, seed) -> "
                         "same fault sequence")
    ap.add_argument("--recovery-log", default=None,
                    help="write the scheduler's quarantine / recover event "
                         "stream to this path as JSON")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree: serve on this many ranks, "
                         "one process each (the module docstring)")
    args = ap.parse_args(argv)
    if args.tp < 1:
        ap.error(f"--tp must be at least 1, got {args.tp}")
    if args.num_pages is not None and args.page_size is None:
        ap.error("--num-pages requires --page-size (the paged KV cache)")
    if args.prefix_cache == "on" and args.page_size is None:
        ap.error("--prefix-cache on requires --page-size (the prefix index "
                 "shares pool pages)")
    if args.kv_dtype != "bf16" and args.page_size is None:
        ap.error("--kv-dtype int8/fp8 requires --page-size (quantization "
                 "scales live per pool page)")
    if not args.continuous and (args.page_size is not None
                                or args.num_pages is not None
                                or args.prefill_chunk is not None):
        ap.error("--page-size/--num-pages/--prefill-chunk only apply to the "
                 "--continuous serve loop")
    if not args.continuous and (args.priority is not None
                                or args.deadline_s is not None
                                or args.preemption == "on"):
        ap.error("--priority/--deadline-s/--preemption only apply to the "
                 "--continuous serve loop")
    if not args.continuous and (args.chaos_plan is not None
                                or args.recovery_log is not None):
        ap.error("--chaos-plan/--recovery-log only apply to the "
                 "--continuous serve loop")
    faults = None
    if args.chaos_plan is not None:
        faults = FaultInjector(_parse_chaos_plan(args.chaos_plan, ap),
                               seed=args.chaos_seed)
    priorities = _priorities(args, ap)

    if args.arch not in CONFIGS or CONFIGS[args.arch].family not in SERVED:
        ap.error(f"--arch {args.arch}: not ported yet (the port serves "
                 f"{', '.join(sorted(CONFIGS))})")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    return ap, args, cfg, faults, priorities


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    ap, args, cfg, faults, priorities = _setup(argv)
    device = resolve_device(args.device)
    if args.tp == 1:
        report, out = _serve(ap, args, cfg, device, faults, priorities)
        print(json.dumps(report))
        return out
    backend, devices = runtime.plan((1, args.tp), device)
    ranks = runtime.spawn(_serve_rank, (1, args.tp), (argv,),
                          backend=backend, devices=devices)
    report, lock = ranks[0]
    for what, name in (("tokens", "decoded different tokens"),
                       ("by_state", "ended requests in different states"),
                       ("events", "logged different recovery events")):
        if any(other[what] != lock[what] for _, other in ranks[1:]):
            raise RuntimeError(f"the tensor-parallel ranks {name}")
    report.update(tp=args.tp, tp_backend=backend, tp_devices=devices)
    print(json.dumps(report))
    return {"report": report, "tokens": lock["tokens"],
            "by_state": lock["by_state"], "events": lock["events"],
            "log_writers": [r for r, (rep, _) in enumerate(ranks)
                            if "recovery_log" in rep]}


def _serve_rank(grid, argv):
    """One rank of ``--tp`` (a ``(1, tp)`` grid): the same serving run as
    one device, with its shard of the engine; returns (report, what the
    ranks must agree on: the tokens, the request states and the recovery
    events without their seconds)."""
    ap, args, cfg, faults, priorities = _setup(argv)
    report, out = _serve(ap, args, cfg, grid.device, faults, priorities,
                         tp=grid.model)
    if not args.continuous:
        return report, {"tokens": out["tokens"].tolist(), "by_state": None,
                        "events": None}
    return report, {
        "tokens": [r.tokens.tolist() for r in out["results"]],
        "by_state": out["by_state"],
        "events": [{k: v for k, v in e.items() if k != "recovery_s"}
                   for e in out["recovery_log"]]}


def _serve(ap, args, cfg, device, faults, priorities, tp=None):
    """Build the engine (``tp``: this rank's shard) and serve: (the JSON
    report, the scheduler's or generate()'s output)."""
    # the lm and encdec families' projections are drawn straight into the
    # compute dtype the engine serves them in (full-width gemma2-27b would
    # not fit the card in float32)
    kw = ({"dtype": getattr(torch, cfg.dtype)}
          if cfg.family in ("lm", "encdec") else {})
    params = api.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed), device,
        **kw)
    rng = np.random.default_rng(args.seed)

    if args.continuous:
        # pages and prefill chunks must both tile the cache
        max_len = pages.round_len(args.prompt_len + args.max_new + 1,
                                  args.page_size, args.prefill_chunk)
        eng = ServeEngine(cfg, params, max_len=max_len,
                          page_size=args.page_size, num_pages=args.num_pages,
                          paged_attn=args.paged_attn,
                          prefix_cache=args.prefix_cache,
                          kv_dtype=args.kv_dtype, device=device, tp=tp)
        del params
        lo = min(2, args.prompt_len)
        reqs = [Request(uid=i,
                        prompt=rng.integers(
                            1, cfg.vocab_size,
                            (int(rng.integers(lo, args.prompt_len + 1)),)
                        ).astype(np.int32),
                        max_new=args.max_new,
                        priority=priorities[i % len(priorities)],
                        deadline_s=args.deadline_s)
                for i in range(args.requests)]
        sched = ContinuousBatchingScheduler(
            eng, max_slots=args.slots, eos_id=args.eos_id,
            prefill_chunk=args.prefill_chunk,
            preemption=args.preemption == "on", faults=faults)
        try:
            out = dict(sched.run(reqs), recovery_log=sched.recovery_log)
        except ValueError as e:      # the engine refuses this config's slots
            ap.error(f"--continuous --arch {args.arch}: {e}")
        report = {
            "arch": cfg.name,
            "device": str(device),
            "matmul": matmul_settings(),
            "requests": args.requests,
            "slots": args.slots,
            "steps": out["steps"],
            "decoded_tokens": out["decoded_tokens"],
            "tokens_per_s": round(out["tokens_per_s"], 2),
            "requests_per_s": round(out["requests_per_s"], 2),
            "gen_len": [r.gen_len for r in out["results"]],
            "cached_prompt_tokens": out["cached_prompt_tokens"],
            "rejected": [(r.uid, r.reason) for r in out["rejected"]],
            "by_state": out["by_state"],
            "preemptions": out["preemptions"],
            "tokens": [r.tokens.tolist() for r in out["results"]],
            "tp": args.tp,
        }
        if args.page_size:
            report["cache"] = eng.cache_stats(sched.cache)
        if faults is not None:
            fired: dict = {}
            for name, *_ in faults.events:
                fired[name] = fired.get(name, 0) + 1
            report["chaos"] = {
                "seed": args.chaos_seed,
                "fired": fired,
                "quarantines": out["quarantines"],
                "failed": out["failed"],
                "recoveries": out["recoveries"],
                "last_recovery_s": round(out["last_recovery_s"], 4),
            }
        if args.recovery_log is not None and (tp is None or tp.rank == 0):
            Path(args.recovery_log).write_text(
                json.dumps(sched.recovery_log, indent=2) + "\n")
            report["recovery_log"] = args.recovery_log
        return report, out

    prompts = rng.integers(1, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    frontend = (rng.standard_normal(
        (args.batch, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
        if cfg.frontend_tokens else None)
    eng = ServeEngine(cfg, params, max_len=args.prompt_len + args.max_new + 1,
                      device=device, tp=tp)
    del params
    out = eng.generate(prompts, max_new=args.max_new, frontend=frontend,
                       eos_id=args.eos_id)
    return {
        "arch": cfg.name,
        "device": str(device),
        "matmul": matmul_settings(),
        "batch": args.batch,
        "generated": out["tokens"][:2, :8].tolist(),
        "gen_len": out["gen_len"].tolist(),
        "tokens_per_s": round(out["tokens_per_s"], 2),
        "tp": args.tp,
    }, out


if __name__ == "__main__":
    main()
