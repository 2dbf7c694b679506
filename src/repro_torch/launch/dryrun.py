"""Multi-card dry run: trace one rank's step of every (arch x shape) cell on
a (16, 16) grid of H100s, on the ``meta`` device.

The JAX package's ``launch/dryrun.py`` lowers and compiles each cell for
512 forced host devices and parses the HLO.  The port runs one process
per rank, so a cell here is rank 0's step, traced, not lowered: the rank's
params, optimizer state, cache and inputs are meta tensors (shapes only,
nothing allocated on any device), its groups are stand-ins that record
their collectives (``launch/op_analysis.py``), and the step runs eagerly
under a tally of its FLOPs, HBM bytes, collective bytes, kernels and live
memory.  For each cell this shows, without hardware:

  * that the port's cuts give every rank a step that runs (the shapes of
    every op agree),
  * whether it fits: the rank's argument bytes and its temporaries' high
    water mark against the card's 80 GB,
  * and the roofline terms at an H100's peaks (``op_analysis.Roofline``).

The layouts: train and prefill take the training cuts (``api.
train_layout``: FSDP over "data", Megatron's cuts over "model"), with the
batch cut over "data" (``adapt_parallel``); decode takes the port's serve
cuts (``sharding.shard_params``: weights cut over "model" only, whole over
"data", as ``ServeEngine`` holds them; the JSON says ``"layout":
"serve"``), where the JAX package's decode lowers over ``param_pspecs``
with FSDP over "data" too.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma2-27b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--variant opt]
"""
from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import os
import sys
import time
import traceback
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs import ASSIGNED, SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import sharding
from repro_torch.launch import op_analysis as oa
from repro_torch.models import api
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import step as step_mod

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "experiments", "dryrun_torch")
GRID = (16, 16)
AXES = ("data", "model")


def cell_skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return ("full-attention arch: 500k decode needs sub-quadratic "
                "attention (DESIGN.md §7)")
    return None


OPT_NOTES = """--variant opt applies (per shape kind; EXPERIMENTS.md §Perf):
  decode : H2 shard_map LSE flash-decode over the seq-sharded cache +
           aligned cache writes (kills the cache all-gather/scatter);
           H3 paper-technique W4A8 device weights (s8-direct MXU dots).
  train/prefill : H1 chunked matmul-form WKV for rwkv (rwkv_chunk=64);
           H4 ZeRO-3 per-layer weight gather (MoE experts excluded) +
           residual-stream batch pinning; G1 grouped-einsum attention
           (in ref.mha_chunked, always on after the G1 commit — the
           original baselines are preserved in experiments/dryrun_baseline/).
"""


def apply_variant(cfg: ModelConfig, shape: ShapeConfig, variant: str) -> ModelConfig:
    if variant == "baseline":
        return cfg
    assert variant == "opt", variant
    if cfg.family == "rwkv":
        cfg = dataclasses.replace(cfg, rwkv_chunk=64)
    if cfg.family == "hymba":
        cfg = dataclasses.replace(cfg, ssm_scan="associative")
    if shape.kind in ("train", "prefill"):
        par = dataclasses.replace(cfg.parallel, gather_fsdp_weights=True)
        cfg = dataclasses.replace(cfg, parallel=par)
    if shape.kind == "decode":
        par = dataclasses.replace(cfg.parallel, decode_attn="shard_map")
        ita = dataclasses.replace(cfg.ita, quantize_weights=True)
        cfg = dataclasses.replace(cfg, parallel=par, ita=ita)
    return cfg


@dataclasses.dataclass(frozen=True)
class GridShape:
    """A grid by its axes' sizes only (what ``adapt_parallel`` reads of
    the JAX package's mesh): ``shape[axis]`` and ``axis_names``."""
    shape: Dict[str, int]

    @property
    def axis_names(self):
        return tuple(self.shape)


def grid_shape(shape=GRID) -> GridShape:
    return GridShape(dict(zip(AXES, shape)))


def adapt_parallel(cfg: ModelConfig, shape: ShapeConfig, mesh) -> ModelConfig:
    """Per-cell parallelism fixes: drop batch axes that don't divide."""
    par = cfg.parallel
    sizes = [mesh.shape[a] for a in par.batch_axes if a in mesh.axis_names]
    total = 1
    for s in sizes:
        total *= s
    if shape.global_batch % max(total, 1) != 0:
        # keep the largest prefix of batch axes that divides
        axes = []
        prod = 1
        for a in par.batch_axes:
            if a in mesh.axis_names and shape.global_batch % (prod * mesh.shape[a]) == 0:
                axes.append(a)
                prod *= mesh.shape[a]
        par = dataclasses.replace(par, batch_axes=tuple(axes))
    return dataclasses.replace(cfg, parallel=par)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # decode: one token


def model_bytes(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Minimum-necessary global HBM traffic for one step (the memory-roofline
    floor).  bf16 weights/activations; fp32 optimizer state.

      train   : weights read fwd+bwd (2x2P) + grads written (2P) + AdamW
                moments read+written (2 x 8P fp32, or 2P int8-quantized)
      prefill : weights read once (2P) + KV cache written once
      decode  : active weights read once per step (2P_act; batch amortizes)
                + the whole KV cache / recurrent state read once
    """
    P_tot = cfg.param_count()
    P_act = cfg.active_param_count()
    B, T = shape.global_batch, shape.seq_len
    kv_bytes_full = 0.0
    n_groups = cfg.num_layers
    window = None
    if cfg.layer_pattern:
        windows = [s.window for s in cfg.layer_pattern]
        per_layer = []
        for i in range(cfg.num_layers):
            w = windows[i % len(windows)]
            s_len = min(T, w) if w else T
            per_layer.append(s_len)
        kv_bytes_full = sum(2 * s_len * cfg.kv_dim * 2 * B for s_len in per_layer)
    if cfg.family == "rwkv":
        hd = 64
        kv_bytes_full = cfg.num_layers * B * (cfg.d_model // hd) * hd * hd * 4
    if cfg.family == "hymba":
        ssm_state = (cfg.ssm.state_dim if cfg.ssm else 16)
        kv_bytes_full += cfg.num_layers * B * cfg.d_model * ssm_state * 4
    if shape.kind == "train":
        moments = 4.0 * P_tot if cfg.param_count() > 5e10 else 32.0 * P_tot
        return 6.0 * P_tot + moments  # 2P fwd + 2P bwd + 2P grads (+opt)
    if shape.kind == "prefill":
        return 2.0 * P_tot + kv_bytes_full
    # decode: every live weight streams once; whole cache read once
    return 2.0 * P_act + kv_bytes_full


# ----------------------------------------------------------------------------
# One rank's step
# ----------------------------------------------------------------------------
@dataclasses.dataclass
class Step:
    """One rank's step, built on a device: ``run()`` runs it once and
    returns its outputs; ``args`` are the trees it takes (params, state,
    cache, inputs) and ``argument_bytes`` their bytes as the rank holds
    them (a grid step cuts its data rank's rows out of the global batch
    itself: only those rows count)."""
    run: Callable[[], Any]
    args: tuple
    argument_bytes: int


def batch_rows(cfg: ModelConfig, shape: ShapeConfig, grid) -> int:
    """The rows of the batch a rank holds: ``B / dp`` where the cell's
    batch axes (after :func:`adapt_parallel`) keep "data", else all."""
    dp = grid.data.size if "data" in cfg.parallel.batch_axes else 1
    return shape.global_batch // dp


def inputs(cfg: ModelConfig, shape: ShapeConfig, rows: int, device,
           generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
    """:func:`api.input_specs` of ``rows`` rows on ``device``: empty on
    meta, seeded tokens (and a frontend) elsewhere."""
    specs = api.input_specs(cfg, dataclasses.replace(shape,
                                                     global_batch=rows))
    if torch.device(device).type == "meta":
        return specs
    out = {}
    for k, s in specs.items():
        if s.dtype == torch.int32:
            out[k] = torch.randint(0, cfg.vocab_size, tuple(s.shape),
                                   generator=generator, dtype=torch.int32,
                                   device=device)
        else:
            out[k] = (torch.randn(tuple(s.shape), generator=generator,
                                  device=device) * 0.02).to(s.dtype)
    return out


def build_step(cfg: ModelConfig, shape: ShapeConfig, grid, device="meta",
               generator: Optional[torch.Generator] = None) -> Step:
    """Rank 0's step of ``cfg`` (variant and parallelism already applied)
    at ``shape`` on ``grid`` (a ``runtime.Grid``; the dry run's is
    ``op_analysis.stand_in_grid``), with its params drawn from
    ``generator`` on ``device`` (``meta``: shapes only).

    train: the grid's ``make_train_step`` on the rank's blocks and AdamW
    state (int8 moments above 5e10 params), the global batch with a mask;
    prefill: ``api.forward`` of the rank's rows under the training layout;
    decode: the serving engine's rank step, ``sharding.shard_params`` of
    the params (LAQ-quantized, then the rank's codes packed for the W4A8
    kernel, under ``ita.quantize_weights``; else the family's
    ``serve_params``), the
    rank's cache (``api.init_cache(tp=)``), ``api.decode_step`` and the
    argmax."""
    gen = generator if generator is not None else torch.Generator()
    rows = batch_rows(cfg, shape, grid)
    whole = api.init_params(cfg, gen, device=device)
    if shape.kind in ("train", "prefill"):
        layout = api.train_layout(cfg, grid)
        params = layout.shard_tree(whole)
        del whole
        if shape.kind == "prefill":
            batch = inputs(cfg, shape, rows, device, gen)

            @torch.no_grad()
            def run():
                logits, _ = api.forward(params, batch["tokens"], cfg,
                                        frontend=batch.get("frontend"),
                                        layout=layout)
                return logits

            return Step(run, (params, batch), oa.storage_bytes(
                (params, batch)))
        optcfg = opt_mod.AdamWConfig(quantize_moments=cfg.param_count() > 5e10)
        state = opt_mod.init_state(params, optcfg, layout=layout)
        step = step_mod.make_train_step(cfg, optcfg, grid)
        dp = grid.data.size
        batch = inputs(cfg, shape, rows * dp, device, gen)
        batch["mask"] = torch.ones(tuple(batch["tokens"].shape),
                                   dtype=torch.float32, device=device)
        rank_rows = layout.batch_rows(batch)

        def run():
            return step(params, state, batch)

        return Step(run, (params, state, batch),
                    oa.storage_bytes((params, state))
                    + sum(oa.nbytes(v) for v in rank_rows.values()))
    tp = grid.model
    with oa.host_reads():
        if cfg.ita.quantize_weights:
            whole = api.quantize_model(whole, cfg)
            params = api.pack_model(sharding.shard_params(whole, tp))
        else:
            params = api.family_module(cfg).serve_params(
                sharding.shard_params(whole, tp), cfg, device)
        del whole
        if tp.size > 1:
            params["tp"] = tp
        batch = inputs(cfg, shape, rows, device, gen)
        cache = api.init_cache(cfg, rows, shape.seq_len,
                               frontend=batch.get("frontend"), params=params,
                               device=device, tp=tp)
    tokens = batch["tokens"]

    @torch.no_grad()
    def run():
        logits, new_cache = api.decode_step(params, cache, tokens, cfg)
        return torch.argmax(logits, dim=-1), new_cache

    return Step(run, (params, cache, tokens),
                oa.storage_bytes((params, cache, tokens)))


def trace(cfg: ModelConfig, shape: ShapeConfig, grid_dims=GRID
          ) -> Dict[str, Any]:
    """Trace rank 0's step of ``cfg`` (variant and parallelism applied) at
    ``shape`` on a ``grid_dims`` grid of stand-in groups; returns the
    cell's record: the tally's totals, memory, kernel calls, host reads
    and seconds."""
    grid = oa.stand_in_grid(grid_dims)
    t0 = time.time()
    step = build_step(cfg, shape, grid)
    t_build = time.time() - t0
    tally = oa.Tally()
    t0 = time.time()
    tally.hold(*step.args)
    with tally:
        out = step.run()
    t_step = time.time() - t0
    totals = tally.totals()
    return {
        "chips": grid_dims[0] * grid_dims[1],
        "mesh": "x".join(str(s) for s in grid_dims),
        "totals": dataclasses.asdict(totals),
        "memory": {"argument_size_in_bytes": step.argument_bytes,
                   "output_size_in_bytes": oa.storage_bytes(out),
                   "temp_size_in_bytes": tally.peak,
                   "generated_code_size_in_bytes": None,
                   "alias_size_in_bytes": None},
        "kernel_calls": dict(tally.kernel_calls),
        "kernel_flops": tally.kernel_flops,
        "host_reads": dict(tally.host_reads),
        "build_s": round(t_build, 2), "trace_s": round(t_step, 2),
    }


def roofline(totals: Dict[str, Any], chips: int, cfg: ModelConfig,
             shape: ShapeConfig) -> oa.Roofline:
    return oa.Roofline(
        hlo_flops=totals["flops_per_chip"] * chips,
        hlo_bytes=totals["mem_bytes_per_chip"] * chips,
        coll_bytes_per_chip=totals["coll_bytes_per_chip"],
        chips=chips,
        model_flops=model_flops(cfg, shape),
        model_bytes=model_bytes(cfg, shape))


def cell_json(meta: Dict[str, Any], rec: Dict[str, Any], cfg: ModelConfig,
              shape: ShapeConfig) -> Dict[str, Any]:
    """The reference's per-cell JSON from a traced record (``trace``'s, or
    one read back by ``reanalyze.py``)."""
    tot = rec["totals"]
    roof = roofline(tot, rec["chips"], cfg, shape)
    return dict(
        meta, status="ok",
        layout="serve" if shape.kind == "decode" else "train",
        trace_s=rec["trace_s"], build_s=rec["build_s"],
        memory=rec["memory"],
        collectives={"by_kind": tot["coll_by_kind"],
                     "op_counts_weighted": tot["coll_counts"],
                     "total_per_chip": tot["coll_bytes_per_chip"]},
        mem_by_kind_per_chip=tot["mem_by_kind"],
        cost_analysis_raw={"flops": tot["flops_per_chip"],
                           "bytes accessed": tot["mem_bytes_per_chip"]},
        kernel_calls=rec["kernel_calls"],
        host_reads=rec["host_reads"],
        roofline=roof.as_dict(),
    )


def cell_config(arch: str, shape: ShapeConfig, variant: str,
                grid_dims=GRID) -> ModelConfig:
    cfg = apply_variant(get_config(arch), shape, variant)
    return adapt_parallel(cfg, shape, grid_shape(grid_dims))


def tag_of(arch: str, shape_name: str, variant: str) -> str:
    tag = f"{arch}__{shape_name}__pod1"
    return tag if variant == "baseline" else f"{tag}__{variant}"


def lower_cell(arch: str, shape_name: str,
               variant: str = "baseline") -> Dict[str, Any]:
    """The cell's JSON: rank 0's step traced on a (16, 16) grid (module
    docstring).  With ``REPRO_TORCH_RECORD_DIR`` set, the traced record is
    also saved there (gzipped JSON), which ``reanalyze.py`` reads back;
    with ``REPRO_TORCH_SAVE_RECORD`` set, to that file (plain JSON)."""
    shape = SHAPES[shape_name]
    cfg0 = get_config(arch)
    meta: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(s) for s in GRID),
        "chips": GRID[0] * GRID[1], "variant": variant,
    }
    reason = cell_skip_reason(cfg0, shape)
    if reason:
        return dict(meta, status="skipped", reason=reason)
    cfg = cell_config(arch, shape, variant)
    rec = dict(trace(cfg, shape), arch=arch, shape=shape_name,
               variant=variant)
    # the reference's REPRO_DRYRUN_SAVE_HLO and REPRO_HLO_DIR: the traced
    # record instead of the HLO text
    if os.environ.get("REPRO_TORCH_SAVE_RECORD"):
        with open(os.environ["REPRO_TORCH_SAVE_RECORD"], "w") as f:
            json.dump(rec, f, indent=2)
    record_dir = os.environ.get("REPRO_TORCH_RECORD_DIR")
    if record_dir:
        os.makedirs(record_dir, exist_ok=True)
        with gzip.open(os.path.join(record_dir, tag_of(
                arch, shape_name, variant) + ".json.gz"), "wt") as f:
            json.dump(rec, f)
    return cell_json(meta, rec, cfg, shape)


def run_cells(cells, out_dir: str, variant: str = "baseline") -> int:
    os.makedirs(out_dir, exist_ok=True)
    failures = 0
    for arch, shape_name in cells:
        tag = tag_of(arch, shape_name, variant)
        path = os.path.join(out_dir, tag + ".json")
        try:
            res = lower_cell(arch, shape_name, variant)
        except Exception:
            res = {"arch": arch, "shape": shape_name, "status": "error",
                   "variant": variant, "mesh": "x".join(map(str, GRID)),
                   "traceback": traceback.format_exc()}
            failures += 1
        with open(path, "w") as f:
            json.dump(res, f, indent=2, default=str)
        status = res["status"]
        extra = ""
        if status == "ok":
            r = res["roofline"]
            extra = (f" bottleneck={r['bottleneck']}"
                     f" frac={r['roofline_frac']:.3f}"
                     f" trace={res['trace_s']}s")
        elif status == "error":
            extra = " " + res["traceback"].strip().splitlines()[-1]
        print(f"[{status:7s}] {tag}{extra}", flush=True)
    return failures


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=os.path.abspath(RESULTS_DIR))
    ap.add_argument("--variant", default="baseline",
                    choices=("baseline", "opt"), help=OPT_NOTES)
    args = ap.parse_args(argv)
    if args.multi_pod:
        ap.error("--multi-pod: the port's runtime.Grid has two axes (data, "
                 "model); a pod axis is not ported (ROADMAP queue 1)")
    if args.all:
        cells = [(a, s) for a in ASSIGNED for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]
    failures = run_cells(cells, args.out, args.variant)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
