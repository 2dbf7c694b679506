"""Quickstart on the PyTorch port: the ITA pipeline end to end.

1. take a (small) LM, 2. run LAQ "synthesis" (CSD-aware INT4 + pruning),
3. decode with the Split-Brain engine (every device projection a W4A8
kernel launch on the card), 4. print the hardware report the paper would
print for the full-size model: gates/MAC, energy/MAC, die area, cost,
interface traffic.

The port's sibling of ``examples/quickstart.py``: the same config, steps
and lines.  :func:`run` does the four steps for any config and weights and
returns every number it prints; :func:`main` builds the example's reduced
tinyllama-1.1b with seeded weights and prints.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

(the default device is the card; without one it raises unless
``--device cpu`` is given)
"""
import argparse
from typing import Any, Dict

import torch

from repro_torch.configs import get_config
from repro_torch.core import costmodel
from repro_torch.core.device import resolve_device
from repro_torch.models import api
from repro_torch.serve.splitbrain_engine import (SplitBrainEngine,
                                                 traffic_model_for)
from repro_torch.train.optimizer import map_params


def run(cfg, params, *, device, n_tokens: int = 8,
        report_arch: str = "tinyllama-1.1b") -> Dict[str, Any]:
    """The quickstart's four steps on ``device`` for ``cfg`` and its float
    ``params`` (any device: they are moved).  Returns the printed numbers,
    and besides them ``codes`` (the LAQ codes of every layer's ``wq``,
    flattened, on ``device``) and ``logits`` (each decode step's logits,
    (n_tokens, V) float32 on the CPU)."""
    dev = resolve_device(device)
    params = map_params(lambda t: t.to(dev), params)

    # -- 2. LAQ synthesis: weights -> immutable INT4 shift-add codes ---------
    qparams = api.quantize_model(params, cfg)
    codes = qparams["blocks"]["attn"]["wq"].codes.reshape(-1)
    del qparams
    # the example's share, counted exactly (float64, as numpy's mean)
    pruned = int((codes == 0).sum()) / codes.numel()

    # -- 3. split-brain decoding ---------------------------------------------
    eng = SplitBrainEngine(cfg, params, max_len=32, device=dev)
    cache = eng.init_cache(batch=1)
    tok = torch.tensor([1], dtype=torch.int32, device=dev)
    generated, logits = [], []
    for _ in range(n_tokens):
        tok, step_logits, cache = eng.decode_token(cache, tok)
        generated.append(int(tok[0]))
        logits.append(step_logits[0].float().cpu())
    meas = eng.measured_bytes_per_token(batch=1)
    tm = traffic_model_for(cfg)
    del eng, cache

    # -- 4. the hardware report for the FULL-SIZE model ----------------------
    full = get_config(report_arch)
    n = full.param_count()
    tm_full = traffic_model_for(full)
    report = {"arch": full.name, "params": n,
              "gates": costmodel.gate_reduction(codes),
              "energy": costmodel.energy_comparison(codes),
              "area": costmodel.die_area_mm2(n),
              "cost": costmodel.unit_cost(n),
              "bytes_per_token": tm_full.bytes_per_token(),
              "bandwidth_bytes_per_s_at_20": tm_full.bandwidth_bytes_per_s(20),
              "interface_table": tm_full.interface_table()}
    return {"model": {"name": cfg.name, "layers": cfg.num_layers,
                      "d_model": cfg.d_model},
            "pruned": pruned, "tokens": generated,
            "measured_bytes_per_token": meas["total"] // n_tokens,
            "model_bytes_per_token": tm.bytes_per_token(),
            "report": report, "codes": codes,
            "logits": torch.stack(logits)}


def print_run(r: Dict[str, Any]) -> None:
    """The JAX example's lines, from :func:`run`'s result."""
    m = r["model"]
    print(f"model: {m['name']} ({m['layers']}L d={m['d_model']})")
    print(f"LAQ: {r['pruned']:.1%} of wq weights pruned to zero "
          "(paper: 15-25%)")
    print(f"generated tokens: {r['tokens']}")
    print(f"interface traffic: measured {r['measured_bytes_per_token']} "
          f"B/token (analytical {r['model_bytes_per_token']} B/token)")
    rep = r["report"]
    gates, energy = rep["gates"], rep["energy"]
    print(f"\n=== ITA hardware report: {rep['arch']} "
          f"({rep['params']/1e9:.2f}B params) ===")
    print(f"gates/MAC:        {gates['ita_gates']:.0f} vs 1180 generic "
          f"({gates['reduction_x']:.2f}x)")
    print(f"energy/MAC:       {energy['ita']['total_pj']:.2f} pJ vs "
          f"{energy['gpu_int8']['total_pj']:.0f} pJ INT8-GPU "
          f"({energy['improvement_vs_int8']['x']:.1f}x)")
    print(f"die area:         {rep['area']['final_mm2']:.0f} mm^2 "
          f"({rep['cost']['config']})")
    print(f"unit cost:        ${rep['cost']['unit_cost']:.0f} at 10K volume")
    print(f"interface:        {rep['bytes_per_token']/1024:.0f} KiB/token, "
          f"{rep['bandwidth_bytes_per_s_at_20']/1e6:.1f} MB/s @ 20 tok/s")
    for row in rep["interface_table"]:
        print(f"  {row['interface']:15s} {row['total_ms']:.1f} ms/token "
              f"-> {row['tokens_per_s']:.0f} tok/s")


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions")
    args = ap.parse_args(argv)
    # -- 1. a TinyLlama-family model at CPU-demo scale -----------------------
    cfg = get_config("tinyllama-1.1b").reduced(vocab_size=512)
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    r = run(cfg, params, device=args.device)
    print_run(r)
    return r


if __name__ == "__main__":
    main()
