"""Serve a small model with batched requests through the Split-Brain engine
on the PyTorch port, comparing float vs LAQ-quantized "device" weights, and
print the per-request interface accounting — the runnable version of the
paper's deployment story.

The port's sibling of ``examples/serve_splitbrain.py``: the same config,
prompts, steps and lines.  The JAX example's ``jit=True`` engine (one
compiled dispatch per ``generate()``) is the port's ``fused=True`` loop and
its ``jit=False`` eager loop is ``fused=False``; on the card every LAQ
projection is a W4A8 kernel launch.  :func:`run` serves any config and
weights and returns every number it prints; :func:`main` builds the
example's reduced llama2-7b with seeded weights and prints.

Run:  PYTHONPATH=src python examples/serve_splitbrain_torch.py [--device cpu]

(the default device is the card; without one it raises unless
``--device cpu`` is given)
"""
import argparse
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import api
from repro_torch.serve.splitbrain_engine import (SplitBrainEngine,
                                                 traffic_model_for)
from repro_torch.train.optimizer import map_params


def run(cfg, params, prompts, *, device, max_new: int = 12
        ) -> Dict[str, Any]:
    """The example's runs on ``device`` for ``cfg``, its float ``params``
    (any device: they are moved) and ``prompts`` (B, T0) int32.  Returns
    the printed numbers, each run's tokens, and ``launches``: each part's
    kernel launches (``ops.launch_counts`` read before and after it)."""
    dev = resolve_device(device)
    params = map_params(lambda t: t.to(dev), params)
    prompts = np.asarray(prompts, np.int32)
    B = prompts.shape[0]
    launches = {}

    def counted(name, fn):
        before = ops.launch_counts()
        out = fn()
        after = ops.launch_counts()
        launches[name] = {k: after[k] - before[k] for k in after}
        return out

    # float device weights, fused generation (the JAX example's jit=True)
    eng_f = SplitBrainEngine(cfg, params, max_len=64, quantize=False,
                             device=dev)
    counted("float_warmup", lambda: eng_f.generate(prompts, max_new=max_new))
    res_f = counted("float_fused",
                    lambda: eng_f.generate(prompts, max_new=max_new))
    del eng_f
    # the eager per-layer reference loop (the protocol, spelled out)
    eng_e = SplitBrainEngine(cfg, params, max_len=64, quantize=False,
                             fused=False, device=dev)
    res_e = counted("float_stepwise",
                    lambda: eng_e.generate(prompts, max_new=max_new))
    del eng_e
    # LAQ INT4 "hardwired" device weights
    eng_q = SplitBrainEngine(cfg, params, max_len=64, quantize=True,
                             device=dev)
    res_q = counted("w4a8", lambda: eng_q.generate(prompts, max_new=max_new))
    out_f, out_e, out_q = res_f["tokens"], res_e["tokens"], res_q["tokens"]

    eng_q.meter.reset()
    counted("w4a8_decode_token",
            lambda: eng_q.decode_token(eng_q.init_cache(B), prompts[:, 0]))
    meas = eng_q.measured_bytes_per_token(batch=B)
    del eng_q
    tm = traffic_model_for(cfg)
    full_tm = traffic_model_for(get_config("llama2-7b"))
    return {"batch": B, "max_new": max_new,
            "float_fused": {"seconds": res_f["decode_s"],
                            "tokens_per_s": res_f["tokens_per_s"]},
            "float_stepwise": {"seconds": res_e["decode_s"],
                               "tokens_per_s": res_e["tokens_per_s"]},
            "fused_speedup": res_f["tokens_per_s"] / res_e["tokens_per_s"],
            "w4a8": {"seconds": res_q["decode_s"],
                     "tokens_per_s": res_q["tokens_per_s"]},
            "tokens": {"float_fused": out_f, "float_stepwise": out_e,
                       "w4a8": out_q},
            "fused_stepwise_agreement": float((out_f == out_e).mean()),
            "float_w4a8_agreement": float((out_f == out_q).mean()),
            "measured_bytes_per_token": meas["total"],
            "model_bytes_per_token": tm.bytes_per_token(),
            "interface_table": full_tm.interface_table(),
            "launches": launches}


def print_run(r: Dict[str, Any]) -> None:
    """The JAX example's lines, from :func:`run`'s result."""
    n = f"{r['batch']} requests x {r['max_new']} tokens"
    print("== float device weights (fused one-dispatch generation) ==")
    print(f"{n} in {r['float_fused']['seconds']:.3f}s "
          f"({r['float_fused']['tokens_per_s']:.0f} tok/s)")
    print("== eager per-layer reference loop (the protocol, spelled out) ==")
    print(f"{n} in {r['float_stepwise']['seconds']:.2f}s "
          f"({r['float_stepwise']['tokens_per_s']:.0f} tok/s) -> fused "
          f"speedup {r['fused_speedup']:.0f}x")
    print("== LAQ INT4 'hardwired' device weights ==")
    print(f"token agreement float vs W4A8: {r['float_w4a8_agreement']:.1%}")
    print(f"\nper-token interface bytes (per request): measured "
          f"{r['measured_bytes_per_token']} vs analytical "
          f"{r['model_bytes_per_token']}")
    print("full-size llama2-7b deployment table (Table III):")
    for row in r["interface_table"]:
        print(f"  {row['interface']:15s} {row['total_ms']:.1f} ms "
              f"-> {row['tokens_per_s']:.0f} tok/s "
              f"(+${row['extra_cost_usd']:.0f})")


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions")
    args = ap.parse_args(argv)
    cfg = get_config("llama2-7b").reduced(vocab_size=512)
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab_size, (4, 5)).astype(np.int32)
    r = run(cfg, params, prompts, device=args.device)
    print_run(r)
    return r


if __name__ == "__main__":
    main()
