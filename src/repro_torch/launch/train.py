"""Training driver: the train loop with checkpoints, restart, preemption
handling and deterministic data, on one device.

The JAX package's ``launch/train.py`` with the same arguments and log
lines, plus ``--device`` (default ``cuda``; a CUDA device without a card
raises).  ``remat`` is forced to ``"none"``, as there.

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
      --smoke --device cpu --steps 50 --batch 8 --seq 128 \\
      --ckpt-dir /tmp/ckpt

Prints the log lines and, last, ``{"first_loss", "last_loss", "steps"}``
as JSON (returned by :func:`main` too).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import DataConfig, DataLoader
from repro_torch.models import api
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import step as step_mod


def build(cfg, optcfg, device, seed: int):
    """Seeded float32 params on ``device``, their AdamW state, the step."""
    params = api.init_params(cfg, torch.Generator(device).manual_seed(seed),
                             device=device)
    opt_state = opt_mod.init_state(params, optcfg)
    return params, opt_state, step_mod.make_train_step(cfg, optcfg)


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU scale)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(
        cfg, parallel=dataclasses.replace(cfg.parallel, remat="none"))
    optcfg = opt_mod.AdamWConfig(lr=args.lr, warmup_steps=10,
                                 total_steps=args.steps)
    params, opt_state, train_step = build(cfg, optcfg, device, args.seed)

    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch, seed=args.seed,
                      frontend_tokens=cfg.frontend_tokens, d_model=cfg.d_model)
    loader = DataLoader(dcfg)

    mgr: Optional[CheckpointManager] = None
    start_step = 0
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=2, async_save=True)
        if args.resume and mgr.latest_step() is not None:
            state_like = {"params": params, "opt": opt_state}
            restored, meta = mgr.restore(state_like)
            params, opt_state = restored["params"], restored["opt"]
            start_step = int(meta["step"]) + 1
            loader.load_state_dict({"step": start_step})
            print(f"resumed from step {meta['step']}")
        mgr.save_on_signal(lambda: (int(loader.step),
                                    {"params": params, "opt": opt_state}))

    losses = []
    step_times = []
    for i in range(start_step, args.steps):
        batch = next(loader)
        batch["mask"] = np.ones_like(batch["labels"], np.float32)
        t0 = time.time()
        params, opt_state, metrics = train_step(params, opt_state, batch)
        loss = float(metrics["loss"])
        step_times.append(time.time() - t0)  # straggler watch (see below)
        losses.append(loss)
        if i % args.log_every == 0 or i == args.steps - 1:
            # straggler signal: steps over 2x the median
            med = float(np.median(step_times)) if step_times else 0.0
            slow = sum(1 for t in step_times if t > 2 * med)
            print(f"step {i:5d} loss {loss:.4f} lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"med_step {med*1e3:.0f}ms stragglers {slow}")
        if mgr and (i + 1) % args.ckpt_every == 0:
            mgr.save(i, {"params": params, "opt": opt_state},
                     metadata={"step": i, "loss": loss,
                               "device": str(device)})
    if mgr:
        mgr.wait()
    result = {"first_loss": losses[0] if losses else None,
              "last_loss": losses[-1] if losses else None,
              "steps": len(losses)}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
