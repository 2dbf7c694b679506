"""Training driver: the train loop with checkpoints, restart, preemption
handling and deterministic data, on one device or on a ``(data, model)``
grid of ranks.

The JAX package's ``launch/train.py`` with the same arguments and log
lines, plus ``--device`` (default ``cuda``; a CUDA device without a card
raises) and ``--dp`` / ``--tp`` (default 1, 1): the shape of the grid,
``make_test_mesh``'s ``shape`` (the reference trains on its test mesh of
every visible device; the port's ranks are processes, so the shape is
named).  A grid spawns its ``dp x tp`` ranks (``launch/mesh.py``,
``distributed/runtime.py``); each builds the seeded params, keeps its
blocks and runs the grid's train step (``train/step.py``) on the global
batches, and rank 0 prints the log lines and writes the checkpoints
(layout-free: a run resumes at any grid shape).  ``remat`` is forced to
``"none"``, as there.

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
      --smoke --device cpu --steps 50 --batch 8 --seq 128 \\
      --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \\
      --smoke --device cpu --dp 2 --tp 2 --steps 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-7b \\
      --smoke --device cpu --tp 2 --steps 4

Every config of the registry trains at any ``--dp`` / ``--tp``; a VLM's
or seamless's batches carry their frontend (``DataConfig(
frontend_tokens=)``).

Prints the log lines and, last, ``{"first_loss", "last_loss", "steps"}``
as JSON (returned by :func:`main` too).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import DataConfig, DataLoader
from repro_torch.distributed import runtime
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import api
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import step as step_mod


def build(cfg, optcfg, device, seed: int, grid=None):
    """Seeded float32 params on ``device``, their AdamW state, the step;
    on a ``grid`` the rank's blocks of the same params, its state and the
    grid's step."""
    step = step_mod.make_train_step(cfg, optcfg, grid)
    params = api.init_params(cfg, torch.Generator(device).manual_seed(seed),
                             device=device)
    if grid is None:
        return params, opt_mod.init_state(params, optcfg), step
    with torch.no_grad():
        params = step.layout.shard_tree(params)
    return (params, opt_mod.init_state(params, optcfg, layout=step.layout),
            step)


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
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel ranks (batch rows, FSDP)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks (Megatron cuts)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.dp * args.tp > 1:
        mesh = make_test_mesh(shape=(args.dp, args.tp), device=device)
        results = runtime.spawn(run, mesh.shape, (args,),
                                backend=mesh.backend, devices=mesh.devices)
        result = results[0]
        print(json.dumps(result))
        return result
    result = run(None, args)
    print(json.dumps(result))
    return result


def run(grid, args) -> Dict[str, Any]:
    """The train loop on one device (``grid`` None) or as a grid's rank:
    returns the result; rank 0 (or the one device) prints the log lines."""
    device = (resolve_device(args.device) if grid is None
              else grid.device)
    lead = grid is None or grid.rank == 0
    if grid is not None and device.type == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // grid.world.size))
    mesh_shape = [1, 1] if grid is None else list(grid.shape)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(
        cfg, parallel=dataclasses.replace(cfg.parallel, remat="none"))
    optcfg = opt_mod.AdamWConfig(lr=args.lr, warmup_steps=10,
                                 total_steps=args.steps)
    params, opt_state, train_step = build(cfg, optcfg, device, args.seed,
                                          grid)
    layout = getattr(train_step, "layout", None)
    cuts = None if layout is None else layout.state_cuts(opt_state)

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
            restored, meta = mgr.restore(state_like, layout=layout,
                                         cuts=cuts)
            params, opt_state = restored["params"], restored["opt"]
            start_step = int(meta["step"]) + 1
            loader.load_state_dict({"step": start_step})
            if lead:
                print(f"resumed from step {meta['step']}", flush=True)
        if grid is None:
            # a grid's save is a collective: a preemption signal would have
            # to reach every rank at once, which nothing arranges here
            mgr.save_on_signal(lambda: (int(loader.step),
                                        {"params": params,
                                         "opt": opt_state}))

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
        if lead and (i % args.log_every == 0 or i == args.steps - 1):
            # straggler signal: steps over 2x the median
            med = float(np.median(step_times)) if step_times else 0.0
            slow = sum(1 for t in step_times if t > 2 * med)
            print(f"step {i:5d} loss {loss:.4f} lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"med_step {med*1e3:.0f}ms stragglers {slow}", flush=True)
        if mgr and (i + 1) % args.ckpt_every == 0:
            mgr.save(i, {"params": params, "opt": opt_state},
                     metadata={"step": i, "loss": loss,
                               "device": str(device), "mesh": mesh_shape},
                     layout=layout, cuts=cuts)
    if mgr:
        mgr.wait()
    return {"first_loss": losses[0] if losses else None,
            "last_loss": losses[-1] if losses else None,
            "steps": len(losses)}


if __name__ == "__main__":
    main()
