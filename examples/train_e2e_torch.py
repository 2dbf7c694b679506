"""End-to-end training on the PyTorch port: train a reduced-config model for
a few hundred steps on the deterministic synthetic stream, with
checkpointing and a kill-resume demonstration (fault tolerance).

The port's sibling of ``examples/train_e2e.py``: the same two phases through
the port's training CLI (``repro_torch.launch.train``) with the same flags,
plus ``--device``.  :func:`run` does the two phases and returns their
results; :func:`main` adds the example's check that the loss dropped.

Run:  PYTHONPATH=src python examples/train_e2e_torch.py [--arch granite-8b] \\
          [--steps 300] [--device cpu]

Loss must drop substantially from its initial value (the stream has Zipf +
copy-run structure), proving the whole substrate — data, model, optimizer,
checkpoints — learns end to end.
"""
import argparse
import shutil
import tempfile
from typing import Any, Dict

from repro_torch.core.device import resolve_device
from repro_torch.launch import train as train_mod


def run(arch: str, steps: int, *, device, ckpt_dir: str) -> Dict[str, Any]:
    """Train ``steps // 2`` steps with checkpoints in ``ckpt_dir``, then
    "restart after preemption": resume from the newest checkpoint and train
    to ``steps``.  Returns both phases' results and the loss drop across
    the restart."""
    dev = resolve_device(device)

    def phase(n, *extra):
        return train_mod.main([
            "--arch", arch, "--smoke", "--steps", str(n),
            "--batch", "16", "--seq", "128", "--ckpt-dir", ckpt_dir,
            "--ckpt-every", "20", "--lr", "3e-3", "--device", str(dev),
            *extra])

    half = steps // 2
    print(f"=== phase 1: steps 0..{half} ===")
    r1 = phase(half)
    print(f"=== phase 2: resume -> step {steps} ===")
    r2 = phase(steps, "--resume")
    return {"phase1": r1, "phase2": r2, "first_loss": r1["first_loss"],
            "last_loss": r2["last_loss"],
            "drop": r1["first_loss"] - r2["last_loss"]}


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions")
    args = ap.parse_args(argv)

    ckpt_dir = tempfile.mkdtemp(prefix="ita_e2e_")
    try:
        r = run(args.arch, args.steps, device=args.device, ckpt_dir=ckpt_dir)
        print(f"\nloss {r['first_loss']:.3f} -> {r['last_loss']:.3f} "
              f"(drop {r['drop']:.3f}) across a checkpoint/restart boundary")
        assert r["drop"] > 0.5, "training did not learn"
        print("OK: end-to-end training + fault-tolerant restart works")
        return r
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
