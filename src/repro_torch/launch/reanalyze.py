"""Recompute the dry run's roofline JSONs from its saved per-cell records
(no new trace): the JAX package's ``launch/reanalyze.py``, which re-reads
its saved ``.hlo.gz`` files.

Keeps every published number on ONE analyzer version: after a change to
the roofline or the model floors, re-run this over the records that
``python -m repro_torch.launch.dryrun`` saved under
``REPRO_TORCH_RECORD_DIR`` to refresh ``experiments/dryrun_torch/``.  A
record holds the tally's totals, memory, kernel calls and the grid's chip
count, which is read from it.
"""
from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import re

from repro_torch.configs import SHAPES
from repro_torch.launch import dryrun


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--record-dir", default="experiments/dryrun_torch_records")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    for path in sorted(glob.glob(os.path.join(args.record_dir,
                                              "*.json.gz"))):
        name = os.path.basename(path)[:-len(".json.gz")]
        m = re.match(r"(.+)__(\w+)__pod(\d)(?:__(\w+))?$", name)
        arch, shape_name = m.group(1), m.group(2)
        variant = m.group(4) or "baseline"
        with gzip.open(path, "rt") as f:
            rec = json.load(f)
        shape = SHAPES[shape_name]
        cfg = dryrun.cell_config(arch, shape, variant,
                                 tuple(int(n) for n in rec["mesh"].split("x")))
        meta = {"arch": arch, "shape": shape_name, "mesh": rec["mesh"],
                "chips": rec["chips"], "variant": variant}
        out_path = os.path.join(args.out, name + ".json")
        base = {}
        if os.path.exists(out_path):
            with open(out_path) as f:
                base = json.load(f)
        base.update(dryrun.cell_json(meta, rec, cfg, shape))
        with open(out_path, "w") as f:
            json.dump(base, f, indent=2, default=str)
        r = base["roofline"]
        print(f"{name}: bn={r['bottleneck']} frac={r['roofline_frac']:.4f}")


if __name__ == "__main__":
    main()
