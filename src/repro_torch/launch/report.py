"""Render the roofline table from the dry run's JSONs: the JAX package's
``launch/report.py``, over ``experiments/dryrun_torch/``."""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List


def load(results_dir: str) -> List[Dict]:
    rows = []
    for path in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(path) as f:
            rows.append(json.load(f))
    return rows


def fmt_row(r: Dict) -> str:
    tag = f"{r['arch']} x {r['shape']} [{r['mesh']}]"
    if r["status"] == "skipped":
        return f"| {tag} | — | — | — | — | — | skipped: {r['reason'][:40]}… |"
    if r["status"] != "ok":
        return f"| {tag} | ERROR | | | | | |"
    ro = r["roofline"]
    t = [ro["t_compute_s"], ro["t_memory_s"], ro["t_collective_s"]]
    return ("| {tag} | {tc:.4g} | {tm:.4g} | {tcoll:.4g} | {bn} | "
            "{useful:.2f} | {frac:.3f} |".format(
                tag=tag, tc=t[0], tm=t[1], tcoll=t[2], bn=ro["bottleneck"],
                useful=ro["useful_flops_frac"], frac=ro["roofline_frac"]))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default=None, help="filter: 16x16")
    args = ap.parse_args(argv)
    rows = load(args.dir)
    if args.mesh:
        rows = [r for r in rows if r.get("mesh") == args.mesh]
    rows.sort(key=lambda r: (r["arch"], r["shape"], r.get("mesh", "")))
    print("| arch x shape [mesh] | t_comp (s) | t_mem (s) | t_coll (s) | "
          "bottleneck | MODEL/HLO flops | roofline frac |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        print(fmt_row(r))


if __name__ == "__main__":
    main()
