#!/usr/bin/env python
"""Render a markdown results table from the res/ CSVs (BASELINE.md helper).

Usage: python scripts/results_table.py [--filter SUBSTR] [--dir res]
"""

from __future__ import annotations

import argparse
import glob
import os
import re


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="res")
    ap.add_argument("--filter", default="")
    args = ap.parse_args()

    rows = []
    for path in sorted(glob.glob(os.path.join(args.dir, "*-gpu.csv"))):
        name = os.path.basename(path)
        m = re.match(r"(.+?)-((?:de)?gridder_.*|grid_.*|pipeline_.*|vadd.*)"
                     r"-gpu\.csv", name)
        if not m:
            continue
        bench = m.group(2)
        if args.filter and args.filter not in bench:
            continue
        metrics = dict(
            line.split(",") for line in open(path).read().strip().splitlines()
        )
        rows.append((
            bench,
            metrics.get("ms", ""),
            metrics.get("ms_stddev", ""),
            metrics.get("MVis/s", ""),
            metrics.get("GFLOP/s", ""),
            metrics.get("GB/s", ""),
            metrics.get("roofline_pct", ""),
        ))
    print("| benchmark | ms | ±ms | MVis/s | GFLOP/s | GB/s | roofline % |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        print("| " + " | ".join(str(x) for x in r) + " |")
    return 0


if __name__ == "__main__":
    main()
