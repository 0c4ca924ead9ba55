#!/usr/bin/env python3
"""``bench_torch.py`` of two checkouts on one card, in turns.

    git archive HEAD~1 | tar -x -C build/parent
    python3 tools/bench_ab.py --parent build/parent [--change .] [--rounds 2]

Each round runs parent, change, change, parent, each side in its own
process from its own directory (its kernels built there), in the serving
mode and in bf16 (``--set model.conv_int8=false``).  Prints the card's
nvidia-smi line, one JSON line per run, and one with each side's runs,
medians and spread (the distance between the largest and smallest run)
per mode, and whether the change's median lies within the parent's runs.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

MODES = {"serving": [], "bf16": ["--set", "model.conv_int8=false"]}


def bench(tree: str, argv: list[str]) -> dict:
    out = subprocess.run([sys.executable, "bench_torch.py", *argv],
                         cwd=tree, capture_output=True, text=True,
                         check=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", required=True)
    p.add_argument("--change", default=".")
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    trees = {"parent": os.path.abspath(args.parent),
             "change": os.path.abspath(args.change)}
    ms = {m: {"parent": [], "change": []} for m in MODES}
    for _ in range(args.rounds):
        for side in ("parent", "change", "change", "parent"):
            for mode, argv in MODES.items():
                rec = bench(trees[side], argv)
                value = rec["detail"]["median_ms"]
                ms[mode][side].append(value)
                print(json.dumps({"side": side, "mode": mode,
                                  "median_ms": value,
                                  "spread_ms": rec["detail"]["spread_ms"]}),
                      flush=True)
    summary = {}
    for mode, sides in ms.items():
        parent, change = sides["parent"], sides["change"]
        summary[mode] = {
            "parent_ms": parent, "change_ms": change,
            "parent_median": statistics.median(parent),
            "change_median": statistics.median(change),
            "parent_spread": max(parent) - min(parent),
            "within_parent_runs": (min(parent) <= statistics.median(change)
                                   <= max(parent))}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
