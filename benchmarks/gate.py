"""Perf-regression gate: measure cells on the GPU and compare each median
frame time with a baseline file written by `run_all.py --out`.

Exit code 1 when any measured cell is more than --tol slower than its
baseline, or when the baseline was taken on another kind of device or a
card with another power limit (times from two cards do not compare).

Usage: python benchmarks/gate.py BASELINE.json [--tol 0.10]
       [--only CELL ...] [--frames N]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def compare(baseline: dict, fresh: dict, tol: float):
    """(lines, failed cell names) for fresh vs baseline median times."""
    lines, failed = [], []
    for name, cell in fresh["cells"].items():
        ref = baseline["cells"].get(name)
        if ref is None:
            lines.append(f"{name}: {cell['median_ms']:.3f} ms (no baseline)")
            continue
        ratio = cell["median_ms"] / ref["median_ms"]
        bad = ratio > 1.0 + tol
        lines.append(f"{name}: {ref['median_ms']:.3f} -> "
                     f"{cell['median_ms']:.3f} ms ({ratio - 1.0:+.1%})"
                     + ("  REGRESSION" if bad else ""))
        if bad:
            failed.append(name)
    return lines, failed


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("baseline")
    ap.add_argument("--tol", type=float, default=0.10)
    ap.add_argument("--only", nargs="*", default=None)
    ap.add_argument("--frames", type=int, default=20)
    args = ap.parse_args(argv)

    from raytracing_engine_tpu.utils.devices import (
        card_name_power, device_record, require_gpu)

    require_gpu()
    with open(args.baseline) as f:
        baseline = json.load(f)
    device, card = device_record(), card_name_power()
    if (baseline["device"]["kind"], baseline["card"]) != (device["kind"],
                                                          card):
        raise SystemExit(f"baseline from {baseline['device']['kind']} "
                         f"({baseline['card']}); this is {device['kind']} "
                         f"({card})")
    from raytracing_engine_tpu.utils.compile_cache import enable_compile_cache

    import run_all

    enable_compile_cache()
    names = args.only or list(baseline["cells"])
    fresh = {"cells": run_all.run(names, args.frames)}
    lines, failed = compare(baseline, fresh, args.tol)
    print(f"{device['kind']} ({card})")
    print("\n".join(lines))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
