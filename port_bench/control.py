"""The lower-precision control of a cell: a whole run of the harness with
the entry's timed job replaced, after the port's sound set-up and warm-up,
by the plain reference with its DCT and IDCT one step below float64
(`entries.Entry.reference_job`).  The run's own comparison with the
reference in float64 decides `correct`, which a sound control makes false.

    python3 port_bench/control.py --workload <cell> --seeds 1,2,3
                                  [--precision float32,tf32]

runs at the cell's own sizes on the card, one job in the window, and
prints one JSON line per (seed, precision) with `correct` and the numbers
compared.  `tests/test_bench_control.py` runs it on the CPU at a small size
and at the cells' sizes on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

import torch

if __package__ in (None, ""):
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))

from port_bench import harness  # noqa: E402
from port_bench.entries import ENTRIES  # noqa: E402


def run_control(cell: str, seed: int, precision: str, device: torch.device,
                manifest: Optional[harness.Manifest] = None) -> dict:
    """harness.run of `cell` whose window runs one job of the reference at
    `precision` in the port's place; returns the result line's object."""
    manifest = manifest or harness.Manifest()
    cls = ENTRIES[manifest.traffic(cell)["entry"]]
    setup = cls.setup

    def setup_then_swap(self):
        setup(self)
        self.job = lambda: self.reference_job(precision)
    cls.setup = setup_then_swap
    try:
        return harness.run(cell, seed, 0.0, False, device,
                           time.perf_counter(), manifest)
    finally:
        cls.setup = setup


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="port_bench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--precision", default="float32,tf32")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        for p in args.precision.split(","):
            t0 = time.perf_counter()
            r = run_control(args.workload, seed, p, torch.device("cuda", 0))
            print(json.dumps(dict(
                workload=args.workload, seed=seed, precision=p,
                correct=r["correct"], checks=r["checks"],
                seconds=time.perf_counter() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
