"""A copy of the benchmark at a size the CPU tests can hold: the same
files, with every cell's picture QCIF, a few streams and frames, and the
rate-controlled configuration at 64 kbit/s so that its buffer law binds at
that size."""

from __future__ import annotations

import json
import os
import shutil

from port_bench import harness

SMALL_TRAFFIC = dict(streams=3, frames=3, chunk=2, trace_jobs=1, span_jobs=1)


def small_checkout(root: str) -> harness.Manifest:
    shutil.copytree(harness.BENCH, os.path.join(root, "port_bench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root)
    m = harness.Manifest(root)
    for cell in m.cells:
        path = os.path.join(root, "port_bench", "traffic",
                            m.cells[cell]["traffic"] + ".json")
        with open(path) as f:
            traffic = json.load(f)
        traffic.update({k: v for k, v in SMALL_TRAFFIC.items()
                        if k in traffic})
        with open(path, "w") as f:
            json.dump(traffic, f)
        path = os.path.join(root, m.configs[m.cells[cell]["config"]]["file"])
        with open(path) as f:
            config = json.load(f)
        config["format"] = "QCIF"
        if config["rate"].get("bit_rate"):
            config["rate"]["bit_rate"] = 64000
        with open(path, "w") as f:
            json.dump(config, f)
    return harness.Manifest(root)
