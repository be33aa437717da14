"""A copy of the benchmark at a size the CPU tests can hold: the same
files, with every cell's picture QCIF, a few streams and frames, and each
rate-controlled configuration's bit rate scaled by QCIF's share of its
picture (a CIF configuration's to a quarter), so that its buffer law
binds as hard at that size, bits per macroblock alike."""

from __future__ import annotations

import json
import os
import shutil

from port_bench import harness
from port_bench.reference.constants import FORMATS, QCIF

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
        picture = FORMATS[config["format"]]
        config["format"] = "QCIF"
        if config["rate"].get("bit_rate"):
            config["rate"]["bit_rate"] = (config["rate"]["bit_rate"]
                                          * QCIF.num_mbs // picture.num_mbs)
        with open(path, "w") as f:
            json.dump(config, f)
    return harness.Manifest(root)
