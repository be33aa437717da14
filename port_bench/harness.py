"""The benchmark harness: one cell of `BENCHMARK.json`, one JSON line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
                              --trace <0|1>
    python3 port_bench/run.py --list

Everything is found by name.  A cell of `BENCHMARK.json` names its
configuration (`port_bench/configs/<config>.json`, read through the
manifest's `file`) and its traffic mix (`port_bench/traffic/<mix>.json`);
the mix names the port entry it drives (`entries.ENTRIES`), its sizes and
its end-to-end rate metric.  A per-layer metric is the reader
`port_bench/metrics/<metric>.py`, whose `read(reading)` returns a number
or None.  Adding a cell, a configuration, a mix or a metric adds files and
manifest entries; nothing here changes.

A run: set-up (imports, the library, the seeded content, one whole
warm-up job; `setup_s` counts it from process start), then whole jobs back
to back for `--seconds` (the job in progress at the end is finished and
counted), or with `--trace 1` `trace_jobs` whole jobs under
torch.profiler instead, then the host spans; then the peak memory is read,
and the kept outputs are compared with the plain reference.  The last line
on stdout is the result; the numbers compared end stderr.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "port_bench")
#: top-level modules that must not be loaded once the window has closed
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "p64tpu")
#: attempts at a whole trace
TRACE_ATTEMPTS = 3
#: cache directories of the program and of torch, fixed, in the checkout
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions",
              "TRITON_CACHE_DIR": "build/triton",
              "CUDA_CACHE_PATH": "build/cuda_cache"}
#: the benchmark's own inputs kept between runs, fixed, in the checkout
INPUT_CACHE = "build/port_bench"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Manifest:
    """`BENCHMARK.json` of a checkout, and the files it names."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.data = load_json(os.path.join(root, "BENCHMARK.json"))
        self.cells = {w["name"]: w for w in self.data["workloads"]}
        self.configs = {c["name"]: c for c in self.data["configs"]}

    def config(self, cell: str) -> dict:
        c = self.configs[self.cells[cell]["config"]]
        return load_json(os.path.join(self.root, c["file"]))

    def traffic(self, cell: str) -> dict:
        return load_json(os.path.join(
            self.root, "port_bench", "traffic",
            self.cells[cell]["traffic"] + ".json"))

    @staticmethod
    def _in(metric: dict, cell: str) -> bool:
        return "workloads" not in metric or cell in metric["workloads"]

    def end_to_end(self, cell: str) -> List[dict]:
        return [m for m in self.data["end_to_end"] if self._in(m, cell)]

    def per_layer(self, cell: str) -> List[dict]:
        reported = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if m["moves"] in reported and self._in(m, cell)]

    def reader(self, metric: str) -> Callable:
        path = os.path.join(self.root, "port_bench", "metrics",
                            metric + ".py")
        spec = importlib.util.spec_from_file_location(
            "port_bench_metric_" + metric.replace(".", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read

    def listing(self) -> List[dict]:
        out = []
        for cell in self.cells:
            traffic = self.traffic(cell)
            self.config(cell)
            out.append(dict(
                cell=cell, entry=traffic["entry"],
                end_to_end=[m["name"] for m in self.end_to_end(cell)],
                per_layer=[m["name"] for m in self.per_layer(cell)]))
            for m in self.per_layer(cell):
                self.reader(m["name"])
        return out


class Reading:
    """What a per-layer metric's reader gets: the traced window's `trace`
    (tracing.Trace), the host `spans` (name -> seconds per job), the
    entry's `shapes` and the `card` (sms, clock_hz, name, power_limit)."""

    def __init__(self, trace, spans, shapes, card):
        self.trace, self.spans = trace, spans
        self.shapes, self.card = shapes, card


def card_info(device) -> dict:
    """The card's name, power limit, highest SM clock and SM count."""
    import torch
    info = dict(name=torch.cuda.get_device_name(device),
                sms=torch.cuda.get_device_properties(device)
                .multi_processor_count, power_limit=None, clock_hz=None)
    try:
        r = subprocess.run(
            ["nvidia-smi", f"--id={device.index or 0}",
             "--query-gpu=power.limit,clocks.max.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True)
        limit, clock = r.stdout.strip().splitlines()[0].split(",")
        info.update(power_limit=float(limit), clock_hz=float(clock) * 1e6)
    except (OSError, subprocess.SubprocessError, ValueError) as e:
        log(f"nvidia-smi unread: {e!r}")
    return info


def forbidden_loaded() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN_MODULES))


def traced_jobs(entry, n_jobs: int):
    """Run n_jobs whole jobs under torch.profiler until a trace is whole
    (at most TRACE_ATTEMPTS); returns (results, tracing.Trace, seconds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import tracing
    acts = [ProfilerActivity.CPU]
    if entry.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    for attempt in range(TRACE_ATTEMPTS):
        results = []
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            with record_function(tracing.WINDOW):
                for _ in range(n_jobs):
                    results.append(entry.job())
                if entry.device.type == "cuda":
                    torch.cuda.synchronize(entry.device)
        seconds = time.perf_counter() - t0
        trace = tracing.read_trace(tracing.events_from_profiler(prof),
                                   n_jobs * entry.replays_per_job(), n_jobs)
        if trace.whole or entry.device.type != "cuda":
            break
        counts = sorted({r.kernels for r in trace.replays})
        log(f"trace {attempt} not whole: {len(trace.replays)} replays of "
            f"{n_jobs * entry.replays_per_job()}, kernel counts "
            f"{counts[:8]}; taken again")
    return results, trace, seconds


def run(cell: str, seed: int, seconds: float, trace: bool, device,
        t_start: float, manifest: Optional[Manifest] = None) -> dict:
    """Run one cell on `device` and return the result line's object."""
    import torch

    from .entries import ENTRIES
    log(f"imports {time.perf_counter() - t_start:.3f} s")
    manifest = manifest or Manifest()
    config, traffic = manifest.config(cell), manifest.traffic(cell)
    entry = ENTRIES[traffic["entry"]](config, traffic, seed, device, log,
                                      os.path.join(manifest.root,
                                                   INPUT_CACHE))
    card = card_info(device) if device.type == "cuda" else {}
    if card:
        log(f"card {card['name']}, power limit {card['power_limit']} W, "
            f"max SM clock {card['clock_hz']} Hz, {card['sms']} SMs | torch "
            f"{torch.__version__} cuda {torch.version.cuda}")
    window = (f"traced {traffic['trace_jobs']} jobs" if trace
              else f"{seconds} s")
    log(f"cell {cell}: entry {traffic['entry']}, seed {seed}, {window}")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    entry.setup()
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    log(f"set-up {setup_s:.3f} s")

    attempted = failed = mbs = jobs = 0
    metrics: Dict[str, dict] = {}
    extra: Dict[str, object] = {}
    if trace:
        spans = entry.spans()
        results, tr, window_s = traced_jobs(entry, traffic["trace_jobs"])
        for r in results:
            entry.keep(r)
            a, f, _ = entry.tally(r)
            attempted, failed = attempted + a, failed + f
        reading = Reading(tr, spans, entry.shapes(), card)
        for m in manifest.per_layer(cell):
            value = manifest.reader(m["name"])(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra = dict(busy_s=tr.busy_ns / 1e9, window_s=tr.window_ns / 1e9)
        log(f"traced window {tr.window_ns / 1e9:.3f} s ({window_s:.3f} s on "
            f"the host clock), busy {tr.busy_ns / 1e9:.3f} s, "
            f"{len(tr.replays)} replays, whole {tr.whole}; spans "
            f"{ {k: [round(x, 4) for x in v] for k, v in spans.items()} }")
    else:
        while True:
            r = entry.job()
            a, f, m = entry.tally(r)
            attempted, failed, mbs = attempted + a, failed + f, mbs + m
            entry.keep(r)
            jobs += 1
            del r
            if time.perf_counter() - t_window >= seconds:
                break
        elapsed = time.perf_counter() - t_window
        names = {m["name"]: m for m in manifest.end_to_end(cell)}
        rate = traffic["rate_metric"]
        metrics[rate] = {"value": mbs / elapsed, "unit": names[rate]["unit"]}
        metrics["setup_s"] = {"value": setup_s,
                              "unit": names["setup_s"]["unit"]}
        log(f"window {elapsed:.3f} s, {jobs} jobs, {mbs} macroblocks")

    loaded = forbidden_loaded()
    if loaded:
        raise SystemExit(f"forbidden modules loaded: {loaded}")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    t0 = time.perf_counter()
    checks = entry.check()
    log(f"reference check {time.perf_counter() - t0:.3f} s")
    correct = failed == 0 and all(v <= lim for _, v, lim in checks)
    result = {
        "correct": correct, "attempted": attempted, "failed": failed,
        "metrics": metrics,
        "device": dict(platform="gpu" if device.type == "cuda" else "cpu",
                       kind=card.get("name", "cpu"), count=1,
                       memory_peak_bytes=peak, **extra),
    }
    if trace:
        result["breakdown"] = tr.breakdown
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in checks}
    for n, v, lim in checks:
        log(f"check {n}: {v} (limit {lim})")
    return result


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="port_bench/run.py")
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--list", action="store_true",
                    help="print each cell with its entry and metrics")
    return ap.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse_args(argv)
    manifest = Manifest()
    if args.list:
        for line in manifest.listing():
            print(json.dumps(line))
        return 0
    if args.workload not in manifest.cells:
        log(f"unknown workload {args.workload!r}; cells: "
            f"{sorted(manifest.cells)}")
        return 2
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = os.path.join(ROOT, rel)
    import torch
    chips = manifest.cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"no CUDA card, or fewer than {chips}: the benchmark measures "
            "the card and prints no result without one")
        return 2
    result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                 torch.device("cuda", 0), t_start, manifest)
    print(json.dumps(result), flush=True)
    return 0
