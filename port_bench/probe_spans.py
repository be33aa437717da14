"""What the port's span log shows in a traced window of one cell, and what
the spans cost.

    python3 -m port_bench.probe_spans --workload <cell> --seed <n>
                                      [--rounds 3] [--out file.json]

After the cell's set-up (as `harness.run` makes it), one traced window of
the cell's `trace_jobs` jobs is read for:

  * the clock: each span of the log against its range event in the same
    trace (the largest start and end differences);
  * the replays: every kernel of every graph replay starts after the start
    of the `p64.graphs.replays` span that queued its launch;
  * the card's idle time in the window by the innermost span of the
    caller thread over it (`spanlog.idle_by_span`), and the share of it
    under some `p64.*` span;
  * every per-layer metric of the cell, read from that window;

then the µs a span costs with no profiler and inside one, and
`--rounds` times, in turns, the same traced jobs with the spans on and
with `trace.span` replaced by its no-op: the host wall time per job of
each, which is the spans' cost with tracing on.  Prints one JSON line
(and writes it to --out).  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

from . import harness, spanlog, tracing


def _clock(records, events):
    """Largest |start| and |end| differences, ns, between each span and
    its range event (matched by name, in order of start)."""
    worst = [0, 0]
    unmatched = 0
    for name in {r.name for r in records}:
        mine = sorted((r for r in records if r.name == name),
                      key=lambda r: r.start_ns)
        theirs = sorted((e for e in events if e.name == name
                         and e.kind not in tracing.DEVICE_KINDS),
                        key=lambda e: e.start)
        unmatched += abs(len(mine) - len(theirs))
        for r, e in zip(mine, theirs):
            worst[0] = max(worst[0], abs(e.start - r.start_ns))
            worst[1] = max(worst[1], abs(e.end - r.end_ns))
    return dict(start_ns=worst[0], end_ns=worst[1], unmatched=unmatched)


def _replay_order(records, events):
    """(launches, launches under a replays span, kernels, kernels that
    start before the start of their launch's replays span, kernels that
    start before their launch, the earliest kernel start less its span's
    start and less its launch's start, ns)."""
    spans = sorted((r.start_ns, r.end_ns) for r in records
                   if r.name == "p64.graphs.replays")
    kernels = {}
    for e in events:
        if e.kind == "kernel":
            kernels.setdefault(e.corr, []).append(e)
    out = dict(launches=0, under_replays_span=0, kernels=0,
               kernels_before_span=0, kernels_before_launch=0,
               earliest_vs_span_ns=None, earliest_vs_launch_ns=None)
    for e in events:
        if e.kind != "runtime" or "cudaGraphLaunch" not in e.name:
            continue
        out["launches"] += 1
        owner = [s for s, t in spans if s <= e.start <= t]
        out["under_replays_span"] += bool(owner)
        for k in kernels.get(e.corr, []):
            out["kernels"] += 1
            out["kernels_before_launch"] += k.start < e.start
            lead = k.start - e.start
            if (out["earliest_vs_launch_ns"] is None
                    or lead < out["earliest_vs_launch_ns"]):
                out["earliest_vs_launch_ns"] = lead
            if not owner:
                out["kernels_before_span"] += 1
                continue
            out["kernels_before_span"] += k.start < owner[-1]
            lead = k.start - owner[-1]
            if (out["earliest_vs_span_ns"] is None
                    or lead < out["earliest_vs_span_ns"]):
                out["earliest_vs_span_ns"] = lead
    return out


def span_cost_us(trace, acts, n: int = 20_000) -> dict:
    """µs per span entered and left: with no profiler active, and inside an
    active one (a span and, for the difference, the no-op)."""
    from torch.profiler import profile

    def per_span() -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            with trace.span("p64.probe"):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    off = per_span()
    with profile(activities=acts):
        on = per_span()
        real, trace.span = trace.span, (lambda name: trace._NOOP)
        try:
            stubbed = per_span()
        finally:
            trace.span = real
    return dict(off=off, on=on, on_stubbed=stubbed)


def _jobs_wall(entry, n_jobs: int, acts) -> float:
    """Host seconds per job of n_jobs jobs under the profiler."""
    import torch
    from torch.profiler import profile
    with profile(activities=acts):
        t0 = time.perf_counter()
        for _ in range(n_jobs):
            entry.job()
        if entry.device.type == "cuda":
            torch.cuda.synchronize(entry.device)
        seconds = time.perf_counter() - t0
    return seconds / n_jobs


def probe(cell: str, seed: int, rounds: int, device,
          manifest: harness.Manifest) -> dict:
    import torch
    from torch.profiler import ProfilerActivity

    from p64tpu_torch import trace

    from .entries import ENTRIES
    config, traffic = manifest.config(cell), manifest.traffic(cell)
    entry = ENTRIES[traffic["entry"]](
        config, traffic, seed, device, harness.log,
        os.path.join(manifest.root, harness.INPUT_CACHE))
    card = harness.card_info(device) if device.type == "cuda" else {}
    entry.setup()
    n_jobs = traffic["trace_jobs"]
    first = max((r.id for r in trace.spans()), default=0)
    _, tr, _ = harness.traced_jobs(entry, n_jobs)
    reading = harness.Reading(tr, {}, entry.shapes(), card)
    job = ("p64.encode.job" if traffic["entry"] == "batch_encode"
           else "p64.fan.parse_to_tensors")
    got = spanlog.window_spans(reading, job)
    out = dict(cell=cell, seed=seed, card=card, whole=tr.whole,
               window_s=tr.window_ns / 1e9, busy_s=tr.busy_ns / 1e9)
    if got is None:
        out["error"] = "no spans of the cell's jobs in the window"
        return out
    caller, jobs, lo, hi = got
    new = [r for r in trace.spans() if r.id > first]
    out.update(jobs=jobs, spans=len(caller),
               device_named_spans=sum(e.name.startswith("p64.")
                                      for e in tr.events
                                      if e.kind in tracing.DEVICE_KINDS),
               clock=_clock(caller, tr.events),
               replays=_replay_order(new, tr.events))
    idle = spanlog.idle_by_span(tr.events, caller, lo, hi)
    total = sum(idle.values())
    out["idle_s"] = total / 1e9
    out["idle_under_spans"] = 1 - idle["none"] / total if total else None
    out["idle_by_span_s"] = {k: v / 1e9 for k, v in sorted(
        idle.items(), key=lambda kv: -kv[1])}
    out["self_ms_per_job"] = {name: own / jobs / 1e6 for name, _, _, own
                              in trace.summarize(caller)}
    out["metrics"] = {m["name"]: manifest.reader(m["name"])(reading)
                      for m in manifest.per_layer(cell)}
    out["counters"] = trace.counters()

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    out["span_cost_us"] = span_cost_us(trace, acts)
    real, noop = trace.span, (lambda name: trace._NOOP)
    on, off = [], []
    for i in range(rounds):
        for stub in ((False, True) if i % 2 == 0 else (True, False)):
            trace.span = noop if stub else real
            try:
                wall = _jobs_wall(entry, n_jobs, acts)
                (off if stub else on).append(wall)
            finally:
                trace.span = real
    out["traced_job_s"] = dict(spans=on, stubbed=off,
                               median_spans=statistics.median(on),
                               median_stubbed=statistics.median(off))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="port_bench.probe_spans")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    for var, rel in harness.CACHE_DIRS.items():
        os.environ[var] = os.path.join(harness.ROOT, rel)
    import torch
    if not torch.cuda.is_available():
        harness.log("probe_spans: no CUDA card")
        return 2
    result = probe(args.workload, args.seed, args.rounds,
                   torch.device("cuda", 0), harness.Manifest())
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
