"""Cells, configurations, traffic mixes and per-layer metrics are found by
name: adding one of each adds files and manifest entries and edits no file
of port_bench/.  And a run without a card prints no result."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import torch

from port_bench import harness


def _digests(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            if "__pycache__" not in d:
                p = os.path.join(d, n)
                with open(p, "rb") as f:
                    out[os.path.relpath(p, root)] = hashlib.sha256(
                        f.read()).hexdigest()
    return out


def _copy(tmp_path):
    shutil.copytree(harness.BENCH, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    return tmp_path


def _run(root, *args, env=None):
    return subprocess.run([sys.executable, "port_bench/run.py", *args],
                          cwd=root, capture_output=True, text=True,
                          timeout=300, env=env)


def test_a_new_cell_config_and_metric_need_only_new_files(tmp_path):
    root = _copy(tmp_path)
    before = _digests(root / "port_bench")
    (root / "port_bench" / "configs" / "qcif_p6.json").write_text(json.dumps(
        {"format": "QCIF", "search": 15,
         "rate": {"bit_rate": 384000, "frame_rate": 30}}))
    # a line that corrupts bits, answered by the resync parse
    (root / "port_bench" / "configs" / "qcif_p6_ber.json").write_text(
        json.dumps({"format": "QCIF", "search": 15,
                    "rate": {"bit_rate": 384000, "frame_rate": 30},
                    "channel": {"bit_error_rate": 1e-3}}))
    (root / "port_bench" / "traffic" / "encode_s16.json").write_text(
        json.dumps({"entry": "batch_encode", "rate_metric":
                    "encode_mb_per_s", "streams": 16, "frames": 32,
                    "chunk": 16, "noise": 5, "trace_jobs": 2,
                    "span_jobs": 3}))
    (root / "port_bench" / "traffic" / "decode_s3.json").write_text(
        json.dumps({"entry": "batch_decode", "rate_metric":
                    "decode_mb_per_s", "streams": 3, "frames": 3,
                    "noise": 16, "keep_jobs": 2, "trace_jobs": 1,
                    "span_jobs": 1}))
    (root / "port_bench" / "metrics" / "replays_per_job.encode.py"
     ).write_text("def read(reading):\n"
                  "    return len(reading.trace.replays)\n")
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    for name in ("qcif_p6", "qcif_p6_ber"):
        manifest["configs"].append(
            {"name": name, "source": "https://www.itu.int/rec/T-REC-H.261",
             "file": f"port_bench/configs/{name}.json", "reduced": [],
             "why": "videophone"})
    manifest["workloads"] += [
        {"name": "qcif_p6.encode_s16", "config": "qcif_p6",
         "traffic": "encode_s16", "chips": 1, "why": "a 16-party bridge"},
        {"name": "qcif_p6_ber.decode_s3", "config": "qcif_p6_ber",
         "traffic": "decode_s3", "chips": 1, "why": "calls over a line"}]
    for m in manifest["end_to_end"]:
        if m["name"] == "encode_mb_per_s":
            m["workloads"].append("qcif_p6.encode_s16")
        if m["name"] == "decode_mb_per_s":
            m["workloads"].append("qcif_p6_ber.decode_s3")
    manifest["per_layer"].append(
        {"name": "replays_per_job.encode", "unit": "replays",
         "better": "lower", "source": "device_trace", "layer": "frame loop",
         "moves": "encode_mb_per_s", "workloads": ["qcif_p6.encode_s16"]})
    for m in manifest["per_layer"]:
        if m["name"] == "native_parse_ms.decode":
            m["workloads"].append("qcif_p6_ber.decode_s3")
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))

    r = _run(root, "--list")
    assert r.returncode == 0, r.stderr
    cells = {c["cell"]: c for c in map(json.loads, r.stdout.splitlines())}
    assert cells["qcif_p6.encode_s16"]["entry"] == "batch_encode"
    assert cells["qcif_p6.encode_s16"]["end_to_end"] == [
        "encode_mb_per_s", "setup_s"]
    assert cells["qcif_p6.encode_s16"]["per_layer"] == [
        "replays_per_job.encode"]
    assert cells["qcif_p6_ber.decode_s3"]["entry"] == "batch_decode"
    assert cells["qcif_p6_ber.decode_s3"]["per_layer"] == [
        "native_parse_ms.decode"]
    assert set(cells) == set(harness.Manifest().cells) | {
        "qcif_p6.encode_s16", "qcif_p6_ber.decode_s3"}
    # the cell on the line runs, damaged, and comes out correct
    r = harness.run("qcif_p6_ber.decode_s3", 2**31 + 41, 0.01, False,
                    torch.device("cpu"), 0.0, harness.Manifest(str(root)))
    assert r["correct"] and r["failed"] == 0
    assert set(r["checks"]) == {"pixels_differ", "streams_refused",
                                "refused_alone"}
    after = _digests(root / "port_bench")
    assert {k: v for k, v in after.items() if k in before} == before


def test_no_card_means_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cell in harness.Manifest().cells:
        r = _run(harness.ROOT, "--workload", cell, "--seed",
                 str(2**31 + 3), "--seconds", "1", "--trace", "0", env=env)
        assert r.returncode != 0
        assert r.stdout.strip() == ""
    # a checkout that holds only the benchmark: no port to import either
    root = _copy(tmp_path)
    r = _run(root, "--workload", "cif_q10.encode", "--seed", "1",
             "--seconds", "1", "--trace", "0")
    assert r.returncode != 0 and r.stdout.strip() == ""
