"""Cells, configurations, traffic mixes and per-layer metrics are found by
name: adding one of each adds files and manifest entries and edits no file
of port_bench/.  And a run without a card prints no result."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

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
    (root / "port_bench" / "configs" / "qcif_p2.json").write_text(json.dumps(
        {"format": "QCIF", "search": 15,
         "rate": {"bit_rate": 128000, "frame_rate": 30}}))
    (root / "port_bench" / "traffic" / "encode_s16.json").write_text(
        json.dumps({"entry": "batch_encode", "rate_metric":
                    "encode_mb_per_s", "streams": 16, "frames": 32,
                    "chunk": 16, "noise": 5, "trace_jobs": 2,
                    "span_jobs": 3}))
    (root / "port_bench" / "metrics" / "replays_per_job.encode.py"
     ).write_text("def read(reading):\n"
                  "    return len(reading.trace.replays)\n")
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append(
        {"name": "qcif_p2", "source": "https://www.itu.int/rec/T-REC-H.261",
         "file": "port_bench/configs/qcif_p2.json", "reduced": [],
         "why": "videophone"})
    manifest["workloads"].append(
        {"name": "qcif_p2.encode_s16", "config": "qcif_p2",
         "traffic": "encode_s16", "chips": 1, "why": "a 16-party bridge"})
    for m in manifest["end_to_end"]:
        if m["name"] == "encode_mb_per_s":
            m["workloads"].append("qcif_p2.encode_s16")
    manifest["per_layer"].append(
        {"name": "replays_per_job.encode", "unit": "replays",
         "better": "lower", "source": "device_trace", "layer": "frame loop",
         "moves": "encode_mb_per_s", "workloads": ["qcif_p2.encode_s16"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))

    r = _run(root, "--list")
    assert r.returncode == 0, r.stderr
    cells = {c["cell"]: c for c in map(json.loads, r.stdout.splitlines())}
    assert cells["qcif_p2.encode_s16"]["entry"] == "batch_encode"
    assert cells["qcif_p2.encode_s16"]["end_to_end"] == [
        "encode_mb_per_s", "setup_s"]
    assert cells["qcif_p2.encode_s16"]["per_layer"] == [
        "replays_per_job.encode"]
    assert set(cells) == set(harness.Manifest().cells) | {
        "qcif_p2.encode_s16"}
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
