"""The port's benchmark tools against the repository's JAX bench (`bench.py`,
loaded from its file, not edited) on the CPU: the content, the bits of the
four encode configurations, the decode content's bytes and its decoded luma
checksum, and the pipeline's bytes; the parity gate's switch and failure;
and each tool's `main`, which needs a card and exits 2 without one."""

import contextlib
import importlib.util
import io
import os
import re
import shutil
import tempfile

import numpy as np
import pytest
import torch

from p64tpu.spec.constants import QCIF as JQCIF
from p64tpu_torch.core import decoder as tdec
from p64tpu_torch.spec.constants import CIF, QCIF
from p64tpu_torch.tools import bench, bench_breadth, stage_bench

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jbench():
    spec = importlib.util.spec_from_file_location(
        "jax_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("noise", [5, 40])
def test_make_content_equals_jax(jbench, noise):
    got = bench.make_content(QCIF, 3, 2, noise)
    want = jbench.make_content(JQCIF, 3, 2, noise)
    assert sorted(got) == sorted(want) == ["cb", "cr", "y"]
    for k in want:
        assert isinstance(got[k], np.ndarray) and got[k].dtype == np.uint8
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), k)


def test_content_prefix_of_stream_zero():
    """A (1, F) batch is stream 0's first F frames of any larger batch: the
    generator visits stream 0's frames first."""
    small = bench.make_content(QCIF, 1, 2)
    big = bench.make_content(QCIF, 3, 4)
    for k in small:
        np.testing.assert_array_equal(small[k][0], big[k][0, :2])


@pytest.mark.parametrize("config", bench.ENCODE_CONFIGS)
def test_measure_bits_equal_jax(jbench, config):
    got = bench.measure(config, streams=2, frames_t=2, reps=0, device="cpu")
    want = jbench.measure(config, streams=2, frames_t=2, reps=0)
    assert got["bits"] == want["bits"] > 0
    assert got["config"] == config and got["streams"] == 2
    assert got["mbs"] == 0 and got["ms"] == float("inf")
    assert got["rep_ms"] == [] and got["device"] == "cpu"
    assert len(got["stream0_frame_bits"]) == 2


def test_measure_times_every_rep_and_stream_zero_bits():
    got = bench.measure("qcif", streams=2, frames_t=3, reps=2, device="cpu")
    assert len(got["rep_ms"]) == 2 and got["ms"] == min(got["rep_ms"])
    assert got["mbs"] == pytest.approx(2 * 3 * QCIF.num_mbs * 1e3 / got["ms"])
    assert got["compile_s"] > 0
    alone = bench.measure("qcif", streams=1, frames_t=2, reps=0,
                          device="cpu")
    assert sum(got["stream0_frame_bits"][:2]) == alone["bits"]


def test_measure_refuses_unknown_config():
    with pytest.raises(ValueError, match="unknown encode configuration"):
        bench.measure("cif_hd", streams=1, frames_t=1, reps=0, device="cpu")


def test_decode_content_and_checksum_equal_jax(jbench, monkeypatch):
    """At 4 streams x 2 frames (the least the mix's asserts take): the
    decode content's bytes, stuffing and MQUANT counts equal the JAX
    bench's, and the pipelined decode's luma checksum equals the JAX
    bench's logged one and the planes' own sum."""
    made = []
    make = jbench._make_decode_content

    def recording(*a):
        made.append(make(*a))
        return made[-1]

    monkeypatch.setattr(jbench, "_make_decode_content", recording)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        want = jbench.measure_decode(streams=4, frames_t=2, reps=1)
    (jdatas, jstuff, jmq), = made
    jchk = int(re.search(r"checksum (\d+)\)", err.getvalue()).group(1))

    port_made = []
    port_make = bench.make_decode_content

    def port_recording(*a, **k):
        port_made.append(port_make(*a, **k))
        return port_made[-1]

    monkeypatch.setattr(bench, "make_decode_content", port_recording)
    got = bench.measure_decode(streams=4, frames_t=2, reps=1, device="cpu")
    (datas, n_stuff, n_mq, recon), = port_made
    assert datas == jdatas and (n_stuff, n_mq) == (jstuff, jmq)
    assert n_stuff > 0 and n_mq > 0
    assert recon[0].shape == (4, 2, CIF.height, CIF.width)
    assert got["bits"] == want["bits"] == 8 * sum(map(len, datas))
    assert got["checksum"] & 0xffff == jchk
    planes = tdec.decode_seq_batch(
        CIF, [tdec.parse_to_tensors(d)[2] for d in datas], device="cpu")
    assert got["checksum"] == sum(int(y.astype(np.int64).sum())
                                  for y, _, _ in planes)
    assert got["checksum"] == int(recon[0].sum())
    assert len(got["rep_ms"]) == 1 and 0 <= got["overlap_hidden"] <= 1
    assert "compile_s" not in got


def test_decode_content_needs_four_streams():
    with pytest.raises(ValueError, match=">= 4 streams"):
        bench.make_decode_content(3, 1, 10, device="cpu")


def _files(path):
    return {n: open(os.path.join(path, n), "rb").read()
            for n in sorted(os.listdir(path))}


def test_pipeline_bytes_equal_jax(jbench, monkeypatch, tmp_path):
    """2 CIF streams x 2 frames, chunk 1: the .p64 files of the port's
    pipelined encode, and of its finalize-only split, equal the JAX
    bench's files byte for byte."""
    dirs = iter([tmp_path / "jax", tmp_path / "port"])

    def mkdtemp(prefix=""):
        d = next(dirs)
        d.mkdir()
        return str(d)

    monkeypatch.setattr(tempfile, "mkdtemp", mkdtemp)
    monkeypatch.setattr(shutil, "rmtree", lambda *a, **k: None)
    with contextlib.redirect_stderr(io.StringIO()):
        want = jbench.measure_pipeline(streams=2, frames_t=2, chunk=1,
                                       reps=0)
    got = bench.measure_pipeline(streams=2, frames_t=2, chunk=1, reps=1,
                                 device="cpu")
    jfiles, pfiles = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert sorted(jfiles) == ["s000.p64", "s001.p64"]
    assert sorted(pfiles) == ["f000.p64", "f001.p64", "s000.p64", "s001.p64"]
    for i in range(2):
        assert pfiles[f"s{i:03d}.p64"] == jfiles[f"s{i:03d}.p64"]
        assert pfiles[f"f{i:03d}.p64"] == jfiles[f"s{i:03d}.p64"]
    assert got["bits"] == want["bits"] == 8 * sum(map(len, jfiles.values()))
    assert got["config"] == "pipeline" and len(got["rep_ms"]) == 1
    assert got["device_ms"] > 0 and got["finalize_ms"] > 0


def test_pipeline_removes_its_directory(monkeypatch, tmp_path):
    made = []

    def mkdtemp(prefix=""):
        made.append(tmp_path / prefix)
        made[-1].mkdir()
        return str(made[-1])

    monkeypatch.setattr(tempfile, "mkdtemp", mkdtemp)
    bench.measure_pipeline(streams=1, frames_t=1, chunk=1, reps=0,
                           device="cpu")
    assert len(made) == 1 and not made[0].exists()


@pytest.mark.parametrize("tool", [bench, stage_bench, bench_breadth],
                         ids=["bench", "stage_bench", "bench_breadth"])
def test_main_exits_2_without_a_card(tool, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("P64_SKIP_PARITY", raising=False)
    assert tool.main([]) == 2
    out, err = capsys.readouterr()
    assert out == "" and "no CUDA device" in err


def test_parity_gate_skips_only_when_asked(monkeypatch, capsys):
    monkeypatch.setenv("P64_SKIP_PARITY", "1")
    bench.run_parity_gate()
    assert "parity gate SKIPPED (P64_SKIP_PARITY=1)" in capsys.readouterr().err


def test_parity_gate_failure_aborts(monkeypatch, capfd):
    """Without a card the gate's subprocess exits 2, so the gate fails and
    the benchmark would stop with exit 1."""
    monkeypatch.delenv("P64_SKIP_PARITY", raising=False)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    with pytest.raises(SystemExit) as e:
        bench.run_parity_gate()
    assert e.value.code == 1
    out, err = capfd.readouterr()
    assert out == ""
    assert "parity: no CUDA device" in err
    assert "PARITY GATE FAILED -- benchmark aborted" in err
