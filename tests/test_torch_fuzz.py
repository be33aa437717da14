"""The port's encoder config fuzz (`p64tpu_torch.tools.fuzz_encoder`)
against the reference tool and the JAX package on the CPU, and both fuzz
tools' command lines.

The reference tool (`tools/fuzz_encoder.py`, loaded from its file, not
edited) runs with `encode_to_bytes` replaced by a recorder, so its first 16
samples of seed 77 are captured without encoding; the port's sampler and
content must equal them field by field and frame by frame.  Samples 1-6,
14 (flat) and 16 (bright) must encode to the JAX package's bytes, bit
counts, coded flags and reconstruction, and pass the port's contract.  The
decode differential fuzz is held to its reference in
test_torch_fuzz_differential.py."""

import dataclasses
import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fuzz_reference import Stop, run_reference
from p64tpu.control.decisions import DecisionConfig as JDecisionConfig
from p64tpu.control.ratecontrol import RateConfig as JRateConfig
from p64tpu.core import decoder as jdec
from p64tpu.core import encoder as jenc
from p64tpu.entropy import parse as jparse
from p64tpu.spec import constants as jconst
from p64tpu_torch.core import decoder
from p64tpu_torch.spec.constants import CIF, QCIF
from p64tpu_torch.tools import fuzz_differential, fuzz_encoder

torch.set_num_threads(1)

#: reference samples captured, those encoded by JAX too, and the content
#: families of the two that drive ties and the decision-variance edge
N_SAMPLES = 16
ENCODED = (1, 2, 3, 4, 5, 6, 14, 16)
FAMILY = {14: "flat", 16: "bright"}


@pytest.fixture(scope="module")
def reference_samples():
    """(cfg, numpy frames) of the reference encoder fuzz's first N_SAMPLES
    samples of seed 77, as its loop hands them to encode_to_bytes.  The
    recorder returns an all-uncoded result and the decode and parse are
    stubbed empty, so the loop's checks pass without work."""
    got = []

    def record(cfg, frames):
        got.append((cfg, {k: np.asarray(v) for k, v in frames.items()}))
        if len(got) == N_SAMPLES:
            raise Stop
        none = np.zeros(frames["y"].shape[0])
        return b"", dict(frame_coded=none.astype(bool), total_bits=none,
                         recon_y=none, recon_cb=none, recon_cr=none), None

    empty = np.zeros(0)
    run_reference("fuzz_encoder", 77, [
        (jenc, "encode_to_bytes", record),
        (jdec, "decode_stream", lambda data: (empty, empty, empty, [])),
        (jparse, "parse_stream", lambda data, strict=True: [])])
    return got


@pytest.fixture(scope="module")
def port_samples():
    rng = np.random.default_rng(77)
    return [fuzz_encoder.sample(rng) for _ in range(N_SAMPLES)]


@pytest.mark.parametrize("index", range(1, N_SAMPLES + 1))
def test_sample_equals_reference(index, reference_samples, port_samples):
    cfg, frames = reference_samples[index - 1]
    s = port_samples[index - 1]
    assert s["fmt"] == cfg.fmt.name
    assert s["t"] == frames["y"].shape[0]
    assert s["search"] == cfg.search
    assert s["rate"] == dataclasses.asdict(cfg.rate)
    assert s["intra_only"] == cfg.intra_only == (cfg.search == 0)
    assert s["intra_period"] == cfg.intra_period
    assert s["emit_recon"] == cfg.emit_recon
    assert s["filter_with_mc"] == cfg.decisions.filter_with_mc
    assert s["family"] == FAMILY.get(index, s["family"])
    assert s["family"] in fuzz_encoder.FAMILIES
    for k in ("y", "cb", "cr"):
        assert s["frames"][k].dtype == frames[k].dtype == np.uint8
        np.testing.assert_array_equal(s["frames"][k], frames[k], err_msg=k)
    # the port's config carries the same settings
    pc = fuzz_encoder.port_config(s)
    assert pc.fmt is {"CIF": CIF, "QCIF": QCIF}[cfg.fmt.name]
    assert dataclasses.asdict(pc.rate) == dataclasses.asdict(cfg.rate)
    assert dataclasses.asdict(pc.decisions) == \
        dataclasses.asdict(cfg.decisions)


def _jax_config(s):
    return jenc.EncoderConfig(
        fmt={"CIF": jconst.CIF, "QCIF": jconst.QCIF}[s["fmt"]],
        search=s["search"], rate=JRateConfig(**s["rate"]),
        intra_only=s["intra_only"], intra_period=s["intra_period"],
        emit_recon=s["emit_recon"],
        decisions=JDecisionConfig(filter_with_mc=s["filter_with_mc"]))


@pytest.mark.parametrize("index", ENCODED)
def test_sample_encodes_to_jax_bytes(index, port_samples):
    s = port_samples[index - 1]
    got = fuzz_encoder.check(s, "cpu")
    data, out, _ = jenc.encode_to_bytes(
        _jax_config(s), {k: jnp.asarray(v) for k, v in s["frames"].items()})
    assert got["data"] == data
    np.testing.assert_array_equal(got["total_bits"],
                                  np.asarray(out["total_bits"]))
    np.testing.assert_array_equal(got["frame_coded"],
                                  np.asarray(out["frame_coded"]))
    assert (got["recon"] is None) == (not s["emit_recon"])
    if s["emit_recon"]:
        for name, plane in zip(("y", "cb", "cr"), got["recon"]):
            np.testing.assert_array_equal(
                plane, np.asarray(out["recon_" + name]), err_msg=name)


def test_first_difference_names_the_index():
    f = fuzz_encoder.first_difference
    assert f(b"abc", b"abc") is None
    assert f(np.zeros((2, 3)), np.zeros((2, 3))) is None
    b = np.zeros((2, 3))
    b[1, 2] = 7
    assert f(np.zeros((2, 3)), b) == \
        "first differs at index (1, 2): 0.0 != 7.0"
    assert f(b"abcd", b"abxd").endswith("index (2,): 99 != 120")
    assert f(b"abc", b"abcd") == "length 3 != 4, first differs at 3"
    assert f(np.zeros((2, 2)), np.zeros((2, 3))) == "shape (2, 2) != (2, 3)"


SUMMARY = {
    fuzz_encoder: r"encoder config fuzz: 3 configs, all contracts held, "
                  r"\d+s",
    fuzz_differential: r"differential fuzz: 3 corrupted streams, 0 "
                       r"disagreements, \d+s",
}


@pytest.mark.parametrize("tool", [fuzz_encoder, fuzz_differential],
                         ids=["fuzz_encoder", "fuzz_differential"])
def test_main_on_cpu_prints_the_reference_summary(tool, monkeypatch,
                                                  tmp_path, capsys):
    monkeypatch.chdir(tmp_path)
    assert tool.main(["--device", "cpu", "--count", "3"]) == 0
    out = capsys.readouterr().out
    assert re.fullmatch(SUMMARY[tool] + "\n", out), out
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("tool", [fuzz_encoder, fuzz_differential],
                         ids=["fuzz_encoder", "fuzz_differential"])
def test_main_exits_2_without_a_card(tool, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main(["--count", "1"]) == 2
    out, err = capsys.readouterr()
    assert out == "" and "no CUDA device" in err


def test_encoder_fuzz_failure_writes_the_sample(monkeypatch, tmp_path,
                                                capsys):
    real = fuzz_encoder.check

    def check(s, device):
        got = real(s, device)
        if s["t"] > 1:
            raise AssertionError("recon_y, card against CPU: first differs "
                                 "at index (0, 1, 2): 3 != 4")
        return got

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("FUZZ_SEED", "77")
    monkeypatch.setattr(fuzz_encoder, "check", check)
    assert fuzz_encoder.main(["--device", "cpu", "--count", "5"]) == 1
    out = capsys.readouterr().out
    assert out.startswith("FAILURE at sample 1: AssertionError: recon_y, "
                          "card against CPU")
    with open(tmp_path / fuzz_encoder.FAIL_FILE) as f:
        record = json.load(f)
    assert (record["seed"], record["index"], record["t"]) == (77, 1, 4)
    assert record["failure"].endswith("(0, 1, 2): 3 != 4")
    assert "frames" not in record and record["rate"]["mquant_segments"] == 5


def test_a_fault_that_is_no_contract_failure_propagates(monkeypatch,
                                                        tmp_path):
    """A CUDA fault (any error but a broken contract or a refused stream)
    ends either fuzz with its own exception: nothing catches it and goes
    on, and no failure file stands in for it."""
    def fault(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(fuzz_encoder, "check", fault)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        fuzz_encoder.main(["--device", "cpu", "--count", "1"])
    with pytest.raises(RuntimeError, match="illegal memory access"):
        fuzz_differential.planes_or_refusal(fault)
    assert isinstance(fuzz_differential.planes_or_refusal(
        lambda: decoder.decode_stream(b"\x00" * 64, resync=True,
                                      device="cpu")), ValueError)
    assert not os.listdir(tmp_path)
