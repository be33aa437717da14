"""The port's decode differential fuzz (`p64tpu_torch.tools
.fuzz_differential`) against the reference tool and the JAX package on the
CPU.

The reference tool (`tools/fuzz_differential.py`, loaded from its file, not
edited) runs with the JAX Python parser wrapped by a recorder, which keeps
each corrupted stream its loop parses in resync mode, that parse and the
strict outcome, for the first 40 streams of seed 999.  The port's symbol
generator and corruptions must give the same bytes, and on each stream the
port's Python parser, its engine, both decode paths, the JAX parser and JAX
parse_to_tensors + decode_seq must agree on fields, damage flags, strict
outcome and planes or refusal (not JAX decode_stream: its split_levels wraps
a negative slot-0 level, see test_torch_decode_paths.py).  chip_smoke's
phase 16 draws its damaged pins through the same corrupt."""

import dataclasses
import itertools
import os
import sys

import numpy as np
import pytest
import torch

import helpers
from fuzz_reference import Stop, run_reference
from p64tpu.core import decoder as jdec
from p64tpu.entropy import parse as jparse
from p64tpu.spec import constants as jconst
from p64tpu_torch.native import load
from p64tpu_torch.spec.constants import CIF, QCIF
from p64tpu_torch.tools import fuzz_differential

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

#: reference corrupted streams captured and held to the JAX package
N_STREAMS = 40


@pytest.fixture(scope="module")
def reference_corruptions():
    """The reference differential fuzz's first N_STREAMS corrupted streams
    of seed 999, each with the JAX Python parser's results on it: the
    stream its loop hands the parser in resync mode, that parse's
    pictures, and whether the strict parse that follows accepts it."""
    real = jparse.parse_stream
    got = []

    def record(data, strict=True):
        if not strict:
            if len(got) == N_STREAMS:
                raise Stop
            got.append(dict(data=bytes(data), resync=real(data, False)))
            return got[-1]["resync"]
        assert data == got[-1]["data"]
        got[-1]["strict_accepted"] = False
        frames = real(data)
        got[-1]["strict_accepted"] = True
        return frames

    run_reference("fuzz_differential", 999,
                   [(jparse, "parse_stream", record)])
    return got


@pytest.fixture(scope="module")
def port_corruptions():
    return list(itertools.islice(fuzz_differential.corruptions(999),
                                 N_STREAMS))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_frame_symbols_equal_reference(seed):
    """The base streams' generator, with each base stream's settings."""
    kw = dict(p_mquant=0.25 if seed == 2 else 0.0,
              p_coded=0.25 if seed == 3 else 0.7)
    jfmt, fmt = (jconst.CIF, CIF) if seed == 3 else (jconst.QCIF, QCIF)
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    for t in range(3):
        want = helpers.random_frame_symbols(jfmt, rj, tr=t, **kw)
        got = fuzz_differential.random_frame_symbols(fmt, rt, tr=t, **kw)
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            assert (a is None) == (b is None), f.name
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=f.name)
                assert np.asarray(a).dtype == np.asarray(b).dtype, f.name
    assert rt.random() == rj.random()


@pytest.mark.parametrize("index", range(N_STREAMS))
def test_corruption_equals_reference(index, reference_corruptions,
                                     port_corruptions):
    mode, data = port_corruptions[index]
    assert mode in range(4)
    assert data == reference_corruptions[index]["data"]


def _jax_planes(data):
    fmt, _, seq = jdec.parse_to_tensors(data, resync=True)
    return jdec.decode_seq(fmt, seq)


@pytest.mark.parametrize("index", range(N_STREAMS))
def test_corrupted_stream_agrees_across_paths_and_jax(
        index, port_corruptions, reference_corruptions):
    _, data = port_corruptions[index]
    assert fuzz_differential.field_difference(data) is None
    accepted, diff = fuzz_differential.strict_difference(data)
    assert diff is None
    refused, diff = fuzz_differential.decode_difference(data, "cpu")
    assert diff is None
    # the JAX Python parser, as the reference loop ran it on this stream:
    # the same pictures, flags and strict outcome as the port's engine
    # (which field_difference held to the port's Python parser)
    ref = reference_corruptions[index]
    assert ref["data"] == data
    got = load().parse(data, resync=True)
    assert len(got) == len(ref["resync"])
    for a, b in zip(got, ref["resync"]):
        assert (a.fmt.name, a.tr, a.damaged) == (b.fmt.name, b.tr, b.damaged)
        for f in fuzz_differential.FIELDS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f)
    assert accepted == ref["strict_accepted"]
    # the planes, or the refusal, of JAX parse_to_tensors + decode_seq
    port = next(iter(fuzz_differential.decode_paths(data, "cpu").values()))
    want = fuzz_differential.planes_or_refusal(lambda: _jax_planes(data))
    assert refused == isinstance(port, ValueError) == \
        isinstance(want, ValueError), (port, want)
    if not refused:
        for name, a, b in zip(("y", "cb", "cr"), port, want):
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_corruptions_cover_every_mode_and_outcome(reference_corruptions,
                                                  port_corruptions):
    assert {m for m, _ in port_corruptions} == set(range(4))
    assert any(r["resync"] and not r["strict_accepted"]
               for r in reference_corruptions)


def _former_damaged_streams(streams, per_stream, seed):
    """chip_smoke's phase-16 generator as written before it called the
    tool's corrupt."""
    rng = np.random.default_rng(seed)
    pool = [streams[k] for k in sorted(streams)]
    for name in sorted(streams):
        for _ in range(per_stream):
            d = bytearray(streams[name])
            mode = int(rng.integers(4))
            if mode == 0:
                for _ in range(1 + int(rng.integers(6))):
                    p = int(rng.integers(len(d)))
                    d[p] ^= 1 << int(rng.integers(8))
            elif mode == 1:
                d = d[:int(rng.integers(1, len(d)))]
                if len(d) > 2:
                    p = int(rng.integers(len(d)))
                    d[p] ^= 1 << int(rng.integers(8))
            elif mode == 2:
                other = pool[int(rng.integers(len(pool)))]
                d = (d[:int(rng.integers(len(d)))]
                     + other[int(rng.integers(len(other))):])
            else:
                p = int(rng.integers(len(d)))
                n = int(rng.integers(1, 64))
                d[p:p + n] = bytes(rng.integers(0, 256, min(n, len(d) - p),
                                                dtype=np.uint8))
            yield name, mode, bytes(d)


def test_phase16_damaged_streams_unchanged():
    """Phase 16's damaged pins, now drawn by fuzz_differential.corrupt, are
    the bytes its own generator drew."""
    streams = dict(zip("abc", fuzz_differential.base_streams()))
    got = list(chip_smoke.damaged_streams(streams, 12,
                                          chip_smoke.RESYNC_SEED))
    assert got == list(_former_damaged_streams(streams, 12,
                                               chip_smoke.RESYNC_SEED))
    assert {m for _, m, _ in got} == set(range(4))


def test_differential_fuzz_disagreement_writes_the_stream(monkeypatch,
                                                          tmp_path, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(fuzz_differential, "decode_difference",
                        lambda d, device: (False, "y first differs at (0,)"))
    assert fuzz_differential.main(["--device", "cpu", "--count", "5"]) == 1
    assert capsys.readouterr().out.startswith(
        "DISAGREEMENT after 0 streams: y first differs at (0,)")
    _, first = next(fuzz_differential.corruptions(999))
    assert (tmp_path / fuzz_differential.FAIL_FILE).read_bytes() == first
