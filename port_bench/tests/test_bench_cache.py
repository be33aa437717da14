"""The decode cell's input streams, kept by (configuration, mix, seed,
device kind, reference) in the checkout: a second run reads them, a file
whose content does not match its sha256 is made again, and streams that
are not the reference's of the seed stop the check."""

import os

import numpy as np
import pytest
import torch

from port_bench import entries, harness
from port_bench.tests.small import small_checkout

CELL = "cif_rc_p16.decode"


def _entry(m, seed=2**31 + 9):
    return entries.ENTRIES["batch_decode"](
        m.config(CELL), m.traffic(CELL), seed, torch.device("cpu"),
        lambda msg: None, os.path.join(m.root, harness.INPUT_CACHE))


def test_streams_round_trip(tmp_path):
    streams = [(b"\x01\x02\x03", 21), (b"", 0), (bytes(range(256)), 2048)]
    path = str(tmp_path / "d" / "s.npz")
    entries.save_streams(path, streams)
    assert entries.load_streams(path) == streams
    assert entries.load_streams(str(tmp_path / "missing.npz")) is None


def test_a_file_off_its_digest_is_not_read(tmp_path):
    path = str(tmp_path / "s.npz")
    entries.save_streams(path, [(b"\x10\x20", 16)])
    with np.load(path) as z:
        parts = dict(z)
    parts["data"] = parts["data"] ^ 1
    with open(path, "wb") as f:
        np.savez(f, **parts)
    assert entries.load_streams(path) is None
    with open(path, "wb") as f:
        f.write(b"not a zip")
    assert entries.load_streams(path) is None


def test_the_second_set_up_reads_the_first_ones_streams(tmp_path):
    m = small_checkout(str(tmp_path))
    first, how = _entry(m)._inputs()
    assert how == "made"
    again, how = _entry(m)._inputs()
    assert how == "cached" and again == first
    other, how = _entry(m, seed=2**31 + 10)._inputs()
    assert how == "made" and other != first


def test_streams_not_the_seeds_stop_the_check(tmp_path):
    m = small_checkout(str(tmp_path))
    e = _entry(m)
    e.setup()
    e.inputs = e.inputs[::-1]
    with pytest.raises(AssertionError):
        e.check()
