"""A run of each cell, with the look for a card skipped, at a size the CPU
holds: sound, it comes out correct; with the timed path broken underneath
in each way the cell can be broken, it does not.  (The cells run on one
card, so no exchange between cards can be left out.)"""

import numpy as np
import pytest
import torch

from p64tpu_torch.core import decoder, encoder
from p64tpu_torch.tools import batch_encode
from port_bench import entries, harness
from port_bench.tests.small import small_checkout


def _run(tmp_path, cell):
    m = small_checkout(str(tmp_path))
    return harness.run(cell, 2**31 + 21, 0.01, False, torch.device("cpu"),
                       0.0, m)


def _unchanged_state(monkeypatch, cell):
    if cell.endswith("encode"):
        step = encoder.encode_frame_step

        def stuck(cfg, state, *a):
            _, out = step(cfg, state, *a)
            return dict(state), out
        monkeypatch.setattr(encoder, "encode_frame_step", stuck)
    else:
        def stuck(fmt, planes, fr):
            return dict(planes), dict(planes)
        monkeypatch.setattr(decoder, "_reconstruct_step", stuck)


def _half_batch(monkeypatch, cell):
    """Half the streams worked, their answers given for the rest too."""
    if cell.endswith("encode"):
        orig = batch_encode.encode_resilient

        def half(cfg, batch, mesh, **kw):
            n = batch["y"].shape[0]
            got = orig(cfg, {k: v[:(n + 1) // 2] for k, v in batch.items()},
                       mesh, **kw)
            return (got + got)[:n]
        monkeypatch.setattr(batch_encode, "encode_resilient", half)
    else:
        orig = decoder.decode_seq_batch

        def half(fmt, seqs, device):
            got = orig(fmt, seqs[:(len(seqs) + 1) // 2], device=device)
            return (got + got)[:len(seqs)]
        monkeypatch.setattr(decoder, "decode_seq_batch", half)


def _altered_answer(monkeypatch, cell):
    """One answer altered where it is produced."""
    if cell.endswith("encode"):
        orig = encoder.serialize_streams

        def altered(cfg, outputs):
            got = orig(cfg, outputs)
            data, n = got[-1]
            got[-1] = (data[:-1] + bytes([data[-1] ^ 0x80]), n)
            return got
        monkeypatch.setattr(encoder, "serialize_streams", altered)
    else:
        orig = decoder.decode_seq_batch

        def altered(fmt, seqs, device):
            got = orig(fmt, seqs, device=device)
            y = np.array(got[-1][0])
            y[-1, -1, -1] ^= 1
            got[-1] = (y,) + tuple(got[-1][1:])
            return got
        monkeypatch.setattr(decoder, "decode_seq_batch", altered)


CELLS = sorted(harness.Manifest().cells)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(tmp_path, cell):
    r = _run(tmp_path, cell)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    assert all(c["value"] == 0 for c in r["checks"].values())


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch,
                                   _altered_answer])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, cell,
                                            fault):
    m = small_checkout(str(tmp_path))
    entry = entries.ENTRIES[m.traffic(cell)["entry"]]
    setup = entry.setup

    def setup_then_break(self):          # the warm-up stays sound
        setup(self)
        fault(monkeypatch, cell)
    monkeypatch.setattr(entry, "setup", setup_then_break)
    r = harness.run(cell, 2**31 + 21, 0.01, False, torch.device("cpu"),
                    0.0, m)
    assert not r["correct"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values())
