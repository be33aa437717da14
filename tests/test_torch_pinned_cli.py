"""`python -m p64tpu_torch.tools.pinned`, the port's check mode of the JAX
package's pin tool, on the CPU: two cheap pins against the pin file print
PINS OK; a tampered copy of the file prints DRIFT and UNPINNED; without a
card the default device refuses."""

import json
import shutil

import pytest
import torch

from p64tpu_torch.tools import pinned

torch.set_num_threads(1)

TWO_PINS = ("config1_qcif_intra_q12", "mquant2pass_graded_qcif")


@pytest.fixture
def two_pins(monkeypatch):
    monkeypatch.setattr(pinned, "ALL_PINS", TWO_PINS)


def test_two_pins_check_ok(two_pins, capsys):
    assert pinned.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.strip().splitlines()[-1] == "PINS OK"
    assert "DRIFT" not in out and "UNPINNED" not in out


def test_current_hashes_in_the_pin_file_form(two_pins):
    with open(pinned.PIN_FILE) as f:
        want = json.load(f)
    streams = {}
    got = pinned.current_hashes("cpu", streams)
    assert got == {k: want[k] for k in TWO_PINS}
    assert {k: len(v) for k, v in streams.items()} == {
        k: want[k]["bytes"] for k in TWO_PINS}


def test_tampered_pin_file_prints_drift(two_pins, monkeypatch, tmp_path,
                                        capsys):
    copy = tmp_path / "pinned_goldens.json"
    shutil.copy(pinned.PIN_FILE, copy)
    pins = json.loads(copy.read_text())
    pins[TWO_PINS[0]]["sha256"] = "0" * 64
    del pins[TWO_PINS[1]]
    copy.write_text(json.dumps(pins))
    monkeypatch.setattr(pinned, "PIN_FILE", str(copy))
    assert pinned.main(["--device", "cpu"]) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith(f"DRIFT {TWO_PINS[0]}: pinned ")
    assert lines[1].startswith(f"UNPINNED {TWO_PINS[1]}: ")
    assert lines[-1] == "PINS CHANGED"


def test_default_device_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pinned.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err
