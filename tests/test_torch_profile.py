"""The port's profiling harness on the CPU: the steady-state line, a Chrome
trace and the operator table; and its refusal without a card."""

import json
import re

import pytest
import torch

from p64tpu_torch.tools import profile

torch.set_num_threads(1)


def test_profile_writes_trace_and_rate(tmp_path, capsys):
    trace_dir = tmp_path / "tr"
    assert profile.main(["--device", "cpu", "--streams", "2", "--frames",
                         "2", "--format", "QCIF", "--trace-dir",
                         str(trace_dir)]) == 0
    out = capsys.readouterr().out
    m = re.search(r"steady state: [\d.]+ ms for (\d+) MBs \((\d+) MB/s\) "
                  r"on cpu", out)
    assert m and int(m.group(1)) == 2 * 2 * 99
    assert "Self CPU" in out and "aten::" in out
    trace = trace_dir / "trace.json"
    assert trace.exists()
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_profile_without_a_card_is_an_error(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert profile.main(["--streams", "1", "--frames", "1"]) == 2
    assert "--device cpu" in capsys.readouterr().err
