"""CLI of the PyTorch port: same stream as the JAX CLI (fixed quantizer,
rate control, MQUANT segments), clear refusals for what is not ported yet
and for invalid flags."""

import pytest
import torch

from p64tpu import cli as jcli
from p64tpu.io import yuv
from p64tpu.tools import golden_content as gc
from p64tpu_torch import cli

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def y4m(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "in.y4m"
    frames = gc.luma_to_frames(gc.adversarial_sequences()["smooth"][:3])
    yuv.write_y4m(str(path), frames, (30, 1))
    return str(path)


@pytest.mark.parametrize("flags", [["-q", "10"], ["-q", "8", "-l", "-I", "2"],
                                   ["-q", "12", "-i", "0"], ["-r", "64000"],
                                   ["-r", "192000", "-m", "3"]],
                         ids=["q10", "q8_nofilter_iperiod2", "intra_only",
                              "rc64k", "rc192k_mquant3"])
def test_cli_stream_matches_jax_cli(tmp_path, y4m, flags, capsys):
    ours, theirs = str(tmp_path / "t.p64"), str(tmp_path / "j.p64")
    assert cli.main(["-s", ours, *flags, "-v", "--device", "cpu", y4m]) == 0
    out = capsys.readouterr().out
    assert jcli.main(["-s", theirs, *flags, y4m]) == 0
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    assert out.count(" dB ") >= 3 and "wrote" in out


@pytest.mark.parametrize("flags", [["-d"], ["-e"], ["-q", "0"], ["-i", "16"],
                                   ["-m", "3"], ["-r", "64000", "-m", "34"]])
def test_cli_refuses_with_status_2(tmp_path, y4m, flags, capsys):
    assert cli.main(["-s", str(tmp_path / "x.p64"), *flags, "--device", "cpu",
                     y4m]) == 2
    err = capsys.readouterr().err
    assert "p64tpu_torch:" in err
    if flags[0] in ("-d", "-e"):
        assert "not yet ported" in err
    if flags[0] == "-m":
        assert "needs rate control" in err
    if flags[-1] == "34":
        assert "1..33" in err


def test_cli_without_cuda_device_is_an_error(tmp_path, y4m, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert cli.main(["-s", str(tmp_path / "x.p64"), y4m]) == 2
    assert "--device cpu" in capsys.readouterr().err
    assert not (tmp_path / "x.p64").exists()
