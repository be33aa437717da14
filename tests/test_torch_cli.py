"""CLI of the PyTorch port: same stream as the JAX CLI (fixed quantizer,
rate control, MQUANT segments), same decoded output (strict, resync, with
PSNR against a source), batch_decode equal to per-stream decodes, and clear
refusals for invalid flags."""

import os

import pytest
import torch

from p64tpu import cli as jcli
from p64tpu_torch import cli
from p64tpu_torch.io import yuv
from p64tpu_torch.tools import batch_decode
from p64tpu_torch.tools import golden_content as gc

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


@pytest.mark.parametrize("flags", [["-q", "0"], ["-i", "16"],
                                   ["-m", "3"], ["-r", "64000", "-m", "34"]])
def test_cli_refuses_with_status_2(tmp_path, y4m, flags, capsys):
    assert cli.main(["-s", str(tmp_path / "x.p64"), *flags, "--device", "cpu",
                     y4m]) == 2
    err = capsys.readouterr().err
    assert "p64tpu_torch:" in err
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


@pytest.fixture(scope="module")
def stream(tmp_path_factory, y4m):
    path = str(tmp_path_factory.mktemp("dec") / "s.p64")
    assert jcli.main(["-s", path, "-q", "10", y4m]) == 0
    return path


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("ext", [".y4m", ".yuv"])
def test_cli_decode_matches_jax_cli(tmp_path, stream, ext, capsys):
    ours, theirs = str(tmp_path / ("t" + ext)), str(tmp_path / ("j" + ext))
    assert cli.main(["-d", "-s", stream, "-o", ours, "-v",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert jcli.main(["-d", "-s", stream, "-o", theirs, "-v"]) == 0
    assert _read(ours) == _read(theirs)
    assert out == capsys.readouterr().out.replace(theirs, ours)
    assert "decoded 3 frames" in out and "coded MBs" in out


def test_cli_decode_prints_psnr_against_source(tmp_path, stream, y4m,
                                               capsys):
    assert cli.main(["-d", "-s", stream, "-o", str(tmp_path / "t.y4m"),
                     "--device", "cpu", y4m]) == 0
    out = capsys.readouterr().out
    assert jcli.main(["-d", "-s", stream, "-o", str(tmp_path / "j.y4m"),
                      y4m]) == 0
    want = capsys.readouterr().out
    psnr = [ln for ln in out.splitlines() if "sequence Y PSNR" in ln]
    assert len(psnr) == 1 and psnr == [
        ln for ln in want.splitlines() if "sequence Y PSNR" in ln]
    assert out.count(" dB ") >= 3


def test_cli_decode_strict_fails_and_resync_conceals(tmp_path, stream,
                                                     capsys):
    data = bytearray(_read(stream))
    data[len(data) // 2] ^= 0xFF
    bad = tmp_path / "bad.p64"
    bad.write_bytes(bytes(data))
    ours, theirs = str(tmp_path / "t.y4m"), str(tmp_path / "j.y4m")
    assert cli.main(["-d", "-s", str(bad), "-o", ours,
                     "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert jcli.main(["-d", "-s", str(bad), "-o", theirs]) == 1
    assert err.startswith("p64tpu_torch: invalid H.261 stream: ")
    assert err.replace("p64tpu_torch:", "p64tpu:") == capsys.readouterr().err
    assert not os.path.exists(ours)
    assert cli.main(["-d", "-e", "-s", str(bad), "-o", ours,
                     "--device", "cpu"]) == 0
    assert "damaged pictures concealed" in capsys.readouterr().err
    assert jcli.main(["-d", "-e", "-s", str(bad), "-o", theirs]) == 0
    assert _read(ours) == _read(theirs)
    junk = tmp_path / "junk.p64"
    junk.write_bytes(b"\xff\x55" * 64)
    assert cli.main(["-d", "-e", "-s", str(junk), "--device", "cpu"]) == 1
    assert "no frames" in capsys.readouterr().err


def test_cli_decode_without_cuda_device_is_an_error(tmp_path, stream,
                                                    capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = tmp_path / "t.y4m"
    assert cli.main(["-d", "-s", stream, "-o", str(out)]) == 2
    assert "--device cpu to decode" in capsys.readouterr().err
    assert not out.exists()


def test_batch_decode_equals_per_stream_decode(tmp_path, stream, y4m):
    short = str(tmp_path / "short.p64")
    assert cli.main(["-s", short, "-q", "8", "-b", "1", "--device", "cpu",
                     y4m]) == 0
    twin = str(tmp_path / "twin.p64")
    with open(twin, "wb") as f:
        f.write(_read(stream))
    outdir = tmp_path / "out"
    # s and twin (3 frames) share one batch; short (2 frames) has its own
    assert batch_decode.main(["-o", str(outdir), "--device", "cpu",
                              stream, twin, str(tmp_path / "sh*.p64")]) == 0
    for path in (stream, twin, short):
        name = os.path.splitext(os.path.basename(path))[0] + ".y4m"
        single = str(tmp_path / ("single_" + name))
        assert cli.main(["-d", "-s", path, "-o", single,
                         "--device", "cpu"]) == 0
        assert _read(outdir / name) == _read(single)
