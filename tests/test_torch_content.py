"""The port's bench content (`p64tpu_torch.tools.content`) against the
repository's JAX bench (`bench.py`, loaded from its file, not edited) on
the CPU: the content itself, the bit totals of the four encode
configurations encoded from it, the decode content's bytes and its decoded
luma checksum; and the card line (`utils.card_line`)."""

import contextlib
import importlib.util
import io
import os
import re
import subprocess

import numpy as np
import pytest
import torch

from p64tpu.spec.constants import QCIF as JQCIF
from p64tpu_torch import utils
from p64tpu_torch.control.ratecontrol import RateConfig
from p64tpu_torch.core import decoder as tdec
from p64tpu_torch.core import encoder as tenc
from p64tpu_torch.spec.constants import CIF, QCIF
from p64tpu_torch.tools.content import make_content, make_decode_content

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the JAX bench's encode configurations (`bench.measure`), all at search 15
ENCODE_CONFIGS = {
    "cif": tenc.EncoderConfig(fmt=CIF, search=15,
                              rate=RateConfig(fixed_quant=10)),
    "cif_rc": tenc.EncoderConfig(fmt=CIF, search=15,
                                 rate=RateConfig(bit_rate=1024000)),
    "cif_intra": tenc.EncoderConfig(fmt=CIF, search=15, intra_only=True,
                                    rate=RateConfig(fixed_quant=10)),
    "qcif": tenc.EncoderConfig(fmt=QCIF, search=15,
                               rate=RateConfig(fixed_quant=10)),
}


@pytest.fixture(scope="module")
def jbench():
    spec = importlib.util.spec_from_file_location(
        "jax_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("noise", [5, 40])
def test_make_content_equals_jax(jbench, noise):
    got = make_content(QCIF, 3, 2, noise)
    want = jbench.make_content(JQCIF, 3, 2, noise)
    assert sorted(got) == sorted(want) == ["cb", "cr", "y"]
    for k in want:
        assert isinstance(got[k], np.ndarray) and got[k].dtype == np.uint8
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), k)


def test_content_prefix_of_stream_zero():
    """A (1, F) batch is stream 0's first F frames of any larger batch: the
    generator visits stream 0's frames first."""
    small = make_content(QCIF, 1, 2)
    big = make_content(QCIF, 3, 4)
    for k in small:
        np.testing.assert_array_equal(small[k][0], big[k][0, :2])


@pytest.mark.parametrize("config", list(ENCODE_CONFIGS))
def test_encode_bits_equal_jax(jbench, config):
    """2 streams x 2 frames of the content under each configuration: the
    port's bit total equals the JAX bench's."""
    cfg = ENCODE_CONFIGS[config]
    _, out = tenc.encode_sequence(cfg, make_content(cfg.fmt, 2, 2),
                                  device="cpu")
    with contextlib.redirect_stderr(io.StringIO()):
        want = jbench.measure(config, streams=2, frames_t=2, reps=0)
    assert out["total_bits"].shape == (2, 2)
    assert int(out["total_bits"].sum()) == want["bits"] > 0


def test_decode_content_and_checksum_equal_jax(jbench, monkeypatch):
    """At 4 streams x 2 frames (the least the mix's asserts take): the
    decode content's bytes, stuffing and MQUANT counts equal the JAX
    bench's, and the luma checksum of its decode equals the JAX bench's
    logged one and the encoder's reconstruction's."""
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

    datas, n_stuff, n_mq, recon = make_decode_content(4, 2, 10, device="cpu")
    assert datas == jdatas and (n_stuff, n_mq) == (jstuff, jmq)
    assert n_stuff > 0 and n_mq > 0
    assert recon[0].shape == (4, 2, CIF.height, CIF.width)
    assert want["bits"] == 8 * sum(map(len, datas))
    planes = tdec.decode_seq_batch(
        CIF, [tdec.parse_to_tensors(d)[2] for d in datas], device="cpu")
    checksum = sum(int(y.astype(np.int64).sum()) for y, _, _ in planes)
    assert checksum & 0xffff == jchk
    assert checksum == int(recon[0].sum())


def test_decode_content_needs_four_streams():
    with pytest.raises(ValueError, match=">= 4 streams"):
        make_decode_content(3, 1, 10, device="cpu")


def test_card_line_is_nvidia_smis_first_line(monkeypatch):
    """The name and power limit of the first card, as nvidia-smi prints
    them, asked for in one call that fails loudly."""
    calls = []

    def run(cmd, **kw):
        calls.append((cmd, kw))
        return subprocess.CompletedProcess(
            cmd, 0, "NVIDIA H100 80GB HBM3, 700.00 W\n"
                    "NVIDIA H100 80GB HBM3, 700.00 W\n", "")

    monkeypatch.setattr(subprocess, "run", run)
    assert utils.card_line() == "NVIDIA H100 80GB HBM3, 700.00 W"
    ((cmd, kw),) = calls
    assert cmd == ["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"]
    assert kw["check"] is True and kw["text"] is True
