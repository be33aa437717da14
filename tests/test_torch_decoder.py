"""The port's decoder against the JAX package's, plane for plane (uint8,
exact): decode_seq_batch, decode_seq, decode_frames and decode_stream on
a fixed-q QCIF stream, a rate-controlled QCIF stream with mid-GOB MQUANT and
stuffing, the resync concealment case, and a 4-stream CIF slice of the
decode-benchmark mix; each also equal to the port encoder's own
reconstruction; and a decode resumed from the JAX decoder's planes."""

import os
import sys

import numpy as np
import pytest
import torch

from p64tpu.core import decoder as jdec
from p64tpu.entropy.bitio import BitReader
from p64tpu.entropy.parse import _scan_start_code
from p64tpu.spec.constants import CIF as JCIF
from p64tpu_torch.control.ratecontrol import RateConfig
from p64tpu_torch.core import decoder as tdec
from p64tpu_torch.core import encoder as tenc
from p64tpu_torch.entropy.parse import StreamError
from p64tpu_torch.spec.constants import CIF, QCIF
from p64tpu_torch.spec.luts import MTYPE_MQUANT
from p64tpu_torch.tools import golden_content as gc

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)


def _encode(cfg, frames):
    """Port encode on the CPU -> (bytes of each stream, recon planes as
    numpy (S, T, ...))."""
    data, out, _ = tenc.encode_to_bytes(cfg, frames, device="cpu")
    return data, out, tuple(out[k].numpy() for k in tenc.RECON_KEYS)


def _jax_decode(data, resync=False):
    """The JAX reference decode: native parse_to_tensors + decode_seq."""
    fmt, _, seq = jdec.parse_to_tensors(data, resync=resync)
    return jdec.decode_seq(fmt, seq)


def _assert_planes(got, want, what=""):
    for name, a, b in zip(("y", "cb", "cr"), got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == np.uint8 and a.shape == b.shape, (what, name)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: {name}")


def _all_paths(data, resync=False):
    """Planes of one stream through every port entry point (CPU)."""
    fmt, _, seq = tdec.parse_to_tensors(data, resync=resync)
    y, cb, cr, frames = tdec.decode_stream(data, resync=resync,
                                           device="cpu")
    return {
        "decode_seq_batch": tdec.decode_seq_batch(fmt, [seq],
                                                  device="cpu")[0],
        "decode_seq": tdec.decode_seq(fmt, seq, device="cpu"),
        "decode_frames": tdec.decode_frames(frames, device="cpu"),
        "decode_stream": (y, cb, cr),
    }


@pytest.fixture(scope="module")
def fixed_q():
    cfg = tenc.EncoderConfig(fmt=QCIF, search=15,
                             rate=RateConfig(fixed_quant=12))
    frames = {k: v[None, :4] for k, v in gc.config2_qcif_inter().items()}
    data, _, recon = _encode(cfg, frames)
    return data[0], tuple(p[0] for p in recon)


@pytest.fixture(scope="module")
def rate_controlled():
    frames = {k: v[None] for k, v in gc.luma_to_frames(
        gc.adversarial_sequences()["smooth"]).items()}
    cfg = tenc.EncoderConfig(fmt=QCIF, rate=RateConfig(
        bit_rate=192_000, frame_rate=30, mquant_segments=3))
    data, out, recon = _encode(cfg, frames)
    assert bool(out["frame_coded"].all())
    assert int(out["n_stuff"].sum()) > 0, "no stuffing in the fixture"
    assert np.isin(out["mtype"].numpy(),
                   np.flatnonzero(MTYPE_MQUANT)).any(), "no MQUANT MBs"
    return data[0], tuple(p[0] for p in recon)


@pytest.mark.parametrize("case", ["fixed_q", "rate_controlled"])
def test_every_entry_point_equals_jax_and_encoder(request, case):
    data, recon = request.getfixturevalue(case)
    want = _jax_decode(data)
    _assert_planes(want, recon, "JAX decode vs port encoder recon")
    for name, got in _all_paths(data).items():
        _assert_planes(got, want, name)


def test_resync_concealment_equals_jax():
    rng = np.random.default_rng(17)
    y = rng.integers(0, 256, (1, 4, 144, 176), np.uint8)
    frames = dict(y=y, cb=y[:, :, ::2, ::2], cr=y[:, :, 1::2, ::2])
    data, _, recon = _encode(tenc.EncoderConfig(fmt=QCIF, search=2), frames)
    data = data[0]
    r = BitReader(data)
    codes = []
    while _scan_start_code(r):
        pos = r.pos
        r.skip(16)
        codes.append((pos, r.read(4)))
    pscs = [i for i, (_, gn) in enumerate(codes) if gn == 0]
    pos, _ = codes[pscs[2] + 1]          # first GOB of frame 2
    bad = bytearray(data)
    for bit in range(pos + 20, pos + 25):  # GQUANT -> the forbidden 0
        bad[bit // 8] &= ~(0x80 >> (bit % 8))
    bad = bytes(bad)

    want = _jax_decode(bad, resync=True)
    paths = _all_paths(bad, resync=True)
    for name, got in paths.items():
        _assert_planes(got, want, name)
    # damage cannot propagate backwards
    _assert_planes([p[:2] for p in paths["decode_stream"]],
                   [p[0, :2] for p in recon], "frames before the damage")
    _, _, _, parsed = tdec.decode_stream(bad, resync=True, device="cpu")
    assert [p.damaged for p in parsed] == [False, False, True, False]
    with pytest.raises(StreamError):
        tdec.decode_stream(bad, device="cpu")


def test_decode_bench_mix_slice_equals_jax():
    """4 CIF streams x 3 frames of the decode-benchmark mix (fixed q,
    stuffing-heavy and MQUANT rate control), decoded as one batch."""
    datas, recon, n_stuff, n_mq = chip_smoke.decode_mix("cpu", 4, 3)
    assert n_stuff > 0 and n_mq > 0
    parsed = [tdec.parse_to_tensors(d) for d in datas]
    assert all(p[0] is CIF for p in parsed)
    got = tdec.decode_seq_batch(CIF, [p[2] for p in parsed], device="cpu")
    want = jdec.decode_seq_batch(
        JCIF, [jdec.parse_to_tensors(d)[2] for d in datas])
    for i in range(len(datas)):
        _assert_planes(got[i], want[i], f"stream {i} vs JAX")
        _assert_planes(got[i], [p[i].numpy() for p in recon],
                       f"stream {i} vs encoder recon")


def test_resync_phase_on_cpu(fixed_q, rate_controlled):
    """chip_smoke's phase 16 on the CPU alone, at 4 damaged copies of two
    QCIF streams: decode_stream and parse_to_tensors + decode_seq refuse
    the same copies and give equal planes for the rest, which equal the
    JAX package's resync decode."""
    streams = {"fixed_q": fixed_q[0], "rate_controlled": rate_controlled[0]}
    per, seed = 4, chip_smoke.RESYNC_SEED
    counts = chip_smoke.resync_phase(streams, "cpu", per, seed)
    assert counts["decoded"] + counts["refused"] == per * len(streams)
    assert counts["decoded"] > 0
    modes = set()
    for name, mode, d in chip_smoke.damaged_streams(streams, per, seed):
        modes.add(mode)
        port = chip_smoke._planes_or_refusal(
            lambda: tdec.decode_stream(d, resync=True, device="cpu"))
        want = chip_smoke._planes_or_refusal(
            lambda: _jax_decode(d, resync=True))
        what = f"{name}, mode {mode}"
        assert isinstance(port, ValueError) == isinstance(want, ValueError), \
            (what, port, want)
        if not isinstance(port, ValueError):
            _assert_planes(port, want, what)
    assert len(modes) > 1


def test_resume_from_jax_planes(fixed_q):
    """decode_frames(init=<JAX planes as numpy>) over the second half of a
    stream equals the JAX decode of the whole stream there."""
    data, _ = fixed_q
    want = _jax_decode(data)
    frames = tdec.parse_any(data)
    k = len(frames) // 2
    init = tuple(np.asarray(p[k - 1]) for p in want)
    got = tdec.decode_frames(frames[k:], init=init, device="cpu")
    _assert_planes(got, [np.asarray(p)[k:] for p in want], "resumed")
    got_t = tdec.decode_frames(frames[k:], device="cpu",
                               init=tuple(torch.tensor(p) for p in init))
    _assert_planes(got_t, got, "resumed from tensors")


def test_decoder_refusals(fixed_q):
    data, _ = fixed_q
    fmt, _, seq = tdec.parse_to_tensors(data)
    with pytest.raises(ValueError, match="no frames"):
        tdec.decode_frames([], device="cpu")
    with pytest.raises(ValueError, match="no frames"):
        tdec.decode_stream(b"\xff\x55" * 50, resync=True, device="cpu")
    with pytest.raises(StreamError, match="empty stream"):
        tdec.parse_to_tensors(b"\x00" * 64, resync=True)
    q = tdec.parse_any(data)[:1]
    c = tdec.parse_any(tenc.encode_to_bytes(
        tenc.EncoderConfig(fmt=CIF, search=0, intra_only=True),
        {k: v[None, :1] for k, v in gc.config3_cif_rc(1).items()},
        device="cpu")[0][0])
    with pytest.raises(ValueError, match="mixed picture formats"):
        tdec.decode_frames(q + c, device="cpu")
    with pytest.raises(ValueError, match="unequal length"):
        tdec.decode_seq_batch(fmt, [seq, {k: v[:2] for k, v in seq.items()}],
                              device="cpu")
    with pytest.raises(ValueError, match="init planes"):
        tdec.decode_frames(q, init=(np.zeros((2, 2), np.uint8),) * 3,
                           device="cpu")
    # an MV that reaches outside the picture is refused before any gather
    bad = {k: np.array(v) for k, v in seq.items()}
    bad["mv"][0, 0] = (-1, 0)            # MB 0 sits at the left edge
    with pytest.raises(ValueError, match="outside the QCIF picture"):
        tdec.decode_seq(fmt, bad, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdec.decode_seq(fmt, seq, device="cuda")
