"""The decode's levels shipped packed: the native pack of a parsed stream
(`NativeBitIO.pack_levels`, `csrc/levels_pack.cpp`), the plain expansion
(`kernels.levels_cuda.expand_levels_plain`, the kernel's plain version)
and `core.decoder.stack_seqs`, which ships the pack and expands it.

Each stream's pack is held to a plain numpy pack of the levels8 the parser
wrote (`np.nonzero`), its expansion to those levels8 bit for bit, and the
batch stack_seqs gives on the CPU to the dense `np.stack` of every key.
The streams: the decode benchmark's content, pinned streams, a resync
stream whose duplicate GN re-parses an MB (the last writer wins), and one
whose re-parse leaves a negative slot-0 inter level on an intra MB."""

import functools
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from test_torch_decode_paths import (_bit_splice, _first_gob_start,
                                     _one_mb_stream, negative_slot0_data)
from p64tpu_torch import trace
from p64tpu_torch.control.ratecontrol import RateConfig
from p64tpu_torch.core import decoder as tdec
from p64tpu_torch.core.encoder import EncoderConfig, encode_to_bytes
from p64tpu_torch.kernels import _build, levels_cuda
from p64tpu_torch.native import load
from p64tpu_torch.native.binding import PACKED_KEYS
from p64tpu_torch.spec.constants import CIF, QCIF
from p64tpu_torch.tools import pinned
from p64tpu_torch.tools.content import make_content, make_decode_content

torch.set_num_threads(1)

PINS = ("config1_qcif_intra_q12", "config2_qcif_inter_q12_s15",
        "adv_noise_q10", "adv_scenecut_rc192k", "cif_rc1M_mquant3_t3")
STREAMS = ("content", "content_p16", *PINS, "resync_last_writer",
           "negative_slot0")


def _resync_last_writer() -> bytes:
    """A one-MB intra picture (DC 200 in every block), then an inter
    picture's GOB (level 52 in block 0): the duplicate GN re-parses MB 0,
    and its last writer's levels stand."""
    intra = _one_mb_stream(True, 200)
    inter = _one_mb_stream(False, 52)
    start = _first_gob_start(inter)
    return _bit_splice([(intra, 0, len(intra) * 8),
                        (inter, start, len(inter) * 8)])


@functools.lru_cache(maxsize=None)
def _streams(name: str):
    """(datas, resync) of a named test stream or batch."""
    if name == "content":
        return tuple(make_decode_content(4, 2, 10, device="cpu")[0]), False
    if name == "content_p16":
        cfg = EncoderConfig(fmt=CIF, search=15, rate=RateConfig(
            bit_rate=1_024_000, frame_rate=30))
        datas = encode_to_bytes(cfg, make_content(CIF, 2, 3, 5),
                                device="cpu")[0]
        return tuple(datas), False
    if name in PINS:
        cfg, frames = pinned.pinned_case(name)
        return (encode_to_bytes(cfg, frames, device="cpu")[0][0],), False
    if name == "resync_last_writer":
        return (_resync_last_writer(),), True
    return (negative_slot0_data(),), True


def _parsed(name: str):
    datas, resync = _streams(name)
    return [tdec.parse_to_tensors(d, resync=resync) for d in datas]


def numpy_pack(levels8: np.ndarray) -> dict:
    """The packed keys of (T, nMB, 6, 64) int8 levels, from np.nonzero."""
    t = levels8.shape[0]
    nz = levels8 != 0
    has = nz.any(-1)
    slot_bits = np.uint64(1) << np.arange(64, dtype=np.uint64)
    offsets = np.zeros((t + 1, 2), np.int64)
    offsets[1:] = np.cumsum(np.stack([has.reshape(t, -1).sum(1),
                                      nz.reshape(t, -1).sum(1)], 1), 0)
    return dict(
        nz_mbs=(has.astype(np.uint8) << np.arange(6, dtype=np.uint8)).sum(
            -1, dtype=np.uint8),
        nz_blocks=(nz[has] * slot_bits).sum(-1, dtype=np.uint64),
        nz_levels=levels8[np.nonzero(nz)],
        nz_offsets=offsets)


def _assert_pack(got: dict, want: dict, what: str = "") -> None:
    assert set(got) >= set(PACKED_KEYS)
    for k in PACKED_KEYS:
        assert got[k].dtype == want[k].dtype, (what, k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")


def _expand_one(seq: dict) -> torch.Tensor:
    """The plain expansion of one stream's pack, as a batch of one."""
    offsets = torch.from_numpy(seq["nz_offsets"][:-1])
    return levels_cuda.expand_levels(
        torch.from_numpy(seq["nz_mbs"])[:, None].contiguous(),
        torch.from_numpy(seq["nz_blocks"].view(np.int64)),
        torch.from_numpy(seq["nz_levels"]),
        offsets[:, None].contiguous())[:, 0]


@pytest.mark.parametrize("name", STREAMS)
def test_pack_equals_a_numpy_pack(name):
    for i, (_, _, seq) in enumerate(_parsed(name)):
        _assert_pack(seq, numpy_pack(np.asarray(seq["levels8"])),
                     f"{name} stream {i}")


@pytest.mark.parametrize("name", STREAMS)
def test_plain_expand_gives_levels8_back(name):
    for _, _, seq in _parsed(name):
        got = _expand_one(seq)
        assert got.dtype == torch.int8
        assert torch.equal(got, torch.from_numpy(np.asarray(seq["levels8"])))


@pytest.mark.parametrize("name", STREAMS)
def test_frames_to_tensors_packs_as_parse_to_tensors(name):
    datas, resync = _streams(name)
    for d, (_, _, seq) in zip(datas, _parsed(name)):
        got = tdec.frames_to_tensors(tdec.parse_any(d, resync=resync))
        _assert_pack(got, seq, name)


def test_the_streams_hold_the_cases():
    """The resync streams really hold what they are named for."""
    (_, _, seq), = _parsed("resync_last_writer")
    assert seq["levels8"][0, 0, 0, 0] == 52
    (_, _, seq), = _parsed("negative_slot0")
    assert seq["levels8"][0, 0, 0, 0] == -64 and seq["intra"][0, 0]
    assert seq["nz_levels"][0] == -64


def _dense_stack(seqs) -> dict:
    """What stack_seqs gave before the levels crossed packed."""
    return {k: torch.from_numpy(np.stack([np.asarray(s[k]) for s in seqs],
                                         axis=1))
            for k in tdec.SEQ_KEYS}


@pytest.mark.parametrize("name", ["content", "content_p16",
                                  "resync_and_negative_slot0"])
def test_stack_seqs_equals_the_dense_stack(name):
    if name == "resync_and_negative_slot0":
        parsed = _parsed("resync_last_writer") + _parsed("negative_slot0")
    else:
        parsed = _parsed(name)
    fmt = parsed[0][0]
    seqs = [seq for _, _, seq in parsed]
    got = tdec.stack_seqs(fmt, seqs, "cpu")
    want = _dense_stack(seqs)
    assert list(got) == list(tdec.SEQ_KEYS)
    for k in tdec.SEQ_KEYS:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def test_stack_seqs_never_reads_levels8():
    """The dense levels are never read: a seq whose levels8 is garbage of
    the right shape stacks to the same batch."""
    parsed = _parsed("content")
    seqs = [dict(seq) for _, _, seq in parsed]
    want = tdec.stack_seqs(CIF, seqs, "cpu")
    for seq in seqs:
        seq["levels8"] = np.full(seq["levels8"].shape, 99, np.int8)
    got = tdec.stack_seqs(CIF, seqs, "cpu")
    for k in tdec.SEQ_KEYS:
        assert torch.equal(got[k], want[k]), k


def test_stack_seqs_counts_the_packed_macroblocks():
    parsed = _parsed("content")
    seqs = [seq for _, _, seq in parsed]
    t = seqs[0]["levels8"].shape[0]
    before = trace.counters().get("p64.decode.packed_mbs", 0)
    tdec.stack_seqs(CIF, seqs, "cpu")
    assert trace.counters().get("p64.decode.packed_mbs", 0) == before
    with profile(activities=[ProfilerActivity.CPU]):
        tdec.stack_seqs(CIF, seqs, "cpu")
        tdec.decode_frames(tdec.parse_any(_streams("content")[0][0]),
                           device="cpu")
    counters = trace.counters()
    assert counters["p64.decode.packed_mbs"] - before == (
        t * (len(seqs) + 1) * CIF.num_mbs)


def _synthetic(kind: str, t: int = 3, m: int = QCIF.num_mbs):
    rng = np.random.default_rng(23)
    if kind == "zeros":
        return np.zeros((t, m, 6, 64), np.int8)
    if kind == "full":
        levels = rng.integers(-128, 128, (t, m, 6, 64), dtype=np.int8)
        levels[levels == 0] = -128
        levels[0, 0, 0, :2] = (127, -128)
        return levels
    levels = np.where(rng.random((t, m, 6, 64)) < 0.03,
                      rng.integers(-128, 128, (t, m, 6, 64)), 0)
    return levels.astype(np.int8)


@pytest.mark.parametrize("kind", ["zeros", "full", "sparse"])
def test_pack_and_expand_synthetic_levels(kind):
    levels = _synthetic(kind)
    got = load().pack_levels(levels)
    _assert_pack(got, numpy_pack(levels), kind)
    assert len(got["nz_levels"]) == int((levels != 0).sum())
    assert torch.equal(_expand_one(got), torch.from_numpy(levels))


def test_pack_reads_frames_inside_a_larger_buffer():
    """parse_to_tensors hands the packer QCIF frames that are slices of a
    CIF-sized buffer: each frame's MBs contiguous, the frames strided."""
    whole = _synthetic("sparse", m=CIF.num_mbs)
    part = whole[:, :QCIF.num_mbs]
    assert not part.flags.c_contiguous
    _assert_pack(load().pack_levels(part),
                 numpy_pack(np.ascontiguousarray(part)))


@pytest.mark.parametrize("bad", ["dtype", "shape", "slots", "overlap"])
def test_pack_levels_refuses_what_it_cannot_walk(bad):
    levels = _synthetic("sparse")
    levels = {"dtype": levels.astype(np.int16),
              "shape": levels.reshape(3, -1, 64),
              "slots": levels[..., ::2],
              "overlap": np.lib.stride_tricks.as_strided(
                  levels, strides=(64, *levels.strides[1:]))}[bad]
    with pytest.raises(ValueError, match="pack_levels"):
        load().pack_levels(levels)


def test_expand_levels_refuses_bad_inputs():
    seq = load().pack_levels(_synthetic("sparse"))
    mbs = torch.from_numpy(seq["nz_mbs"])[:, None].contiguous()
    blocks = torch.from_numpy(seq["nz_blocks"].view(np.int64))
    values = torch.from_numpy(seq["nz_levels"])
    bases = torch.from_numpy(seq["nz_offsets"][:-1])[:, None].contiguous()
    cases = [(mbs.int(), blocks, values, bases, "mbs"),
             (torch.zeros((1, 1, 397), dtype=torch.uint8), blocks, values,
              torch.zeros((1, 1, 2), dtype=torch.int64), "at most 396"),
             (mbs, blocks.int(), values, bases, "blocks"),
             (mbs, blocks, values.short(), bases, "values"),
             (mbs, blocks, values, bases[:1], "bases"),
             (mbs.expand(-1, 2, -1), blocks, values,
              bases.expand(-1, 2, -1).contiguous(), "contiguous")]
    for m, b, v, o, match in cases:
        with pytest.raises(ValueError, match=match):
            levels_cuda.expand_levels(m, b, v, o)


def test_packer_is_built_into_build_native():
    """The packer is its own library beside the engine's, built from its
    own source (the engine's stays the JAX package's copy)."""
    path = load()._pack._name
    assert os.path.realpath(path) == os.path.realpath(os.path.join(
        _build.NATIVE_BUILD_DIR, _build.PACK_LIB))
    assert os.path.getmtime(path) >= os.path.getmtime(_build.PACK_SOURCE)
