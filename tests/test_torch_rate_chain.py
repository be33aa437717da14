"""The rate-control chain's kernels (`csrc/rate_chain.cu`) on the CPU.

The kernels run only on a card, but their decomposition runs here: a numpy
mirror of price -> walk -> emit, written as the kernels compute (a lane's
serial walk over a block's levels at every quantizer; the walk's 33-bit
masks, segment runs and per-segment buffer law; the emit's multiply-high
division), held equal to the plain chain `core.encoder._gob_chain` on
random, crafted and encoded inputs for 1 to 4 MQUANT segments.  Also: the
table tensor's layout against the source's constants, the division's
exactness, the wrapper's contract (the CPU takes the plain chain, bad
inputs raise), the launch and GOB counts a captured replay adds, the
counter `p64.rate.chain_kernel_gobs` and its benchmark reader.
"""

import dataclasses
import os
import re
import sys
import types

import numpy as np
import pytest
import torch
from torch.profiler import profile

from p64tpu_torch import trace
from p64tpu_torch.control.ratecontrol import RateConfig
from p64tpu_torch.core import encoder as enc
from p64tpu_torch.core import graphs
from p64tpu_torch.kernels import rate_chain_cuda as rc
from p64tpu_torch.spec.constants import QCIF
from p64tpu_torch.tools.content import make_content
from port_bench import harness, tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

SOURCE = os.path.join(REPO, "p64tpu_torch", "csrc", "rate_chain.cu")
MBS, QUANTS = 33, 31
T = rc.CHAIN_TABLES.astype(np.int64)
L = rc.TABLE_LAYOUT


def _tab(name, n=None):
    at = L[name]
    return T[at:at + (n or 1)] if n else T[at]


TC = _tab("tc_len", 64 * 128).reshape(64, 128)
EOB, SAVING, MQ_BITS, GOB_HEADER = _tab("scalar", 4)


def _magic(d):
    return (0xFFFFFFFF // d) + 1


def _abs_level(a, q):
    """The kernels' |AC level| at QUANT q: clamp |coef| to 8191, multiply
    high by the magic, clamp to 127."""
    a = np.minimum(np.abs(a), 8191).astype(np.uint64)
    return np.minimum((a * np.uint64(_magic(2 * q))) >> np.uint64(32),
                      127).astype(np.int64)


# ---------------------------------------------------------------------------
# the numpy mirror of the three kernels
# ---------------------------------------------------------------------------


def np_price(coefs, intra):
    """rate_price_kernel: (..., 33, 6, 64) coefficients, (..., 33) intra ->
    (..., 33, 31) entries (bits << 6) | cbp.  Every (block, q) lane walks
    its 64 levels in order, as a kernel lane does."""
    c = np.asarray(coefs, np.int64)[..., None]              # (..., 6, 64, 1)
    q = np.arange(1, QUANTS + 1)
    lv = np.stack([_abs_level(c[..., k, 0][..., None], q) for k in
                   range(64)], axis=-2)                     # (..., 6, 64, 31)
    is_intra = np.broadcast_to(np.asarray(intra)[..., None, None],
                               lv.shape[:-3] + (6, QUANTS))
    bits = np.where(is_intra, 8, 0)
    last = np.where(is_intra, 0, -1)
    nz = is_intra.copy()
    for k in range(64):
        l = lv[..., k, :]
        on = (l != 0) & ~(is_intra & (k == 0))
        run = np.clip(k - last - 1, 0, 63)
        bits = bits + np.where(on, TC[run, l], 0)
        last = np.where(on, k, last)
        nz = nz | on
    bits = bits - np.where(~is_intra & (lv[..., 0, :] == 1), SAVING, 0)
    part = np.where(nz, bits + EOB, 0)                      # (..., 6, 31)
    cbp = (nz * (1 << np.arange(5, -1, -1))[:, None]).sum(axis=-2)
    return (part.sum(axis=-2) << 6) | cbp


def seg_of(j, nseg):
    return j * nseg // MBS


def seg_end(seg, nseg):
    return min(((seg + 1) * MBS + nseg - 1) // nseg - 1, MBS - 1)


def seg_runs(nseg):
    """(start, end) of each non-empty segment, as the walk finds them."""
    out, start = [], 0
    while start < MBS:
        end = seg_end(seg_of(start, nseg), nseg)
        out.append((start, end))
        start = end + 1
    return out


def gob_quant(buf, rate):
    return min(max(buf // rate.qdfact + rate.qoffs, 1), 31)


def _mask(flags):
    return sum(1 << j for j, f in enumerate(flags) if f)


def _span(lo, hi):
    return ((1 << (hi + 1)) - 1) & ~((1 << lo) - 1)


def _lowest(mask):
    return (mask & -mask).bit_length() - 1


def np_walk(rate, buffer, table, intra, mc, fil, mv):
    """rate_walk_kernel: one stream at a time, each GOB's passes over its
    33 MBs.  Returns (cbp, coded, mtype, gquant, quant, bits, qlev)."""
    s_n, g_n = table.shape[:2]
    mbs = (s_n, g_n, MBS)
    cbp_o, coded_o = np.zeros(mbs, np.int64), np.zeros(mbs, bool)
    mt_o, quant_o, qlev_o = (np.zeros(mbs, np.int64) for _ in range(3))
    gq_o, bits_o = np.zeros((s_n, g_n), np.int64), np.zeros((s_n, g_n),
                                                            np.int64)
    mt_code = dict(zip(rc.MT_CODES, _tab("mt_code", 6)))
    flags = _tab("mtype_flags", 10)
    nseg = rate.mquant_segments
    runs = seg_runs(nseg)
    for s in range(s_n):
        buf = int(buffer[s])
        for g in range(g_n):
            fin, fmc, ffil = intra[s, g], mc[s, g], fil[s, g]
            mvx, mvy = mv[s, g, :, 0], mv[s, g, :, 1]

            def look(q):
                e = table[s, g, np.arange(MBS), np.asarray(q) - 1]
                cbp, blk = e & 63, e >> 6
                hc = cbp != 0
                coded = fin | fmc | hc
                mt = []
                for j in range(MBS):
                    name = ("intra" if fin[j] else
                            ("inter_fil_coef" if hc[j] else "inter_fil")
                            if fmc[j] and ffil[j] else
                            ("inter_mc_coef" if hc[j] else "inter_mc")
                            if fmc[j] else "inter")
                    mt.append(int(mt_code[name]))
                return cbp, blk, hc, coded, np.asarray(mt)

            def mb_bits(cbp, blk, coded, mt, up):
                mt = np.where(up, _tab("mq_up", 10)[mt], mt)
                fl = flags[mt]
                is_mc = ((fl & rc.FLAG_MC) != 0) & coded
                cmask, mcmask = _mask(coded), _mask(is_mc)
                bits = np.zeros(MBS, np.int64)
                for j in range(MBS):
                    if not coded[j]:
                        continue
                    prev = (cmask & ((1 << j) - 1)).bit_length() - 1
                    mba = j - prev
                    pred = (mba == 1 and prev >= 0 and (mcmask >> prev) & 1
                            and j % 11 != 0)
                    dx = ((mvx[j] - (mvx[prev] if pred else 0) + 16) & 31) - 16
                    dy = ((mvy[j] - (mvy[prev] if pred else 0) + 16) & 31) - 16
                    b = (_tab("mba_len", 34)[min(mba, MBS)]
                         + _tab("mtype_len", 10)[mt[j]])
                    if fl[j] & rc.FLAG_MQUANT:
                        b += MQ_BITS
                    if is_mc[j]:
                        b += (_tab("mvd_len", 32)[dx + 16]
                              + _tab("mvd_len", 32)[dy + 16])
                    if fl[j] & rc.FLAG_CBP:
                        b += _tab("cbp_len", 64)[cbp[j]]
                    if fl[j] & rc.FLAG_TCOEFF:
                        b += blk[j]
                    bits[j] = b
                return bits, mt

            q0 = gob_quant(buf, rate)
            q = np.full(MBS, q0)
            qseg = []
            if nseg > 1:
                for _ in range(2):
                    cbp, blk, hc, coded, mt = look(q)
                    bits, _ = mb_bits(cbp, blk, coded, mt, np.zeros(MBS,
                                                                    bool))
                    hmask = _mask(hc)
                    eff, acc, qseg = q0, 0, []
                    for r, (a, b) in enumerate(runs):
                        coef = hmask & _span(a, b)
                        qr = gob_quant(buf + acc, rate)
                        if r > 0 and coef and qr != eff:
                            mtf = mt[_lowest(coef)]
                            eff = qr
                            acc += (MQ_BITS
                                    + _tab("mtype_len", 10)[
                                        _tab("mq_up", 10)[mtf]]
                                    - _tab("mtype_len", 10)[mtf])
                        acc += int(bits[a:b + 1].sum())
                        q[a:b + 1] = qr
                        qseg.append(qr)
            cbp, blk, hc, coded, mt = look(q)
            quant, up = np.full(MBS, q0), np.zeros(MBS, bool)
            if nseg > 1:
                hmask, eff = _mask(hc), q0
                for r, (a, b) in enumerate(runs):
                    coef = hmask & _span(a, b)
                    if r > 0 and coef and qseg[r] != eff:
                        up[_lowest(coef)] = True
                        eff = qseg[r]
                    quant[a:b + 1] = eff
            bits, mt = mb_bits(cbp, blk, coded, mt, up)
            gob_bits = int(bits.sum()) + GOB_HEADER
            cbp_o[s, g], coded_o[s, g], mt_o[s, g] = cbp, coded, mt
            quant_o[s, g], qlev_o[s, g] = quant, q
            gq_o[s, g], bits_o[s, g] = q0, gob_bits
            buf = int(np.int32(buf + gob_bits))
    return cbp_o, coded_o, mt_o, gq_o, quant_o, bits_o, qlev_o


def np_emit(coefs, intra, coded, qlev):
    """rate_emit_kernel: every block's levels at its MB's QUANT."""
    c = np.asarray(coefs, np.int64)
    q = np.asarray(qlev)[..., None, None]
    lv = np.zeros_like(c)
    for qq in range(1, QUANTS + 1):
        a = _abs_level(c, qq)
        lv = np.where(q == qq, np.where(c < 0, -a, a), lv)
    dc = np.clip((c[..., 0] + 4) >> 3, 1, 254)
    lv[..., 0] = np.where(np.asarray(intra)[..., None], dc, lv[..., 0])
    return np.where(np.asarray(coded)[..., None, None], lv, 0)


def np_chain(rate, buffer, coefs, intra, mc, fil, mv):
    table = np_price(coefs, intra)
    cbp, coded, mtype, gquant, quant, bits, qlev = np_walk(
        rate, buffer, table, intra, mc, fil, mv)
    return (np_emit(coefs, intra, coded, qlev), cbp, coded, mtype, gquant,
            quant, bits)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

NAMES = ("levels", "cbp", "coded", "mtype", "gquant", "quant", "bits")


def _rate(nseg, bit_rate=64_000):
    return RateConfig(bit_rate=bit_rate, frame_rate=30, mquant_segments=nseg)


def _random(seed):
    """chip_smoke's random chain inputs at 4 QCIF streams: two of them with
    buffers at QUANT 1 and 31."""
    return list(chip_smoke.chain_inputs(seed, 4, QCIF.num_gobs))


def _crafted(case):
    """Inputs that walk the chain's edges."""
    buffer, coefs, intra, mc, fil, mv = _random(7)
    if case == "intra":
        intra[:] = True
        mc[:], fil[:], mv[:] = False, False, 0
        coefs[..., 0] = np.abs(coefs[..., 0]) * 8
    elif case == "zero_segments":
        # the middle row of every GOB is uncoded: no coefficient survives
        # any QUANT, no intra, no MC
        coefs[:, :, 11:22] = np.clip(coefs[:, :, 11:22], -1, 1)
        intra[:, :, 11:22] = mc[:, :, 11:22] = fil[:, :, 11:22] = False
        mv[:, :, 11:22] = 0
    elif case == "last_mb_first":
        # in every segment of three, only its last MB carries coefficients
        keep = np.zeros(MBS, bool)
        keep[[10, 21, 32]] = True
        coefs[:, :, ~keep] = np.clip(coefs[:, :, ~keep], -1, 1)
        intra[:] = False
        mc[:, :, ~keep] = fil[:, :, ~keep] = False
        mv[:, :, ~keep] = 0
    elif case == "q1":
        buffer[:] = 0              # the buffer law gives QUANT 1
    elif case == "q31":
        buffer[:] = 2_000_000      # and 31
    elif case == "large_levels":
        coefs = (coefs * 40).astype(np.int32)   # levels clamp at 127
    return buffer, coefs, intra, mc, fil, mv


@pytest.fixture(scope="module")
def encoded_inputs():
    """The chain's inputs of every frame of a CPU encode of textured QCIF
    content at 3 MQUANT segments: frame 0 intra, then inter frames with the
    decisions' MC and filter choices."""
    frames = make_content(QCIF, 2, 3, 40)
    cfg = enc.EncoderConfig(QCIF, rate=_rate(3, 96_000))
    got = []

    def record(*args):
        got.append([a.clone() for a in args[1:]])
        return enc._gob_chain(*args)

    orig = enc.gob_chain
    enc.gob_chain = record
    try:
        enc.encode_sequence(cfg, frames, device="cpu")
    finally:
        enc.gob_chain = orig
    return [[a.numpy() for a in frame] for frame in got]


def _check(rate, inputs):
    buffer, coefs, intra, mc, fil, mv = inputs
    want = enc._gob_chain(
        enc.EncoderConfig(QCIF, rate=rate),
        torch.as_tensor(np.asarray(buffer, np.int32)),
        *(torch.as_tensor(x) for x in (coefs, intra, mc, fil, mv)))
    got = np_chain(rate, buffer, coefs, intra, mc, fil, mv)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)
    return want


SEGMENTS = [1, 2, 3, 4]
CRAFTED = ["intra", "zero_segments", "last_mb_first", "q1", "q31",
           "large_levels"]


@pytest.mark.parametrize("nseg", SEGMENTS)
@pytest.mark.parametrize("seed", [1, 2])
def test_the_decomposition_equals_the_plain_chain_on_random_content(seed,
                                                                    nseg):
    _check(_rate(nseg), _random(seed))


@pytest.mark.parametrize("nseg", SEGMENTS)
@pytest.mark.parametrize("case", CRAFTED)
def test_the_decomposition_equals_the_plain_chain_on_crafted_content(case,
                                                                     nseg):
    want = _check(_rate(nseg), _crafted(case))
    gquant = want[4].numpy()
    if case == "q1":
        assert (gquant[:, 0] == 1).all()
    if case == "q31":
        assert (gquant == 31).all()
    if case == "intra":
        assert want[2].numpy().all()


@pytest.mark.parametrize("nseg", SEGMENTS)
@pytest.mark.parametrize("frame", [0, 1, 2])
def test_the_decomposition_equals_the_plain_chain_on_encoded_content(
        encoded_inputs, frame, nseg):
    inputs = encoded_inputs[frame]
    assert inputs[2].all() == (frame == 0)
    _check(_rate(nseg, 96_000), inputs)


def test_the_encoded_content_walks_mquant_and_mixed_decisions(
        encoded_inputs):
    """The encoded inputs hold what the cases above say: an inter frame
    mixes intra, MC with the loop filter and inter MBs without MC (the
    decisions filter every MC MB; `_random` mixes MC without it), and the
    chain writes MQUANT MBs at three segments."""
    _, _, intra, mc, fil, _ = encoded_inputs[1]
    assert intra.any() and (mc & fil).any() and (~intra & ~mc).any()
    _, _, _, mc, fil, _ = _random(1)
    assert (mc & fil).any() and (mc & ~fil).any()
    mtype = np.concatenate([_check(_rate(3, 96_000), f)[3].numpy().ravel()
                            for f in encoded_inputs])
    assert (rc.CHAIN_TABLES[L["mtype_flags"] + mtype] & rc.FLAG_MQUANT).any()


# ---------------------------------------------------------------------------
# the pieces the mirror shares with the source
# ---------------------------------------------------------------------------


def test_the_table_layout_is_the_sources():
    with open(SOURCE) as f:
        src = f.read()
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"\b(k\w+) = (\d+)[,;]", src)}
    names = {"tc_len": "kTcLen", "mba_len": "kMbaLen",
             "mtype_len": "kMtypeLen", "mvd_len": "kMvdLen",
             "cbp_len": "kCbpLen", "mtype_flags": "kMtypeFlags",
             "mq_up": "kMqUp", "mt_code": "kMtCode", "scalar": "kScalar",
             "size": "kTableSize"}
    assert {k: consts[v] for k, v in names.items()} == L
    assert rc.CHAIN_TABLES.size == L["size"]
    for flag in ("Mc", "Cbp", "Tcoeff", "Mquant"):
        assert consts[f"kFlag{flag}"] == getattr(rc, f"FLAG_{flag.upper()}")
    for i, name in enumerate(("Intra", "Inter", "Mc", "McCoef", "Fil",
                              "FilCoef")):
        assert consts[f"kMt{name}"] == i
    assert re.search(r"kPriceThreads = kBlocks \* 32", src)
    assert consts["kEmitThreads"] == rc.EMIT_THREADS == 256
    assert rc.PRICE_THREADS == 6 * 32


def test_the_multiply_high_divides_exactly_for_every_quantizer():
    a = np.arange(1 << 14, dtype=np.uint64)
    for q in range(1, QUANTS + 1):
        got = (a * np.uint64(_magic(2 * q))) >> np.uint64(32)
        np.testing.assert_array_equal(got, a // np.uint64(2 * q))
        # the clamp to 8191 leaves every level at or above 127 at 127
        assert 128 * 2 * q <= 8191


@pytest.mark.parametrize("nseg", list(range(1, 70)))
def test_segment_runs_are_the_segment_ids(nseg):
    sid = np.arange(MBS) * nseg // MBS
    want = [(int(np.flatnonzero(sid == v)[0]), int(np.flatnonzero(sid == v)
                                                   [-1]))
            for v in np.unique(sid)]
    assert seg_runs(nseg) == want


def test_more_segments_than_mbs_is_one_per_mb():
    """Empty segments change nothing: 40 segments walk as 33 of one MB."""
    inputs = _random(5)
    a = _check(_rate(40), inputs)
    b = _check(_rate(33), inputs)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the wrapper's contract
# ---------------------------------------------------------------------------


def _tensors(inputs):
    buffer, coefs, intra, mc, fil, mv = inputs
    return [torch.as_tensor(np.asarray(buffer, np.int32))] + [
        torch.as_tensor(x) for x in (coefs, intra, mc, fil, mv)]


def test_a_cpu_tensor_takes_the_plain_chain():
    rate = _rate(3)
    cfg = enc.EncoderConfig(QCIF, rate=rate)
    args = _tensors(_random(3))
    before = (rc.LAUNCHES, rc.GOBS)
    got = enc.gob_chain(cfg, *args)
    want = enc._gob_chain(cfg, *args)
    assert (rc.LAUNCHES, rc.GOBS) == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", [
    "cpu", "buffer_dtype", "coefs_dtype", "mask_dtype", "mv_dtype",
    "coefs_shape", "mask_shape", "streams", "not_contiguous", "no_rate",
    "no_segments"])
def test_bad_inputs_raise(case):
    rate = _rate(3)
    buffer, coefs, intra, mc, fil, mv = _tensors(_random(4))
    if case == "buffer_dtype":
        buffer = buffer.long()
    elif case == "coefs_dtype":
        coefs = coefs.to(torch.int16)
    elif case == "mask_dtype":
        mc = mc.to(torch.uint8)
    elif case == "mv_dtype":
        mv = mv.long()
    elif case == "coefs_shape":
        coefs = coefs[..., :32]
    elif case == "mask_shape":
        fil = fil[:, :, :32]
    elif case == "streams":
        buffer = buffer[:1]
    elif case == "not_contiguous":
        coefs = coefs.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "no_rate":
        rate = RateConfig()
    elif case == "no_segments":
        rate = dataclasses.replace(rate, mquant_segments=0)
    want = {"cpu": "not a CUDA device", "not_contiguous": "contiguous",
            "no_rate": "no rate control", "no_segments": "mquant_segments"
            }.get(case, "needs")
    before = (rc.LAUNCHES, rc.GOBS)
    with pytest.raises(ValueError, match=want):
        rc.rate_chain_cuda(rate, buffer, coefs, intra, mc, fil, mv)
    assert (rc.LAUNCHES, rc.GOBS) == before


def test_gob_chain_refuses_a_device_it_has_no_path_for():
    cfg = enc.EncoderConfig(QCIF, rate=_rate(3))
    args = [t.to("meta") for t in _tensors(_random(4))]
    with pytest.raises(ValueError, match="no path"):
        enc.gob_chain(cfg, *args)


# ---------------------------------------------------------------------------
# launch counts, the counter and its reader
# ---------------------------------------------------------------------------

COUNTER = "p64.rate.chain_kernel_gobs"


def _captured(chain_gobs, chain_launches=3):
    return graphs.Captured(types.SimpleNamespace(replay=lambda: None), None,
                           1, 0.0, 0.0, 0, chain_launches=chain_launches,
                           chain_gobs=chain_gobs)


@pytest.mark.parametrize("traced", [False, True])
def test_a_replay_adds_its_launches_and_counts_gobs_only_while_traced(
        monkeypatch, traced):
    monkeypatch.setattr(rc, "LAUNCHES", 5)
    monkeypatch.setattr(rc, "GOBS", 0)
    cap = _captured(32 * 12)
    before = trace.counters().get(COUNTER, 0)
    if traced:
        with profile():
            cap.replay()
            cap.replay()
    else:
        cap.replay()
        cap.replay()
    assert (rc.LAUNCHES, rc.GOBS) == (11, 2 * 384)
    assert trace.counters().get(COUNTER, 0) - before == (768 if traced
                                                         else 0)


def test_a_step_without_the_chain_counts_no_gobs(monkeypatch):
    before = trace.counters().get(COUNTER, 0)
    with profile():
        _captured(0, 0).replay()
    assert trace.counters().get(COUNTER, 0) == before


def test_the_cpu_program_runs_the_plain_chain_and_counts_nothing():
    """On the CPU a program runs with capture off through the plain chain:
    no launch, no GOB, no counter, traced or not."""
    cfg = enc.EncoderConfig(QCIF, rate=_rate(3, 96_000), emit_recon=False)
    frames = make_content(QCIF, 1, 2, 40)
    before = (rc.LAUNCHES, rc.GOBS, trace.counters().get(COUNTER, 0))
    cache = graphs.ProgramCache(1)
    with profile():
        got = enc.encode_sequence_graphed(cfg, frames, device="cpu",
                                          cache=cache)
    want = enc.encode_sequence_eager(cfg, frames, device="cpu")
    assert (rc.LAUNCHES, rc.GOBS,
            trace.counters().get(COUNTER, 0)) == before
    for k, v in want[1].items():
        assert torch.equal(got[1][k], v), k


MS = 1_000_000
READER = "chain_kernel_gobs_per_frame.encode"


def _reading(monkeypatch, counters, whole=True, frames=32):
    ev = [tracing.Event(tracing.WINDOW, "annotation", 0, 10 * MS),
          tracing.Event("cudaGraphLaunch", "runtime", MS, MS + 5_000, 1),
          tracing.Event("step_kernel", "kernel", MS + 10_000, MS + 90_000,
                        1)]
    log = [trace.Span("p64.encode.job", 1 * MS, 4 * MS, 11, 1, None, 1)]
    monkeypatch.setattr(trace, "spans", lambda: list(log))
    monkeypatch.setattr(trace, "counters", lambda: dict(counters))
    return harness.Reading(tracing.read_trace(ev, 1 if whole else 2), {},
                           dict(frames=frames), {})


@pytest.mark.parametrize("gobs,streams,frames,want", [
    (49_152, 128, 32, 12.0), (3 * 4 * 2, 4, 2, 3.0), (0, 4, 2, 0.0)])
def test_the_reader_reads_gobs_per_stream_frame(monkeypatch, gobs, streams,
                                                frames, want):
    reading = _reading(monkeypatch, {COUNTER: gobs,
                                     "p64.serialize.streams": streams},
                       frames=frames)
    assert harness.Manifest().reader(READER)(reading) == pytest.approx(
        want, rel=1e-12)


@pytest.mark.parametrize("case", ["no_trace_module", "no_counter",
                                  "no_streams", "not_whole"])
def test_the_reader_reads_none_without_what_it_reads(monkeypatch, case):
    counters = {COUNTER: 384, "p64.serialize.streams": 32}
    if case == "no_counter":
        del counters[COUNTER]
    elif case == "no_streams":
        del counters["p64.serialize.streams"]
    reading = _reading(monkeypatch, counters, whole=case != "not_whole")
    if case == "no_trace_module":
        monkeypatch.delattr(sys.modules["p64tpu_torch"], "trace")
        monkeypatch.setitem(sys.modules, "p64tpu_torch.trace", None)
    assert harness.Manifest().reader(READER)(reading) is None


def test_the_metric_is_listed_for_the_rate_cells_only():
    m = harness.Manifest()
    entry = next(x for x in m.data["per_layer"] if x["name"] == READER)
    assert entry["layer"] == "frame loop"
    assert entry["moves"] == "encode_mb_per_s"
    assert entry["source"] == "program_counter"
    for cell in m.cells:
        listed = READER in [x["name"] for x in m.per_layer(cell)]
        assert listed == (cell in ("cif_rc_p30_mq3.encode",
                                   "cif_rc_p16.encode",
                                   "qcif_p2.encode")), cell
