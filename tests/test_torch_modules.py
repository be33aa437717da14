"""Module-by-module parity of the PyTorch port with the JAX package, at QCIF.

Every function gets the same seeded numpy inputs in both packages; the
results must be exactly equal integers.  The port's functions take a
leading stream axis, the JAX ones one stream at a time.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from p64tpu.control import decisions as jdec
from p64tpu.control import ratecontrol as jrc
from p64tpu.core import blocks as jblocks
from p64tpu.core import predict as jpred
from p64tpu.core import reconstruct as jrec
from p64tpu.entropy import lengths as jlen
from p64tpu.kernels import dct as jdct
from p64tpu.kernels import filter as jfilter
from p64tpu.kernels import quant as jquant
from p64tpu.spec.constants import FORMATS as JFORMATS
from p64tpu_torch.control import decisions, ratecontrol
from p64tpu_torch.core import blocks, predict, reconstruct
from p64tpu_torch.entropy import lengths
from p64tpu_torch.kernels import dct, filter as tfilter, quant
from p64tpu_torch.spec.constants import FORMATS

torch.set_num_threads(1)

S = 2
#: the port's QCIF for the port's functions, the JAX package's for its own
FMT, JFMT = FORMATS["QCIF"], JFORMATS["QCIF"]


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _valid_mvs(rng, fmt, streams, search=15):
    """Random (S, nMB, 2) (mvx, mvy) whose luma windows stay in the picture."""
    idx = np.arange(fmt.num_mbs)
    y0 = (idx // fmt.mb_cols) * 16
    x0 = (idx % fmt.mb_cols) * 16
    mv = rng.integers(-search, search + 1, (streams, fmt.num_mbs, 2))
    mv[..., 0] = np.clip(mv[..., 0], -x0, fmt.width - 16 - x0)
    mv[..., 1] = np.clip(mv[..., 1], -y0, fmt.height - 16 - y0)
    return mv.astype(np.int32)


def _ref_planes(rng, fmt, streams):
    return (rng.integers(0, 256, (streams, fmt.height, fmt.width)),
            rng.integers(0, 256, (streams, fmt.chroma_height,
                                  fmt.chroma_width)),
            rng.integers(0, 256, (streams, fmt.chroma_height,
                                  fmt.chroma_width)))


# ---------------------------------------------------------------- blocks


@pytest.mark.parametrize("name", ["QCIF", "CIF"], ids=["qcif", "cif"])
def test_blocks_layout_matches_jax(name):
    fmt, jfmt = FORMATS[name], JFORMATS[name]
    rng = np.random.default_rng(1)
    _eq(blocks.transmission_order(fmt), jblocks.transmission_order(jfmt))
    _eq(blocks.gob_of_mb(fmt), jblocks.gob_of_mb(jfmt))
    y = rng.integers(0, 256, (S, fmt.height, fmt.width)).astype(np.int32)
    cb = rng.integers(0, 256, (S, fmt.chroma_height,
                               fmt.chroma_width)).astype(np.int32)
    cr = rng.integers(0, 256, cb.shape).astype(np.int32)
    mbs = blocks.luma_to_mbs(_t(y))
    _eq(mbs, jblocks.luma_to_mbs(jnp.asarray(y)))
    _eq(blocks.mbs_to_luma(mbs, fmt.height, fmt.width), y)
    yb = blocks.mb_to_yblocks(mbs)
    _eq(yb, jblocks.mb_to_yblocks(jnp.asarray(mbs.numpy())))
    _eq(blocks.yblocks_to_mb(yb), mbs)
    cbb = blocks.chroma_to_blocks(_t(cb))
    _eq(cbb, jblocks.chroma_to_blocks(jnp.asarray(cb)))
    _eq(blocks.tiles_to_plane(cbb, fmt.chroma_height, fmt.chroma_width, 8),
        cb)
    _eq(blocks.plane_to_tiles(_t(y), 8), jblocks.plane_to_tiles(
        jnp.asarray(y), 8))
    _eq(blocks.assemble_mb_blocks(mbs, _t(cb), _t(cr)),
        jblocks.assemble_mb_blocks(jnp.asarray(mbs.numpy()), jnp.asarray(cb),
                                   jnp.asarray(cr)))
    sym = rng.integers(0, 99, (S, fmt.num_mbs, 6, 64))
    gob = blocks.to_gob_order(fmt, _t(sym))
    assert gob.shape == (S, fmt.num_gobs, 33, 6, 64)
    for i in range(S):
        _eq(gob[i], jblocks.to_gob_order(jfmt, jnp.asarray(sym[i])))
        _eq(gob[i].reshape(-1, 6, 64), sym[i][blocks.transmission_order(fmt)])
    _eq(blocks.from_gob_order(fmt, gob), sym)


# --------------------------------------------------------- predict, filter


def test_loop_filter_matches_jax():
    rng = np.random.default_rng(2)
    b = rng.integers(0, 256, (S, 50, 8, 8))
    b[0, 0] = 255
    b[0, 1] = np.where(np.indices((8, 8)).sum(0) % 2, 255, 0)
    _eq(tfilter.loop_filter8x8(_t(b)), jfilter.loop_filter8x8(jnp.asarray(b)))


def test_mc_predict_matches_jax_select_and_gather():
    rng = np.random.default_rng(3)
    ry, rcb, rcr = _ref_planes(rng, FMT, S)
    mv = _valid_mvs(rng, FMT, S)
    fil = rng.integers(0, 2, (S, FMT.num_mbs)).astype(bool)
    got = predict.mc_predict(_t(ry.astype(np.uint8)), _t(rcb.astype(np.uint8)),
                             _t(rcr.astype(np.uint8)), _t(mv), _t(fil), FMT)
    raw = predict.mc_predict(_t(ry.astype(np.uint8)), _t(rcb.astype(np.uint8)),
                             _t(rcr.astype(np.uint8)), _t(mv), None, FMT)
    for i in range(S):
        args = (jnp.asarray(ry[i], jnp.uint8), jnp.asarray(rcb[i], jnp.uint8),
                jnp.asarray(rcr[i], jnp.uint8), jnp.asarray(mv[i]))
        want_sel = jpred.mc_predict(*args, jnp.asarray(fil[i]), JFMT)
        want_gat = jpred.mc_predict_gather(*args, jnp.asarray(fil[i]), JFMT)
        want_raw = jpred.mc_predict(*args, None, JFMT)
        for k in range(3):
            assert got[k].dtype == torch.int32
            _eq(got[k][i], want_sel[k])
            _eq(got[k][i], want_gat[k])
            _eq(raw[k][i], want_raw[k])


def test_halve_mv_truncates_toward_zero():
    v = np.arange(-15, 16, dtype=np.int32)
    _eq(predict._halve_mv(_t(v)), jpred._halve_mv(jnp.asarray(v)))


# -------------------------------------------------------------- decisions


def test_decide_modes_matches_jax_incl_bright_mbs():
    rng = np.random.default_rng(4)
    n = FMT.num_mbs
    cur = rng.integers(0, 256, (S, n, 16, 16))
    # bright flat and bright noisy MBs: mean > 181, where a naive int32
    # square of the 16x16 sum wraps
    cur[:, :10] = 250
    cur[:, 10:20] = rng.integers(200, 256, (S, 10, 16, 16))
    pred0 = np.clip(cur + rng.integers(-20, 21, cur.shape), 0, 255)
    predmv = np.clip(cur + rng.integers(-3, 4, cur.shape), 0, 255)
    pred0[:, 20:40] = rng.integers(0, 256, (S, 20, 16, 16))
    sad0 = rng.integers(0, 6000, (S, n)).astype(np.int32)
    best = (sad0 * rng.uniform(0.5, 1.2, (S, n))).astype(np.int32)
    mv = rng.integers(-15, 16, (S, n, 2)).astype(np.int32)
    mv[:, ::7] = 0
    refresh = rng.integers(0, 140, (S, n)).astype(np.int32)
    force = np.asarray([False, True])
    cfgs = [(decisions.DecisionConfig(), jdec.DecisionConfig()),
            (decisions.DecisionConfig(filter_with_mc=False),
             jdec.DecisionConfig(filter_with_mc=False))]
    for tcfg, jcfg in cfgs:
        got = decisions.decide_modes(_t(cur), _t(pred0), _t(predmv), _t(sad0),
                                     _t(best), _t(mv), _t(refresh), _t(force),
                                     tcfg)
        for i in range(S):
            want = jdec.decide_modes(
                jnp.asarray(cur[i]), jnp.asarray(pred0[i]),
                jnp.asarray(predmv[i]), jnp.asarray(sad0[i]),
                jnp.asarray(best[i]), jnp.asarray(mv[i]),
                jnp.asarray(refresh[i]), jnp.asarray(force[i]), jcfg)
            for k in want:
                _eq(got[k][i], want[k])
    _eq(decisions.activity(_t(cur[:, :10])), np.zeros((S, 10)))


# ------------------------------------------------------------ dct, quant


def test_dct_constants_match_jax():
    _eq(dct.MI, jdct.MI)
    _eq(dct.MI2, jdct.MI2)
    _eq(dct.MI2_ZZ, jdct.MI2_ZZ)


def test_fdct_idct_match_jax_on_random_and_extreme_blocks():
    rng = np.random.default_rng(5)
    blk = rng.integers(-255, 256, (S, 40, 6, 8, 8))
    checker = np.where(np.indices((8, 8)).sum(0) % 2, 255, -255)
    blk[0, 0, 0] = 255
    blk[0, 0, 1] = -255
    blk[0, 0, 2] = checker
    blk[0, 0, 3] = -checker
    blk[1, 0, :] = rng.integers(0, 256, (6, 8, 8))
    _eq(dct.fdct8x8_zz(_t(blk)), jdct.fdct8x8_zz(jnp.asarray(blk)))
    _eq(dct.fdct8x8(_t(blk)), jdct.fdct8x8(jnp.asarray(blk)))
    coefs = rng.integers(-300, 301, (S, 40, 6, 8, 8))
    coefs[0, 0, 0] = 2047
    coefs[0, 0, 1] = -2048
    coefs[0, 0, 2] = np.where(np.indices((8, 8)).sum(0) % 2, 2047, -2048)
    coefs[1, :5] *= (rng.random((5, 6, 8, 8)) < 0.1)
    _eq(dct.idct8x8(_t(coefs)), jdct.idct8x8(jnp.asarray(coefs)))


def test_quant_matches_jax():
    rng = np.random.default_rng(6)
    coefs = rng.integers(-2047, 2048, (S, 30, 6, 64))
    coefs[:, :5] = rng.integers(-40, 41, (S, 5, 6, 64))
    q = rng.integers(1, 32, (S, 30, 1, 1))
    intra = rng.integers(0, 2, (S, 30, 1, 1)).astype(bool)
    lv = quant.quantize_zz(_t(coefs), _t(q), _t(intra))
    _eq(lv, jquant.quantize_zz(jnp.asarray(coefs), jnp.asarray(q),
                               jnp.asarray(intra)))
    _eq(quant.dequantize(lv, _t(q), _t(intra)),
        jquant.dequantize(jnp.asarray(lv.numpy()), jnp.asarray(q),
                          jnp.asarray(intra)))
    blk = rng.integers(-99, 99, (S, 3, 8, 8))
    _eq(quant.zigzag_scan(_t(blk)), jquant.zigzag_scan(jnp.asarray(blk)))
    _eq(quant.zigzag_unscan(quant.zigzag_scan(_t(blk))), blk)


# -------------------------------------------------------------- lengths


def _symbols(rng, lead):
    coded = rng.random(lead + (33,)) < 0.7
    mtype = rng.integers(0, 10, lead + (33,)).astype(np.int32)
    mv = rng.integers(-15, 16, lead + (33, 2)).astype(np.int32)
    cbp = rng.integers(1, 64, lead + (33,)).astype(np.int32)
    lv = rng.integers(-20, 21, lead + (33, 6, 64))
    lv *= rng.random(lv.shape) < 0.15
    lv[..., 0, 5] = 127          # escapes: |level| > 15, long runs
    lv[..., 1, 40] = -90
    lv[..., 2, 0] = 1            # inter first-coefficient short form
    lv[..., 3, :] = 0
    return coded, mtype, mv, cbp, lv.astype(np.int32)


def test_gob_payload_bits_match_jax():
    rng = np.random.default_rng(7)
    syms = _symbols(rng, (S, FMT.num_gobs))
    got = lengths.gob_payload_bits_per_mb(*map(_t, syms))
    tot = lengths.gob_payload_bits(*map(_t, syms))
    for i in range(S):
        js = [jnp.asarray(a[i]) for a in syms]
        _eq(got[i], jlen.gob_payload_bits_per_mb(*js))
        _eq(tot[i], jlen.gob_payload_bits(*js))
    intra = rng.integers(0, 2, (S, 3, 6)).astype(bool)
    _eq(lengths.block_bits(_t(syms[4][:, 0, :3]), _t(intra)),
        jlen.block_bits(jnp.asarray(syms[4][:, 0, :3]), jnp.asarray(intra)))
    d = np.arange(-31, 32, dtype=np.int32)
    _eq(lengths.wrap_mvd(_t(d)), jlen.wrap_mvd(jnp.asarray(d)))
    assert lengths.PICTURE_HEADER_BITS == jlen.PICTURE_HEADER_BITS
    assert lengths.GOB_HEADER_BITS == jlen.GOB_HEADER_BITS


# ---------------------------------------------------------- rate control


@pytest.mark.parametrize("fixed_quant", [0, 10, 40])
def test_ratecontrol_disabled_matches_jax(fixed_quant):
    tcfg = ratecontrol.RateConfig(fixed_quant=fixed_quant)
    jcfg = jrc.RateConfig(fixed_quant=fixed_quant)
    buf = np.asarray([0, 5, 70000, 2**30], np.int32)
    jb = jnp.asarray(buf)
    assert tcfg.target_bits_per_frame == jcfg.target_bits_per_frame
    _eq(ratecontrol.gob_quant(tcfg, _t(buf)),
        np.broadcast_to(jrc.gob_quant(jcfg, jb), buf.shape))
    _eq(ratecontrol.stuff_count(tcfg, _t(buf), 64),
        np.broadcast_to(jrc.stuff_count(jcfg, jb, 64), buf.shape))
    _eq(ratecontrol.drain_after_frame(tcfg, _t(buf[:3]), 64),
        jrc.drain_after_frame(jcfg, jb[:3], 64))
    _eq(ratecontrol.should_skip(tcfg, _t(buf)),
        np.broadcast_to(jrc.should_skip(jcfg, jb), buf.shape))
    _eq(ratecontrol.drain_skipped(tcfg, _t(buf)),
        jrc.drain_skipped(jcfg, jb))
    # the same config with rate control on follows the buffer law
    _eq(ratecontrol.gob_quant(ratecontrol.RateConfig(bit_rate=64000),
                              _t(buf)),
        jrc.gob_quant(jrc.RateConfig(bit_rate=64000), jb))


# ---------------------------------------------------------- reconstruct


def test_reconstruct_frame_matches_jax():
    rng = np.random.default_rng(8)
    n = FMT.num_mbs
    ry, rcb, rcr = (a.astype(np.uint8) for a in _ref_planes(rng, FMT, S))
    lv = rng.integers(-30, 31, (S, n, 6, 64)) * (rng.random((S, n, 6, 64))
                                                 < 0.1)
    intra = rng.random((S, n)) < 0.3
    lv[..., 0] = np.where(intra[..., None], rng.integers(1, 255, (S, n, 6)),
                          lv[..., 0])
    q = rng.integers(1, 32, (S, n)).astype(np.int32)
    mv = _valid_mvs(rng, FMT, S) * (~intra[..., None])
    fil = (rng.random((S, n)) < 0.5) & ~intra
    got = reconstruct.reconstruct_frame(
        FMT, _t(lv), _t(q), _t(intra), _t(mv), _t(fil), _t(ry), _t(rcb),
        _t(rcr))
    for i in range(S):
        want = jrec.reconstruct_frame(
            JFMT, jnp.asarray(lv[i]), jnp.asarray(q[i]), jnp.asarray(intra[i]),
            jnp.asarray(mv[i]), jnp.asarray(fil[i]), jnp.asarray(ry[i]),
            jnp.asarray(rcb[i]), jnp.asarray(rcr[i]))
        for k in range(3):
            assert got[k].dtype == torch.uint8
            _eq(got[k][i], want[k])
