"""The port's public helpers outside the encoder's path, against the JAX
package: the picture bit model from raster-order arrays
(`entropy.lengths.frame_bits`, `to_transmission`) equal to JAX's and to the
port's serializer count; `kernels.quant.quantize` (natural order) equal to
JAX's and to quantize_zz of the zigzag scan, with the quantizer's laws;
`np_dequantize` equal to `dequantize`; the float64 DCT oracles equal to
JAX's, and the port's integer IDCT held to them by the IEEE-1180 test."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from helpers import random_frame_symbols
from p64tpu.entropy import lengths as jlengths
from p64tpu.kernels import dct as jdct
from p64tpu.kernels import quant as jquant
from p64tpu.spec import constants as jconstants
from p64tpu_torch.entropy import encode as tenc
from p64tpu_torch.entropy import lengths
from p64tpu_torch.entropy.bitio import BitWriter
from p64tpu_torch.kernels import dct, quant
from p64tpu_torch.spec import constants

torch.set_num_threads(1)

#: tests/test_entropy.py's cases of the bit model: (format, seed, MQUANT
#: share)
BIT_CASES = [("QCIF", 3, 0.0), ("CIF", 4, 0.0), ("QCIF", 7, 0.3)]
SYMBOL_KEYS = ("coded", "mtype", "mv", "cbp", "levels")


def _symbols(fmt_name, seed, p_mquant):
    """(JAX FrameSymbols, the port's FrameSymbols of the same fields)."""
    sym = random_frame_symbols(getattr(jconstants, fmt_name),
                               np.random.default_rng(seed),
                               p_mquant=p_mquant)
    names = [f.name for f in dataclasses.fields(tenc.FrameSymbols)]
    return sym, tenc.FrameSymbols(**{n: getattr(sym, n) for n in names})


def _arrays(sym, wrap):
    return [wrap(np.asarray(getattr(sym, k), np.int32 if k == "levels"
                            else None)) for k in SYMBOL_KEYS]


def _port_count(fmt, sym):
    sink = BitWriter()
    tenc.serialize_frame(fmt, sym, sink)
    return sink.nbits


@pytest.mark.parametrize("fmt_name,seed,p_mquant", BIT_CASES)
def test_frame_bits_equal_jax_and_the_serializer(fmt_name, seed, p_mquant):
    jsym, sym = _symbols(fmt_name, seed, p_mquant)
    fmt, jfmt = getattr(constants, fmt_name), getattr(jconstants, fmt_name)
    total, gob_bits = lengths.frame_bits(fmt, *_arrays(sym, torch.as_tensor))
    jtotal, jgob_bits = jlengths.frame_bits(jfmt, *_arrays(jsym, jnp.asarray))
    assert total.dtype == gob_bits.dtype == torch.int32
    assert total.shape == () and gob_bits.shape == (fmt.num_gobs,)
    np.testing.assert_array_equal(gob_bits.numpy(), np.asarray(jgob_bits))
    nbits = _port_count(fmt, sym)
    assert int(total) == int(jtotal) == nbits
    assert int(gob_bits.sum()) + lengths.PICTURE_HEADER_BITS == nbits


@pytest.mark.parametrize("fmt_name,seed,p_mquant", BIT_CASES)
def test_to_transmission_equals_jax(fmt_name, seed, p_mquant):
    jsym, sym = _symbols(fmt_name, seed, p_mquant)
    got = lengths.to_transmission(getattr(constants, fmt_name),
                                  *_arrays(sym, torch.as_tensor))
    want = jlengths.to_transmission(getattr(jconstants, fmt_name),
                                    *_arrays(jsym, jnp.asarray))
    for k, g, w in zip(SYMBOL_KEYS, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=k)


@pytest.mark.parametrize("lead", [(3,), (2, 2)], ids=["3", "2x2"])
def test_frame_bits_over_leading_axes(lead):
    """Pictures stacked on leading axes cost what each costs alone."""
    fmt = constants.QCIF
    syms = [_symbols("QCIF", 20 + i, 0.2)[1]
            for i in range(int(np.prod(lead)))]
    stacked = [torch.as_tensor(np.stack(a)).reshape(*lead, *a[0].shape)
               for a in zip(*(_arrays(s, np.asarray) for s in syms))]
    total, gob_bits = lengths.frame_bits(fmt, *stacked)
    assert total.shape == lead and gob_bits.shape == (*lead, fmt.num_gobs)
    assert total.reshape(-1).tolist() == [_port_count(fmt, s) for s in syms]


# ---------------------------------------------------------------------------
# quantize, np_dequantize
# ---------------------------------------------------------------------------


def _coefs(seed, n=400):
    rng = np.random.default_rng(seed)
    c = rng.integers(-2047, 2048, (n, 8, 8)) // rng.integers(1, 64, (n, 1, 1))
    q = rng.integers(1, 32, (n, 1, 1)).astype(np.int32)
    return c.astype(np.int32), q, rng.random((n, 1, 1)) < 0.3


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_equals_jax_and_quantize_zz(seed):
    c, q, intra = _coefs(seed)
    got = quant.quantize(torch.as_tensor(c), torch.as_tensor(q),
                         torch.as_tensor(intra))
    assert got.dtype == torch.int32 and got.shape == (len(c), 64)
    want = jquant.quantize(jnp.asarray(c), jnp.asarray(q), jnp.asarray(intra))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    zz = quant.quantize_zz(quant.zigzag_scan(torch.as_tensor(c)),
                           torch.as_tensor(q[..., 0]),
                           torch.as_tensor(intra[..., 0]))
    assert torch.equal(got, zz)


def _lv(c88, q, intra=False):
    return quant.quantize(c88, torch.tensor(q), torch.tensor(intra))


@pytest.mark.parametrize("law", ["dead_zone_and_parity", "intra_dc",
                                 "level_clamp"])
def test_quantize_laws(law):
    """tests/test_kernels.py's quantizer laws on the port's quantize and
    dequantize."""
    if law == "dead_zone_and_parity":
        q = 7                                                   # odd
        c = torch.as_tensor(np.arange(-300, 301).reshape(-1, 1)
                            * np.ones((1, 64), np.int64)).to(torch.int32)
        c88 = quant.zigzag_unscan(c)
        lv = _lv(c88, q)
        flat = quant.zigzag_unscan(lv).reshape(-1, 64)
        assert (flat[c88.reshape(-1, 64).abs() < 2 * q] == 0).all()
        rec = quant.dequantize(lv, torch.tensor(q), torch.tensor(False))
        lvl = quant.zigzag_unscan(lv)
        pos, neg = lvl > 0, lvl < 0
        assert torch.equal(rec[pos], q * (2 * lvl[pos] + 1))
        assert torch.equal(rec[neg], q * (2 * lvl[neg] - 1))
        q2 = 8                                  # even: one closer to zero
        lv2 = _lv(c88, q2)
        rec2 = quant.dequantize(lv2, torch.tensor(q2), torch.tensor(False))
        lvl2 = quant.zigzag_unscan(lv2)
        pos = lvl2 > 0
        assert torch.equal(rec2[pos], q2 * (2 * lvl2[pos] + 1) - 1)
    elif law == "intra_dc":
        c = torch.zeros((5, 8, 8), dtype=torch.int32)
        c[:, 0, 0] = torch.tensor([0, 5, 1020, 2040, 4])
        lv = _lv(c, 10, True)
        # (dc + 4) >> 3 clamped to 1..254
        assert lv[:, 0].tolist() == [1, 1, 128, 254, 1]
        rec = quant.dequantize(lv, torch.tensor(10), torch.tensor(True))
        assert rec[:, 0, 0].tolist() == [8, 8, 1024, 2032, 8]
    else:
        c = torch.zeros((1, 8, 8), dtype=torch.int32)
        c[0, 3, 3] = 2047
        assert _lv(c, 1).abs().max() == 127


@pytest.mark.parametrize("seed", [0, 1])
def test_np_dequantize_equals_dequantize_and_jax(seed):
    rng = np.random.default_rng(100 + seed)
    n = 500
    lv = np.where(rng.random((n, 64)) < 0.3,
                  rng.integers(-127, 128, (n, 64)), 0)
    intra = rng.random((n, 1)) < 0.3
    lv[:, 0] = np.where(intra[:, 0], rng.integers(1, 255, n), lv[:, 0])
    q = rng.integers(1, 32, (n, 1))
    got = quant.np_dequantize(lv, q, intra[:, 0])
    assert got.dtype == np.int32 and got.shape == (n, 8, 8)
    want = quant.dequantize(torch.as_tensor(lv), torch.as_tensor(q),
                            torch.as_tensor(intra))
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(got,
                                  jquant.np_dequantize(lv, q, intra[:, 0]))


# ---------------------------------------------------------------------------
# the float64 DCT oracles, and the integer transforms held to them
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["reference_fdct", "reference_idct"])
def test_dct_oracles_equal_jax(which):
    x = np.random.default_rng(7).integers(-2048, 2048, (64, 8, 8))
    got = getattr(dct, which)(x)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, getattr(jdct, which)(x), rtol=0,
                               atol=1e-9)
    back = dct.reference_idct(dct.reference_fdct(x))
    np.testing.assert_allclose(back, x, rtol=0, atol=1e-9)


@pytest.mark.parametrize("which", ["fdct", "idct"])
def test_integer_transforms_close_to_the_oracle(which):
    """tests/test_kernels.py's bounds: forward within 1.5, inverse within 2
    and 0.5 on average."""
    rng = np.random.default_rng(0)
    if which == "fdct":
        x = rng.integers(-255, 256, (512, 8, 8))
        err = np.abs(dct.fdct8x8(torch.as_tensor(x)).numpy()
                     - dct.reference_fdct(x))
        assert err.max() <= 1.5, err.max()
    else:
        c = rng.integers(-2048, 2048, (512, 8, 8))
        err = np.abs(dct.idct8x8(torch.as_tensor(c)).numpy()
                     - dct.reference_idct(c))
        assert err.max() <= 2.0, err.max()
        assert err.mean() < 0.5


@pytest.mark.parametrize("sign", [1, -1])
@pytest.mark.parametrize("lo,hi", [(256, 255), (5, 5), (300, 300)])
def test_idct_ieee1180_conformance(lo, hi, sign):
    """IEEE Std 1180-1990 statistical accuracy of the port's inverse DCT,
    as tests/test_kernels.py runs it on the JAX package's: random blocks in
    [-lo, hi], forward float64 DCT -> rounded, clamped coefficients ->
    integer IDCT against the rounded float64 oracle.  Bounds: ppe <= 1,
    pmse <= 0.06, omse <= 0.02, pme <= 0.015, ome <= 0.0015."""
    rng = np.random.default_rng(1180 + lo + sign)
    f = rng.integers(-lo, hi + 1, (10000, 8, 8)).astype(np.int64) * sign
    coefs = np.round(dct.reference_fdct(f)).clip(-2048, 2047)
    ref = np.round(dct.reference_idct(coefs)).clip(-256, 255)
    got = dct.idct8x8(torch.as_tensor(coefs.astype(np.int32))).numpy()
    e = (got.clip(-256, 255) - ref).astype(np.float64)
    assert np.abs(e).max() <= 1                         # ppe
    assert (e ** 2).mean(axis=0).max() <= 0.06          # pmse
    assert (e ** 2).mean() <= 0.02                      # omse
    assert np.abs(e.mean(axis=0)).max() <= 0.015        # pme
    assert abs(e.mean()) <= 0.0015                      # ome


def test_idct_zero_in_zero_out():
    assert not dct.idct8x8(torch.zeros((4, 8, 8), dtype=torch.int32)).any()
    assert not dct.fdct8x8(torch.zeros((4, 8, 8), dtype=torch.int32)).any()
