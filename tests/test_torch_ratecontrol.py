"""Rate control of the PyTorch port against the JAX package: the buffer law,
stuffing fill and frame skip on a grid of buffers that covers an empty
buffer, each quantizer step, the skip threshold +/- 1 and stuffing
deficits, for every stream at once."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from p64tpu.control import ratecontrol as jrc
from p64tpu_torch.control import ratecontrol as rc
from p64tpu_torch.entropy import lengths

CONFIGS = {
    "rc64k": dict(bit_rate=64000),
    "rc192k_30fps": dict(bit_rate=192_000, frame_rate=30),
    "rc768k": dict(bit_rate=768_000),
    "rc1M_mquant3": dict(bit_rate=1_024_000, frame_rate=30,
                         mquant_segments=3),
    "rc128k_25fps_qoffs3_nofill": dict(bit_rate=128_000, frame_rate=25,
                                       qoffs=3, min_rate_fill=False),
    "rc48k_skip2_iq20": dict(bit_rate=48_000, skip_threshold_x=2,
                             initial_quant=20),
    "tiny_rate": dict(bit_rate=20, frame_rate=30),
    "fixed_q": dict(fixed_quant=12),
}


def _buffers(cfg: jrc.RateConfig) -> np.ndarray:
    """0, each quantizer step +/- 1, the skip threshold +/- 1, and buffers
    that leave a stuffing deficit after the picture header and drain."""
    target = cfg.target_bits_per_frame
    thr = cfg.skip_threshold_x * target
    hdr = lengths.PICTURE_HEADER_BITS
    steps = np.arange(0, 34) * cfg.qdfact
    deficits = np.clip(target - hdr - np.arange(0, 40), 0, None)
    grid = np.concatenate([[0, 1, 2, thr - 1, thr, thr + 1, 10 * thr,
                            2 ** 30], steps, steps + 1,
                           np.clip(steps - 1, 0, None), deficits])
    return np.unique(grid).astype(np.int32)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_buffer_law_matches_jax(name):
    tcfg = rc.RateConfig(**CONFIGS[name])
    jcfg = jrc.RateConfig(**CONFIGS[name])
    buf = _buffers(jcfg)
    tb, jb = torch.as_tensor(buf), jnp.asarray(buf)
    hdr = lengths.PICTURE_HEADER_BITS
    assert tcfg.enabled == jcfg.enabled
    assert tcfg.initial_buffer() == jcfg.initial_buffer()
    assert tcfg.target_bits_per_frame == jcfg.target_bits_per_frame
    assert tcfg.qdfact == jcfg.qdfact
    for got, want in (
            (rc.gob_quant(tcfg, tb), jrc.gob_quant(jcfg, jb)),
            (rc.stuff_count(tcfg, tb, hdr), jrc.stuff_count(jcfg, jb, hdr)),
            (rc.drain_after_frame(tcfg, tb, hdr),
             jrc.drain_after_frame(jcfg, jb, hdr)),
            (rc.should_skip(tcfg, tb), jrc.should_skip(jcfg, jb)),
            (rc.drain_skipped(tcfg, tb), jrc.drain_skipped(jcfg, jb))):
        want = np.broadcast_to(np.asarray(want), buf.shape)
        assert got.shape == buf.shape
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["rc64k", "rc192k_30fps", "rc48k_skip2_iq20"])
def test_grid_reaches_skip_and_stuffing(name):
    # the grid is only a test of the edges if it reaches them
    cfg = rc.RateConfig(**CONFIGS[name])
    tb = torch.as_tensor(_buffers(jrc.RateConfig(**CONFIGS[name])))
    skip = rc.should_skip(cfg, tb)
    assert skip.any() and not skip.all()
    assert (rc.stuff_count(cfg, tb, lengths.PICTURE_HEADER_BITS) > 0).any()
    assert set(rc.gob_quant(cfg, tb).tolist()) >= {1, 31}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_dividends_are_nonnegative_so_floor_is_trunc(name):
    # torch // floors; the reference's law is stated on non-negative
    # buffers and deficits, where floor and truncation agree.  Hold the
    # port to the Python-integer law computed both ways.
    cfg = rc.RateConfig(**CONFIGS[name])
    buf = _buffers(jrc.RateConfig(**CONFIGS[name]))
    assert (buf >= 0).all()
    hdr = lengths.PICTURE_HEADER_BITS
    q = rc.gob_quant(cfg, torch.as_tensor(buf)).tolist()
    n = rc.stuff_count(cfg, torch.as_tensor(buf), hdr).tolist()
    for b, qi, ni in zip(buf.tolist(), q, n):
        if cfg.enabled:
            assert qi == min(max(int(b / cfg.qdfact) + cfg.qoffs, 1), 31)
            deficit = max(cfg.target_bits_per_frame - hdr - b, 0)
            assert deficit >= 0
            want = -(-deficit // rc.STUFF_BITS) if cfg.min_rate_fill else 0
            assert ni == want
        else:
            assert qi == cfg.fixed_quant and ni == 0
