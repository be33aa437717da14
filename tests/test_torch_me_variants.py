"""The port's plain SAD-map variants against the JAX package's Pallas
kernels (interpret mode, as tests/test_pallas.py runs them): kernel 1
(float32 pools), 3 (rows first), 4 (biased int8) and 5 (SWAR).  The plain
versions are what a CPU tensor runs and what the CUDA kernels are held
against on the card, so each must equal its TPU kernel exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from p64tpu.kernels import me_pallas
from p64tpu_torch.kernels import me, me_variants

torch.set_num_threads(1)

PALLAS = {
    "sad_map_f32": me_pallas.sad_map_pallas,
    "sad_map_rp": me_pallas.sad_map_pallas_rp,
    "sad_map_i8": me_pallas.sad_map_pallas_i8,
    "sad_map_swar": me_pallas.sad_map_pallas_swar,
}


def _random(seed, h, w):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (2, h, w)).astype(np.uint8),
            rng.integers(0, 256, (2, h, w)).astype(np.uint8))


def _near_identical(seed, h, w):
    # test_pallas.py's case: small residuals and a flat patch, many ties
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (2, h, w))
    base[:, 32:96, 32:128] = 77
    ref = np.clip(base + rng.integers(-2, 3, (2, h, w)), 0, 255)
    return base.astype(np.uint8), ref.astype(np.uint8)


def _check(name, cur, ref, s):
    _, plain = me_variants.VARIANTS[name]
    got = plain(torch.as_tensor(cur), torch.as_tensor(ref), s)
    h, w = cur.shape[1:]
    assert got.dtype == torch.int32
    assert tuple(got.shape) == (2, (2 * s + 1) ** 2, (h // 16) * (w // 16))
    # the dispatching entry point runs the plain version on a CPU tensor
    assert torch.equal(got, me_variants.VARIANTS[name][0](
        torch.as_tensor(cur), torch.as_tensor(ref), s))
    for i in range(2):
        want = np.asarray(PALLAS[name](jnp.asarray(cur[i], jnp.int32),
                                       jnp.asarray(ref[i], jnp.int32), s,
                                       interpret=True))
        np.testing.assert_array_equal(got[i].numpy(), want)


@pytest.mark.parametrize("name", sorted(PALLAS))
@pytest.mark.parametrize("h,w,s", [(48, 64, 4), (144, 176, 7)])
def test_plain_variant_matches_pallas_on_random_planes(name, h, w, s):
    _check(name, *_random(h + w + s, h, w), s)


@pytest.mark.parametrize("name", sorted(PALLAS))
def test_plain_variant_matches_pallas_on_near_identical_planes(name):
    _check(name, *_near_identical(5, 144, 176), 7)


@pytest.mark.parametrize("name", sorted(PALLAS))
def test_plain_variant_at_full_search_range(name):
    # search 15 at QCIF: every MB has out-of-picture offsets
    cur, ref = _random(3, 144, 176)
    _, plain = me_variants.VARIANTS[name]
    ct, rt = torch.as_tensor(cur), torch.as_tensor(ref)
    assert torch.equal(plain(ct, rt, 15), me.sad_map(ct, rt, 15))


def test_pack4_matches_pallas():
    rng = np.random.default_rng(2)
    x = rng.integers(0, 256, (3, 16, 48))
    x[0, :, 3::4] = 255                  # byte 3 >= 128: negative int32
    got = me_variants.pack4(torch.as_tensor(x))
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 16, 12)
    for i in range(3):
        np.testing.assert_array_equal(
            got[i].numpy(),
            np.asarray(me_pallas._pack4(jnp.asarray(x[i], jnp.int32))))


def test_pair_absdiff_every_byte_pair():
    # all 256 x 256 (u, v) in both 16-bit fields of a word
    u, v = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    u, v = u.ravel(), v.ravel()
    a = torch.as_tensor(u | (v << 16), dtype=torch.int64)
    b = torch.as_tensor(v | (u << 16), dtype=torch.int64)
    got = me_variants.pair_absdiff(a, b).numpy()
    d = np.abs(u - v)
    np.testing.assert_array_equal(got & 0xFFFF, d)
    np.testing.assert_array_equal(got >> 16, d)
