"""Motion search of the PyTorch port against the JAX package.

The port's plain torch SAD map and full search (what a CPU tensor runs and
what the CUDA kernel is held against on the card) must equal the JAX
reference and its Pallas kernel (interpret mode) exactly, tie-breaks
included.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from p64tpu.kernels import me as jme
from p64tpu.kernels import me_pallas
from p64tpu_torch.kernels import me

torch.set_num_threads(1)


def _planes(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, shape).astype(np.uint8),
            rng.integers(0, 256, shape).astype(np.uint8))


@pytest.mark.parametrize("h,w,s", [(48, 64, 4), (144, 176, 7)])
def test_sad_map_matches_jax(h, w, s):
    cur, ref = _planes(h + s, (2, h, w))
    got = me.sad_map(torch.as_tensor(cur), torch.as_tensor(ref), s).numpy()
    assert got.shape == (2, (2 * s + 1) ** 2, (h // 16) * (w // 16))
    for i in range(2):
        c, r = jnp.asarray(cur[i], jnp.int32), jnp.asarray(ref[i], jnp.int32)
        np.testing.assert_array_equal(got[i], np.asarray(jme.sad_map(c, r, s)))
        np.testing.assert_array_equal(got[i], np.asarray(
            me_pallas.sad_map_pallas_bf16(c, r, s, interpret=True)))


def test_full_search_tiebreak_matches_pallas():
    # flat patch and a shifted copy: many offsets tie, the first minimum in
    # dy-major order must win (test_pallas.py's tie case, two streams)
    h, w, s = 48, 64, 4
    rng = np.random.default_rng(5)
    cur, ref = [], []
    for shift in (2, -3):
        base = rng.integers(0, 256, (h, w))
        base[16:32, 16:48] = 128
        cur.append(base)
        ref.append(np.roll(base, shift, axis=1))
    cur = np.stack(cur).astype(np.uint8)
    ref = np.stack(ref).astype(np.uint8)
    mv, best, sad0 = me.full_search(torch.as_tensor(cur), torch.as_tensor(ref),
                                    s)
    for i in range(2):
        mv_j, best_j, sad0_j = me_pallas.full_search_pallas(
            jnp.asarray(cur[i], jnp.int32), jnp.asarray(ref[i], jnp.int32), s,
            interpret=True)
        np.testing.assert_array_equal(mv[i].numpy(), np.asarray(mv_j))
        np.testing.assert_array_equal(best[i].numpy(), np.asarray(best_j))
        np.testing.assert_array_equal(sad0[i].numpy(), np.asarray(sad0_j))


def test_full_search_periodic_ties_match_jax():
    # every 8-pel shift of the periodic texture is an exact tie
    h, w, s = 144, 176, 15
    yy, xx = np.mgrid[0:h, 0:w]
    per = ((xx % 8 < 4) ^ (yy % 8 < 4)).astype(np.uint8) * 180 + 40
    cur = np.stack([np.roll(per, 1, axis=1), np.roll(per, 3, axis=0)])
    ref = np.stack([per, per])
    mv, best, sad0 = me.full_search(torch.as_tensor(cur), torch.as_tensor(ref),
                                    s)
    assert mv.dtype == best.dtype == sad0.dtype == torch.int32
    for i in range(2):
        mv_j, best_j, sad0_j = jme.full_search(jnp.asarray(cur[i]),
                                               jnp.asarray(ref[i]), s)
        np.testing.assert_array_equal(mv[i].numpy(), np.asarray(mv_j))
        np.testing.assert_array_equal(best[i].numpy(), np.asarray(best_j))
        np.testing.assert_array_equal(sad0[i].numpy(), np.asarray(sad0_j))


def test_offset_table_and_zero_index_match_jax():
    for s in (0, 4, 15):
        np.testing.assert_array_equal(me.offset_table(s), jme.offset_table(s))
        assert me.zero_offset_index(s) == jme.zero_offset_index(s)
