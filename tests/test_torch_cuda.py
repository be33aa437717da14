"""The SAD-search CUDA kernel against its plain torch version, on the card.

These tests need a CUDA card and skip without one.  They import no JAX, so
they also run on a GPU host without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from p64tpu_torch.kernels import me, me_cuda

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _planes(seed, shape, device):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.integers(0, 256, shape).astype(np.uint8),
                            device=device),
            torch.as_tensor(rng.integers(0, 256, shape).astype(np.uint8),
                            device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,search", [((2, 48, 64), 4),
                                          ((2, 144, 176), 7),
                                          ((3, 288, 352), 15)])
def test_kernel_map_and_search_equal_plain(cuda, shape, search):
    cur, ref = _planes(sum(shape) + search, shape, cuda)
    mv, best, sad0, sads = me_cuda.sad_search_cuda(cur, ref, search,
                                                   with_map=True)
    torch.cuda.synchronize()
    plain = me.sad_map(cur, ref, search)
    assert torch.equal(sads, plain)
    for got, want in zip((mv, best, sad0), me.search_from_map(plain, search)):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_full_search_on_cuda_launches_the_kernel(cuda):
    cur, ref = _planes(3, (2, 144, 176), cuda)
    before = me_cuda.LAUNCHES
    got = me.full_search(cur, ref, 15)
    torch.cuda.synchronize()
    assert me_cuda.LAUNCHES == before + 1
    for a, b in zip(got, me.search_from_map(me.sad_map(cur, ref, 15), 15)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    cur, ref = _planes(4, (1, 48, 64), cuda)
    with pytest.raises(ValueError, match="uint8"):
        me_cuda.sad_search_cuda(cur.int(), ref.int(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        me_cuda.sad_search_cuda(cur.transpose(1, 2), ref.transpose(1, 2), 4)
    with pytest.raises(ValueError, match="search"):
        me_cuda.sad_search_cuda(cur, ref, 16)
