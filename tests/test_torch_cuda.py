"""The CUDA kernels against their plain torch versions, on the card: the
SAD-search kernel and the four SAD-map kernels; and the decoder on the
card against its CPU decode and the encoder's reconstruction.

These tests need a CUDA card and skip without one.  They import no JAX, so
they also run on a GPU host without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from p64tpu.tools import golden_content as gc
from p64tpu_torch.core import decoder, encoder
from p64tpu_torch.kernels import me, me_cuda, me_variants, me_variants_cuda
from p64tpu_torch.tools import pinned

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


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(me_variants.VARIANTS))
@pytest.mark.parametrize("shape,search", [((2, 48, 64), 4),
                                          ((2, 144, 176), 15),
                                          ((3, 288, 352), 15)])
def test_map_kernel_equals_plain(cuda, name, shape, search):
    cur, ref = _planes(sum(shape) + search, shape, cuda)
    kernel, plain = me_variants.VARIANTS[name]
    before = me_variants_cuda.LAUNCHES[name]
    got = kernel(cur, ref, search)
    torch.cuda.synchronize()
    assert me_variants_cuda.LAUNCHES[name] == before + 1
    want = plain(cur, ref, search)
    assert torch.equal(want, me.sad_map(cur, ref, search))
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(me_variants.VARIANTS))
def test_map_kernel_on_near_identical_planes(cuda, name):
    # small residuals and a flat patch: many ties, every odd dx
    rng = np.random.default_rng(9)
    base = rng.integers(0, 256, (2, 144, 176))
    base[:, 32:96, 32:128] = 77
    ref = np.clip(base + rng.integers(-2, 3, base.shape), 0, 255)
    cur_t = torch.as_tensor(base.astype(np.uint8), device=cuda)
    ref_t = torch.as_tensor(ref.astype(np.uint8), device=cuda)
    kernel, plain = me_variants.VARIANTS[name]
    assert torch.equal(kernel(cur_t, ref_t, 15), plain(cur_t, ref_t, 15))


@pytest.mark.cuda
def test_map_kernels_refuse_what_they_do_not_take(cuda):
    cur, ref = _planes(4, (1, 48, 64), cuda)
    with pytest.raises(ValueError, match="uint8"):
        me_variants_cuda.sad_map_i8_cuda(cur.int(), ref.int(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        me_variants_cuda.sad_map_swar_cuda(cur.transpose(1, 2),
                                           ref.transpose(1, 2), 4)
    with pytest.raises(ValueError, match="search"):
        me_variants_cuda.sad_map_f32_cuda(cur, ref, 16)
    wide = torch.zeros((1, 16, 368), dtype=torch.uint8, device=cuda)
    with pytest.raises(RuntimeError, match="sad_map_rp kernel launch failed"):
        me_variants_cuda.sad_map_rp_cuda(wide, wide, 4)


@pytest.mark.cuda
def test_pin_decodes_on_the_card_as_on_the_cpu(cuda):
    cfg, frames = pinned.pinned_case("config2_qcif_inter_q12_s15")
    data = encoder.encode_to_bytes(cfg, frames, device=cuda)[0][0]
    on_card = decoder.decode_stream(data, device=cuda)
    on_cpu = decoder.decode_stream(data, device="cpu")
    for a, b in zip(on_card[:3], on_cpu[:3]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_decode_seq_batch_on_the_card_equals_encoder_recon(cuda):
    from p64tpu.spec.constants import CIF
    from p64tpu_torch.control.ratecontrol import RateConfig

    one = gc.config3_cif_rc(3)
    frames = {k: np.stack([v, np.roll(v, 5, axis=-1)]) for k, v in
              one.items()}
    cfg = encoder.EncoderConfig(fmt=CIF, search=15,
                                rate=RateConfig(fixed_quant=10))
    datas, out, _ = encoder.encode_to_bytes(cfg, frames, device=cuda)
    seqs = [decoder.parse_to_tensors(d)[2] for d in datas]
    for i, planes in enumerate(decoder.decode_seq_batch(CIF, seqs,
                                                        device=cuda)):
        for got, key in zip(planes, encoder.RECON_KEYS):
            np.testing.assert_array_equal(got, out[key][i].cpu().numpy())
