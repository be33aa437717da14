"""The CUDA kernels against their plain torch versions, on the card: the
SAD-search kernel and the four SAD-map kernels; the decoder on the card
against its CPU decode and the encoder's reconstruction; the batch
encoder, the stream mesh, checkpoints and the profiler on the card.

These tests need a CUDA card and skip without one.  They import no JAX, so
they also run on a GPU host without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from p64tpu_torch.core import decoder, encoder
from p64tpu_torch.kernels import me, me_cuda, me_variants, me_variants_cuda
from p64tpu_torch.spec.constants import CIF, QCIF
from p64tpu_torch.tools import golden_content as gc
from p64tpu_torch.tools import pinned

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _planes(seed, shape, device, kind="random"):
    """Random planes, or "near": random current planes and references
    within +-2 of them, with a flat patch of 77 -- many tied SADs."""
    rng = np.random.default_rng(seed)
    cur = rng.integers(0, 256, shape)
    if kind == "near":
        _, h, w = shape
        cur[:, h // 4:h - h // 4, w // 4:w - w // 4] = 77
        ref = np.clip(cur + rng.integers(-2, 3, shape), 0, 255)
    else:
        ref = rng.integers(0, 256, shape)
    return (torch.as_tensor(cur.astype(np.uint8), device=device),
            torch.as_tensor(ref.astype(np.uint8), device=device))


#: one MB row, a small picture, QCIF and CIF (ragged last MB tiles)
SHAPES = [(2, 16, 64), (2, 48, 64), (2, 144, 176), (3, 288, 352)]
SEARCHES = [0, 1, 4, 7, 15]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "near"])
@pytest.mark.parametrize("search", SEARCHES)
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_map_and_search_equal_plain(cuda, shape, search, kind):
    cur, ref = _planes(sum(shape) + search, shape, cuda, kind)
    mv, best, sad0, sads = me_cuda.sad_search_cuda(cur, ref, search,
                                                   with_map=True)
    fused = me_cuda.sad_search_cuda(cur, ref, search)
    torch.cuda.synchronize()
    plain = me.sad_map(cur, ref, search)
    assert torch.equal(sads, plain)
    for got, got_fused, want in zip((mv, best, sad0), fused,
                                    me.search_from_map(plain, search)):
        assert torch.equal(got, want)
        assert torch.equal(got_fused, want)


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
    # the search stages with cp.async: 16-byte aligned planes only
    flat = torch.zeros(48 * 64 + 4, dtype=torch.uint8, device=cuda)
    off = flat[4:].view(1, 48, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        me_cuda.sad_search_cuda(off, off, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(me_variants.VARIANTS))
@pytest.mark.parametrize("search", SEARCHES)
@pytest.mark.parametrize("shape", SHAPES)
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
    # every map kernel stages with cp.async: 16-byte aligned planes only
    flat = torch.zeros(48 * 64 + 4, dtype=torch.uint8, device=cuda)
    off = flat[4:].view(1, 48, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        me_variants_cuda.sad_map_i8_cuda(off, off, 4)
    wide = torch.zeros((1, 16, 368), dtype=torch.uint8, device=cuda)
    with pytest.raises(RuntimeError, match="sad_map_rp kernel launch failed"):
        me_variants_cuda.sad_map_rp_cuda(wide, wide, 4)


#: the wrapper's geometry of each tiled map kernel
TILES = {"sad_map_f32": me_variants_cuda.map_tiles,
         "sad_map_swar": me_variants_cuda.map_tiles,
         "sad_map_i8": me_variants_cuda.i8_tiles}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sad_map_f32", "sad_map_swar",
                                  "sad_map_i8"])
def test_tiled_map_kernels_refuse_a_geometry_they_do_not_take(cuda, name):
    """K1, K4 and K5 take their geometry from the wrapper; one that leaves
    a tile empty, misses dy or exceeds the block's threads or shared
    memory fails the launch."""
    cur, ref = _planes(4, (1, 48, 64), cuda)
    out = torch.empty((1, 81, 12), dtype=torch.int32, device=cuda)
    good = TILES[name](48, 64, 4)
    me_cuda.declare_map(name, len(good.args()))
    me_cuda.launch(name, cuda, cur.data_ptr(), ref.data_ptr(), 1, 48, 64, 4,
                   *good.args(), out.data_ptr())
    torch.cuda.synchronize()
    assert torch.equal(out, me.sad_map(cur, ref, 4))
    big = TILES[name](288, 352, 15)
    for bad in (dataclasses.replace(good, tiles_per_row=2),
                dataclasses.replace(good, n_dyt=1),
                dataclasses.replace(good, g_lo=good.g_lo + 1),
                dataclasses.replace(big, mb_tile=big.mb_tile + 1,
                                    tiles_per_row=1)):
        search = 15 if bad.n_dxg == big.n_dxg else 4
        with pytest.raises(RuntimeError, match=f"{name} kernel launch failed"):
            me_cuda.launch(name, cuda, cur.data_ptr(), ref.data_ptr(), 1, 48,
                           64, search, *bad.args(), out.data_ptr())


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


def _qcif_batch(n_streams, t):
    one = gc.config2_qcif_inter()
    return {k: np.stack([np.roll(v[:t], 7 * i, axis=-1)
                         for i in range(n_streams)]) for k, v in one.items()}


@pytest.mark.cuda
def test_pipelined_batch_encode_on_the_card_equals_one_dispatch(cuda):
    from p64tpu_torch.control.ratecontrol import RateConfig
    from p64tpu_torch.distrib import mesh as dm
    from p64tpu_torch.tools import batch_encode

    batch = _qcif_batch(5, 3)
    cfg = encoder.EncoderConfig(fmt=QCIF, search=15, emit_recon=False,
                                rate=RateConfig(fixed_quant=10))
    want = encoder.encode_to_bytes(cfg, batch, device="cpu")[0]
    card = dm.make_mesh(devices=[cuda])
    before = me_cuda.LAUNCHES
    one = batch_encode.encode_resilient(cfg, batch, card)
    assert me_cuda.LAUNCHES - before == 3
    chunked = batch_encode.encode_resilient(cfg, batch, card, chunk=2)
    assert [b for b, _ in one] == [b for b, _ in chunked] == want
    # two logical shards on the one card give the same bytes
    two = dm.make_mesh(devices=[cuda, cuda])
    assert batch_encode.encode_resilient(cfg, batch, two, chunk=3) == one


@pytest.mark.cuda
def test_outputs_to_host_copies_behind_an_event(cuda):
    from p64tpu_torch.control.ratecontrol import RateConfig

    cfg = encoder.EncoderConfig(fmt=QCIF, search=7,
                                rate=RateConfig(fixed_quant=12))
    _, out = encoder.encode_sequence(cfg, _qcif_batch(2, 2), device=cuda)
    host, event = encoder.outputs_to_host(out)
    assert event is not None
    event.synchronize()
    assert sorted(host) == sorted(encoder.SYMBOL_KEYS)
    for k, v in host.items():
        assert v.device.type == "cpu" and v.is_pinned()
        assert torch.equal(v, out[k].cpu()), k


@pytest.mark.cuda
def test_checkpoint_resumes_on_the_card(cuda, tmp_path):
    from p64tpu_torch.control.ratecontrol import RateConfig
    from p64tpu_torch.io import checkpoint

    cfg = encoder.EncoderConfig(fmt=QCIF, search=15,
                                rate=RateConfig(bit_rate=192_000))
    batch = _qcif_batch(2, 4)
    _, full = encoder.encode_sequence(cfg, batch, device=cuda)
    st, _ = encoder.encode_sequence(cfg, {k: v[:, :2] for k, v in
                                          batch.items()}, device=cuda)
    checkpoint.save(str(tmp_path / "ck"), st)
    loaded, _, _ = checkpoint.load(str(tmp_path / "ck"), device=cuda)
    for k, v in st.items():
        assert loaded[k].is_cuda and loaded[k].dtype == v.dtype
        assert torch.equal(loaded[k], v), k
    _, rest = encoder.encode_sequence(cfg, {k: v[:, 2:] for k, v in
                                            batch.items()}, loaded,
                                      device=cuda)
    for k in encoder.SYMBOL_KEYS:
        assert torch.equal(rest[k], full[k][:, 2:]), k


@pytest.mark.cuda
def test_profile_on_the_card_writes_a_trace(cuda, tmp_path, capsys):
    from p64tpu_torch.tools import profile

    assert profile.main(["--device", "cuda", "--streams", "2", "--frames",
                         "2", "--format", "QCIF", "--trace-dir",
                         str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "steady state" in out and "Self CUDA" in out
    assert (tmp_path / "trace.json").exists()
