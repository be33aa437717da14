"""The planes out of `core.decoder.decode_seq_batch`: where the decoded
planes land in host memory.

On the CPU the returned arrays view the reconstructed planes and no copy
back is counted.  On a card (marker `cuda`, skips without one) the planes
cross into pinned blocks of torch's caching host allocator: every byte is
counted as a pinned copy back, the arrays survive a later decode of the
same shape, and their values equal the CPU path's.  Imports no JAX, so the
card tests also run on a GPU host without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_planes_out.py -q
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from p64tpu_torch import trace
from p64tpu_torch.control.ratecontrol import RateConfig
from p64tpu_torch.core import decoder, encoder
from p64tpu_torch.spec.constants import CIF, QCIF
from p64tpu_torch.tools import golden_content as gc

torch.set_num_threads(1)

#: bytes of one frame's three planes
FRAME_BYTES = {"QCIF": 38_016, "CIF": 152_064}
D2H = ("p64.copy.d2h.pinned_bytes", "p64.copy.d2h.pageable_bytes")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _frames(fmt, streams, t, shift):
    """`streams` streams of t frames, each the format's golden content
    rolled sideways by its own amount (shift picks another batch)."""
    one = (gc.config2_qcif_inter(t) if fmt is QCIF
           else gc.config3_cif_rc(t))
    return {k: np.stack([np.roll(v[:t], 7 * i + shift, axis=-1)
                         for i in range(streams)]) for k, v in one.items()}


def _encode(fmt, streams, t, shift=0, device="cpu"):
    """(parsed seq dicts, the encoder's reconstruction as (S, T, ...)
    arrays) of a fixed-quantizer encode."""
    cfg = encoder.EncoderConfig(fmt=fmt, search=7,
                                rate=RateConfig(fixed_quant=10))
    datas, out, _ = encoder.encode_to_bytes(
        cfg, _frames(fmt, streams, t, shift), device=device)
    seqs = [decoder.parse_to_tensors(d)[2] for d in datas]
    return seqs, [out[k].cpu().numpy() for k in encoder.RECON_KEYS]


def _traced_decode(seqs, fmt, device):
    """decode_seq_batch under the profiler: (planes, counters it added)."""
    before = trace.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        planes = decoder.decode_seq_batch(fmt, seqs, device=device)
    added = {k: v - before.get(k, 0) for k, v in trace.counters().items()
             if v != before.get(k, 0)}
    return planes, added


@pytest.fixture(scope="module")
def qcif_cpu():
    return _encode(QCIF, 3, 3)


def test_cpu_planes_equal_the_reconstruction(qcif_cpu):
    seqs, recon = qcif_cpu
    planes = decoder.decode_seq_batch(QCIF, seqs, device="cpu")
    want = decoder.reconstruct_seq(QCIF, decoder.stack_seqs(QCIF, seqs,
                                                            "cpu"))
    assert len(planes) == len(seqs)
    for i, got in enumerate(planes):
        for g, w, r, hw in zip(got, want, recon, (
                (QCIF.height, QCIF.width),
                (QCIF.chroma_height, QCIF.chroma_width),
                (QCIF.chroma_height, QCIF.chroma_width))):
            assert isinstance(g, np.ndarray) and g.dtype == np.uint8
            assert g.shape == (3, *hw)
            np.testing.assert_array_equal(g, w[i].numpy())
            np.testing.assert_array_equal(g, r[i])


def test_cpu_decode_counts_no_copy_back(qcif_cpu):
    seqs, _ = qcif_cpu
    planes, added = _traced_decode(seqs, QCIF, "cpu")
    assert not any(k.startswith("p64.copy.") for k in added), added
    assert added["p64.decode.macroblocks"] == 3 * 3 * QCIF.num_mbs
    # one batch's planes: every stream's arrays view the same three planes
    for k in range(3):
        assert planes[0][k].base is planes[-1][k].base


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", [QCIF, CIF], ids=["qcif", "cif"])
def test_card_planes_are_pinned_and_counted(cuda, fmt):
    streams, t = 3, 2
    seqs, recon = _encode(fmt, streams, t, device=cuda)
    planes, added = _traced_decode(seqs, fmt, cuda)
    assert added.get(D2H[0]) == streams * t * FRAME_BYTES[fmt.name]
    assert added.get(D2H[1], 0) == 0
    for i, got in enumerate(planes):
        for g, r in zip(got, recon):
            assert g.dtype == np.uint8 and g.shape[0] == t
            assert torch.from_numpy(g).is_pinned()
            np.testing.assert_array_equal(g, r[i])


@pytest.mark.cuda
def test_card_planes_survive_a_later_decode(cuda):
    seqs_a, recon_a = _encode(CIF, 2, 3, shift=0, device=cuda)
    seqs_b, recon_b = _encode(CIF, 2, 3, shift=40, device=cuda)
    kept = decoder.decode_seq_batch(CIF, seqs_a, device=cuda)
    copies = [tuple(p.copy() for p in planes) for planes in kept]
    for _ in range(3):
        later = decoder.decode_seq_batch(CIF, seqs_b, device=cuda)
        for i, planes in enumerate(later):
            for g, r, a in zip(planes, recon_b, kept[i]):
                np.testing.assert_array_equal(g, r[i])
                assert not np.shares_memory(g, a)
        del later
    for i, (planes, want) in enumerate(zip(kept, copies)):
        for g, w, r in zip(planes, want, recon_a):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, r[i])
    assert not np.array_equal(copies[0][0], recon_b[0][0])


@pytest.mark.cuda
def test_card_planes_equal_the_cpu_path(cuda):
    seqs, _ = _encode(CIF, 3, 3, device=cuda)
    on_card = decoder.decode_seq_batch(CIF, seqs, device=cuda)
    on_cpu = decoder.decode_seq_batch(CIF, seqs, device="cpu")
    for a, b in zip(on_card, on_cpu):
        for x, y in zip(a, b):
            assert x.shape == y.shape and x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
