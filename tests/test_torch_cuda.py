"""The CUDA kernels against their plain torch versions, on the card: the
SAD-search kernel and the four SAD-map kernels; the captured frame step
(core.graphs) against the eager loop; the decoder on the card against its
CPU decode and the encoder's reconstruction; the batch encoder, the stream
mesh, checkpoints, the profiler, the encoder fuzz, the compile check and the
dry run on the card.

These tests need a CUDA card and skip without one.  They import no JAX, so
they also run on a GPU host without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py -q
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from p64tpu_torch.core import decoder, encoder, graphs
from p64tpu_torch.kernels import me, me_cuda, me_variants, me_variants_cuda
from p64tpu_torch.spec.constants import CIF, QCIF
from p64tpu_torch.tools import golden_content as gc
from p64tpu_torch.tools import pinned

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402
import rate_goldens  # noqa: E402

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


#: one MB row, a small picture, QCIF and CIF (ragged last MB tiles), and
#: one stream of each format, as the encoder fuzz encodes them
SHAPES = [(2, 16, 64), (2, 48, 64), (2, 144, 176), (3, 288, 352),
          (1, 144, 176), (1, 288, 352)]
#: every search range the encoder fuzz samples, and 4
SEARCHES = [0, 1, 2, 3, 4, 7, 15]


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


@pytest.mark.cuda
def test_encoder_fuzz_on_the_card_equals_the_cpu(cuda, tmp_path, monkeypatch,
                                                capsys):
    from p64tpu_torch.tools import fuzz_encoder

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("FUZZ_SEED", "77")
    assert fuzz_encoder.main(["--count", "4"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("encoder config fuzz: 4 configs, all contracts "
                          "held")
    assert not list(tmp_path.iterdir())


#: the graph tests' rate settings: fixed quantizer, and rate control with
#: MQUANT segments (the host loop over GOBs, captured)
GRAPH_RATES = {"q10": dict(fixed_quant=10),
               "rc_mquant3": dict(bit_rate=2_000_000, mquant_segments=3)}


@pytest.mark.cuda
@pytest.mark.parametrize("rate", sorted(GRAPH_RATES))
@pytest.mark.parametrize("streams", [1, 16])
@pytest.mark.parametrize("search", [0, 2, 15])
def test_replayed_encode_equals_eager(cuda, search, streams, rate):
    from p64tpu_torch.control.ratecontrol import RateConfig
    from p64tpu_torch.tools.content import make_content

    cfg = encoder.EncoderConfig(fmt=CIF, search=search,
                                rate=RateConfig(**GRAPH_RATES[rate]))
    t = 3
    frames = {k: torch.as_tensor(v, device=cuda)
              for k, v in make_content(CIF, streams, t).items()}
    cache = graphs.ProgramCache()
    want_state, want = encoder.encode_sequence_eager(cfg, frames,
                                                     device=cuda)
    for _ in range(2):            # the build and a cache hit
        before = me_cuda.LAUNCHES
        state, got = encoder.encode_sequence_graphed(cfg, frames,
                                                     device=cuda, cache=cache)
        torch.cuda.synchronize()
        assert me_cuda.LAUNCHES - before == t
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
        for k in want_state:
            assert torch.equal(state[k], want_state[k]), k
    assert cache.builds == 1 and len(cache) == 1
    ((_, prog),) = cache.items()
    assert prog.captured.launches == 1


@pytest.mark.cuda
def test_a_step_that_syncs_raises_at_capture(cuda, monkeypatch):
    from p64tpu_torch.control.ratecontrol import RateConfig

    cfg = encoder.EncoderConfig(fmt=QCIF, search=3,
                                rate=RateConfig(fixed_quant=10))
    frames = _qcif_batch(2, 2)
    real = encoder.encode_frame_step

    def syncing(cfg_, state, *planes):
        state["buffer"].sum().item()              # a host sync
        return real(cfg_, state, *planes)

    cache = graphs.ProgramCache()
    monkeypatch.setattr(encoder, "encode_frame_step", syncing)
    with pytest.raises(RuntimeError):
        encoder.encode_sequence_graphed(cfg, frames, device=cuda,
                                        cache=cache)
    assert len(cache) == 0 and cache.builds == 0
    monkeypatch.undo()
    # nothing half-captured stays: the next call builds and is right
    _, got = encoder.encode_sequence_graphed(cfg, frames, device=cuda,
                                             cache=cache)
    _, want = encoder.encode_sequence_eager(cfg, frames, device=cuda)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
def test_replayed_reconstruct_equals_eager(cuda):
    from p64tpu_torch.control.ratecontrol import RateConfig

    cfg = encoder.EncoderConfig(fmt=QCIF, search=15,
                                rate=RateConfig(bit_rate=192_000))
    datas, _, _ = encoder.encode_to_bytes(cfg, _qcif_batch(3, 4),
                                          device="cpu")
    batch = decoder.stack_seqs(
        QCIF, [decoder.parse_to_tensors(d)[2] for d in datas], cuda)
    got = decoder.reconstruct_seq(QCIF, batch)
    for a, b in zip(got, decoder.reconstruct_seq_eager(QCIF, batch)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_a_decode_job_of_many_group_sizes_captures_only_in_its_first(cuda):
    """decode_seq_batch on the card over groups of 1 to 17 streams, as the
    benchmark's decode entry calls it, twice: the six group sizes pad to
    five programs, the second pass captures none, and every plane equals
    the CPU decode."""
    from p64tpu_torch.control.ratecontrol import RateConfig

    cfg = encoder.EncoderConfig(fmt=QCIF, search=15,
                                rate=RateConfig(fixed_quant=10))
    datas, _, _ = encoder.encode_to_bytes(cfg, _qcif_batch(3, 4),
                                          device="cpu")
    parsed = [decoder.parse_to_tensors(d)[2] for d in datas]
    groups = [[parsed[i % 3] for i in range(n)] for n in (1, 3, 5, 7, 9, 17)]
    decoder.PROGRAMS.clear()
    builds = decoder.PROGRAMS.builds
    for job in range(2):
        for seqs in groups:
            got = decoder.decode_seq_batch(QCIF, seqs, device=cuda)
            want = decoder.decode_seq_batch(QCIF, seqs, device="cpu")
            for g, w in zip(got, want):
                assert all(np.array_equal(a, b) for a, b in zip(g, w))
        assert decoder.PROGRAMS.builds - builds == 5
    assert len(decoder.PROGRAMS) == 5


@pytest.mark.cuda
def test_compile_check_and_dry_run_on_the_card(cuda):
    from p64tpu_torch.tools import dryrun

    fn, args = dryrun.entry(cuda)
    programs = graphs.PROGRAMS.items()
    before = me_cuda.LAUNCHES
    state, out = dryrun.compile_check(fn, args)
    torch.cuda.synchronize()
    assert me_cuda.LAUNCHES - before == 1
    assert graphs.PROGRAMS.items() == programs
    want_state, want = fn(*dryrun.entry("cpu")[1])
    for got, exp in ((state, want_state), (out, want)):
        assert got.keys() == exp.keys()
        for k in exp:
            assert torch.equal(got[k].cpu(), exp[k]), k
    on_card = dryrun.dryrun_multichip(4)
    assert on_card["devices"] == (torch.device("cuda", 0),) * 4
    on_cpu = dryrun.dryrun_multichip(4, devices=["cpu"] * 4)
    assert on_card["streams"] == on_cpu["streams"]


@pytest.mark.cuda
@pytest.mark.parametrize("nseg", [1, 2, 3, 4, 33, 40])
@pytest.mark.parametrize("fmt", [QCIF, CIF], ids=["qcif", "cif"])
def test_rate_chain_kernels_equal_the_plain_chain(cuda, fmt, nseg):
    from p64tpu_torch.control.ratecontrol import RateConfig
    from p64tpu_torch.kernels import rate_chain_cuda

    cfg = encoder.EncoderConfig(fmt=fmt, rate=RateConfig(
        bit_rate=1_920_000, mquant_segments=nseg))
    args = [torch.as_tensor(x, device=cuda)
            for x in chip_smoke.chain_inputs(nseg, 5, fmt.num_gobs)]
    before = rate_chain_cuda.LAUNCHES
    got = rate_chain_cuda.rate_chain_cuda(cfg.rate, *args)
    torch.cuda.synchronize()
    assert rate_chain_cuda.LAUNCHES - before == 3
    want = encoder._gob_chain(cfg, *args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("nseg", [1, 3])
def test_rate_encode_through_the_kernels_equals_the_plain_chain(
        cuda, monkeypatch, nseg):
    """Eager encodes of a rate-controlled QCIF batch through the chain's
    kernels and through the plain chain on the card, and the replayed one
    with three chain launches a frame, agree in every output."""
    from p64tpu_torch.control.ratecontrol import RateConfig
    from p64tpu_torch.kernels import rate_chain_cuda

    cfg = encoder.EncoderConfig(fmt=QCIF, rate=RateConfig(
        bit_rate=128_000, mquant_segments=nseg))
    t = 4
    frames = {k: torch.as_tensor(v, device=cuda)
              for k, v in _qcif_batch(3, t).items()}
    state_k, want = encoder.encode_sequence_eager(cfg, frames, device=cuda)
    before = rate_chain_cuda.LAUNCHES
    state_g, got = encoder.encode_sequence_graphed(
        cfg, frames, device=cuda, cache=graphs.ProgramCache())
    torch.cuda.synchronize()
    assert rate_chain_cuda.LAUNCHES - before == 3 * t
    monkeypatch.setattr(encoder, "gob_chain", encoder._gob_chain)
    state_p, plain = encoder.encode_sequence_eager(cfg, frames, device=cuda)
    for out, st in ((got, state_g), (plain, state_p)):
        for k in want:
            assert torch.equal(out[k], want[k]), k
        for k in state_k:
            assert torch.equal(st[k], state_k[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("nseg", rate_goldens.SEGMENTS)
def test_rate_encode_on_the_card_equals_the_jax_package(cuda, nseg):
    """The card's rate-controlled encode, whose chain runs the kernels
    (three launches a replayed frame), eager and replayed, gives every
    output and the final state the JAX package gives on the CPU: the
    digests of tests/rate_goldens.json, which test_torch_graphs holds to
    the JAX package."""
    from p64tpu_torch.kernels import rate_chain_cuda

    cfg = rate_goldens.config(nseg)
    frames = {k: torch.as_tensor(v, device=cuda)
              for k, v in rate_goldens.frames().items()}
    want = rate_goldens.pinned()[str(nseg)]
    before = rate_chain_cuda.LAUNCHES
    state, out = encoder.encode_sequence_graphed(
        cfg, frames, device=cuda, cache=graphs.ProgramCache())
    torch.cuda.synchronize()
    assert rate_chain_cuda.LAUNCHES - before == 3 * rate_goldens.FRAMES
    assert rate_goldens.port_digests(state, out) == want
    before = rate_chain_cuda.LAUNCHES
    state, out = encoder.encode_sequence_eager(cfg, frames, device=cuda)
    assert rate_chain_cuda.LAUNCHES - before == 3 * rate_goldens.FRAMES
    assert rate_goldens.port_digests(state, out) == want


@pytest.mark.cuda
@pytest.mark.parametrize("kind", chip_smoke.LEVELS_KINDS)
def test_levels_kernel_equals_the_plain_version(cuda, kind):
    """The levels kernel expands a packed batch to the plain version's
    levels8 and to the dense np.stack of the parsed levels8: at the decode
    cell's shape (128 CIF streams x 32 frames of the benchmark content),
    and for 128 CIF streams whose every level is nonzero, or zero.  Each
    stack_seqs launches it once."""
    from p64tpu_torch.kernels import levels_cuda

    fmt, seqs = chip_smoke.levels_seqs(kind, cuda)
    parts = decoder.ship_packed(fmt, seqs, cuda)
    args = [parts[k] for k in ("nz_mbs", "nz_blocks", "nz_levels",
                               "nz_bases")]
    got = levels_cuda.expand_levels(*args)
    assert torch.equal(got, levels_cuda.expand_levels_plain(*args))
    dense = np.stack([s["levels8"] for s in seqs], axis=1)
    assert torch.equal(got.cpu(), torch.from_numpy(dense))
    del dense
    before = levels_cuda.LAUNCHES
    for _ in range(2):
        batch = decoder.stack_seqs(fmt, seqs, cuda)
        assert torch.equal(batch["levels8"], got)
    assert levels_cuda.LAUNCHES - before == 2


@pytest.mark.cuda
def test_levels_kernel_refuses_a_cpu_mix(cuda):
    """On a CUDA tensor the wrapper launches or raises: parts on two
    devices are refused, never sent to the plain version."""
    from p64tpu_torch.kernels import levels_cuda
    from p64tpu_torch.native import load

    seq = load().pack_levels(np.zeros((1, QCIF.num_mbs, 6, 64), np.int8))
    mbs = torch.from_numpy(seq["nz_mbs"])[:, None].contiguous().to(cuda)
    blocks = torch.from_numpy(seq["nz_blocks"].view(np.int64))
    values = torch.from_numpy(seq["nz_levels"]).to(cuda)
    bases = torch.zeros((1, 1, 2), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="blocks is on cpu"):
        levels_cuda.expand_levels(mbs, blocks, values, bases)
