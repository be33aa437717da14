"""The port's stream mesh and resilient batch encoder against the JAX
package: a mesh of logical CPU shards encodes each stream as JAX's
`encode_sequence_jit` does, with exact aggregates; its bitstreams decode to
the reconstruction; `encode_resilient` (retried, bisected, poisoned,
pipelined) and the `batch_encode` CLI give JAX `encode_shard`'s bytes."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from p64tpu.control.ratecontrol import RateConfig as JRateConfig
from p64tpu.core import encoder as jenc
from p64tpu.spec.constants import QCIF as JQCIF
from p64tpu.tools import batch_encode as jbatch
from p64tpu_torch.control.ratecontrol import RateConfig
from p64tpu_torch.core import encoder as enc
from p64tpu_torch.core.decoder import decode_stream
from p64tpu_torch.distrib import mesh as dm
from p64tpu_torch.io import yuv
from p64tpu_torch.kernels import _build
from p64tpu_torch.spec.constants import QCIF
from p64tpu_torch.tools import batch_encode

torch.set_num_threads(1)

CPU = dm.make_mesh(devices=["cpu"])
KEYS = ("coded", "mtype", "mv", "cbp", "levels8", "dc_intra", "gquant",
        "total_bits", "frame_coded")


def _frames(n_streams, t, seed=9):
    rng = np.random.default_rng(seed)
    h, w = QCIF.height, QCIF.width
    y = (rng.integers(0, 256, (n_streams, t, h, w), dtype=np.uint8) // 4
         + 96).astype(np.uint8)
    cb = rng.integers(60, 200, (n_streams, t, h // 2, w // 2), dtype=np.uint8)
    cr = rng.integers(60, 200, (n_streams, t, h // 2, w // 2), dtype=np.uint8)
    return dict(y=y, cb=cb, cr=cr)


def _cfgs(**kw):
    rate = kw.pop("rate")
    return (enc.EncoderConfig(fmt=QCIF, rate=RateConfig(**rate), **kw),
            jenc.EncoderConfig(fmt=JQCIF, rate=JRateConfig(**rate), **kw))


def _concat(sharded, key):
    return np.concatenate([o[key].cpu().numpy() for o in sharded])


@pytest.mark.parametrize("n_shards", [4, 3])
def test_mesh_encode_matches_jax_per_stream(n_shards):
    """4 logical CPU shards (even) and 3 (uneven: 3, 3, 2 streams)."""
    cfg, jcfg = _cfgs(search=3, rate=dict(fixed_quant=10))
    n_streams, t = 8, 2
    frames = _frames(n_streams, t)
    mesh = dm.make_mesh(devices=[torch.device("cpu")] * n_shards)
    run = dm.make_sharded_encoder(cfg, mesh)
    frames_sh = dm.shard_batch(mesh, frames)
    assert [f["y"].shape[0] for f in frames_sh] == (
        [2] * 4 if n_shards == 4 else [3, 3, 2])
    _, out, agg = run(dm.shard_batch(mesh, dm.init_states(cfg, n_streams)),
                      frames_sh)
    assert len(out) == n_shards

    bits = sse = frames_coded = 0
    for s in range(n_streams):
        fr = {k: jnp.asarray(v[s]) for k, v in frames.items()}
        _, jout = jenc.encode_sequence_jit(jcfg, fr, jenc.init_state(jcfg))
        for key in KEYS:
            np.testing.assert_array_equal(
                _concat(out, key)[s], np.asarray(jout[key]),
                err_msg=f"stream {s} key {key}")
        bits += int(np.asarray(jout["total_bits"]).sum())
        sse += float(np.asarray(jout["sse_y"], np.float64).sum())
        frames_coded += int(np.asarray(jout["frame_coded"]).sum())
    assert agg["total_bits"].dtype == torch.int64
    assert dm.agg_total_bits(agg) == bits
    assert int(agg["frames_coded"]) == frames_coded == n_streams * t
    np.testing.assert_allclose(float(agg["total_sse_y"]), sse, rtol=1e-6)


def test_sharded_bitstreams_decode():
    cfg, _ = _cfgs(search=2, rate=dict(fixed_quant=14))
    n_streams, t = 4, 2
    frames = _frames(n_streams, t)
    mesh = dm.make_mesh(devices=["cpu"] * 4)
    run = dm.make_sharded_encoder(cfg, mesh)
    _, out, _ = run(dm.shard_batch(mesh, dm.init_states(cfg, n_streams)),
                    dm.shard_batch(mesh, frames))
    streams = dm.serialize_streams(cfg, out)
    assert len(streams) == n_streams
    for s, (data, nbits) in enumerate(streams):
        assert nbits == int(_concat(out, "total_bits")[s].sum())
        y, cb, cr, _ = decode_stream(data, device="cpu")
        np.testing.assert_array_equal(y, _concat(out, "recon_y")[s])
        np.testing.assert_array_equal(cr, _concat(out, "recon_cr")[s])


def test_shard_batch_refuses_more_shards_than_streams():
    with pytest.raises(ValueError, match="cannot fill"):
        dm.shard_batch(dm.make_mesh(devices=["cpu"] * 3), _frames(2, 1))


def test_make_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dm.make_mesh()


def _jax_want(jcfg, frames):
    return jbatch.encode_shard(jcfg, frames)


def test_shard_retry_recovers_identical_output():
    """A failed dispatch is retried (then bisected), and the recovered
    bytes are JAX encode_shard's: re-dispatch of independent streams is
    exact."""
    cfg, jcfg = _cfgs(search=2, rate=dict(fixed_quant=12))
    n, t = 5, 2
    batch = _frames(n, t)
    want = _jax_want(jcfg, batch)
    assert batch_encode.encode_shard(cfg, batch, CPU) == want

    calls = []

    def flaky(s, e, att):
        calls.append((s, e, att))
        if att == 0:
            raise RuntimeError("injected transient device fault")

    assert batch_encode.encode_resilient(cfg, batch, CPU, retries=2,
                                         fail_hook=flaky) == want
    assert (0, n, 0) in calls and (0, n, 1) in calls

    def wide_fails(s, e, att):
        if e - s > 2:
            raise RuntimeError("injected wide-dispatch fault")

    assert batch_encode.encode_resilient(cfg, batch, CPU, retries=1,
                                         fail_hook=wide_fails) == want


def test_shard_retry_isolates_poison_stream():
    cfg, jcfg = _cfgs(search=2, rate=dict(fixed_quant=12))
    n, t = 4, 1
    batch = _frames(n, t)
    want = _jax_want(jcfg, batch)
    poison = 2
    logs = []

    def poisoned(s, e, att):
        if s <= poison < e:
            raise RuntimeError("injected poison stream")

    got = batch_encode.encode_resilient(cfg, batch, CPU, retries=1,
                                        fail_hook=poisoned, log=logs.append)
    assert got[poison] is None
    for i in range(n):
        if i != poison:
            assert got[i] == want[i], i
    assert any(f"stream {poison} failed permanently" in m for m in logs)


def test_pipelined_chunks_identical_and_resilient():
    """chunk > 0 pipelines dispatch and serialize; the bytes are the
    single dispatch's, also under a fault, and a poison stream inside a
    chunk loses only its slot."""
    cfg, jcfg = _cfgs(search=2, rate=dict(fixed_quant=12))
    n, t = 7, 2
    batch = _frames(n, t)
    want = _jax_want(jcfg, batch)
    # two logical shards per dispatch, as on a two-card mesh
    two = dm.make_mesh(devices=["cpu"] * 2)
    assert batch_encode.encode_resilient(cfg, batch, two, chunk=3) == want

    def flaky(s, e, att):
        if s == 3 and att == 0:
            raise RuntimeError("injected chunk fault")

    assert batch_encode.encode_resilient(cfg, batch, CPU, chunk=3, retries=2,
                                         fail_hook=flaky) == want

    def poisoned(s, e, att):
        if s <= 4 < e:
            raise RuntimeError("injected poison stream")

    got = batch_encode.encode_resilient(cfg, batch, CPU, chunk=3, retries=0,
                                        fail_hook=poisoned)
    assert got[4] is None
    assert [g for i, g in enumerate(got) if i != 4] == \
        [w for i, w in enumerate(want) if i != 4]


def test_build_failure_is_not_retried(monkeypatch):
    """A kernel or engine that cannot be built ends the tool: retrying or
    bisecting cannot fix a build."""
    cfg, _ = _cfgs(search=2, rate=dict(fixed_quant=12))
    calls = []

    def no_compiler(s, e, att):
        calls.append((s, e, att))
        raise _build.BuildError("nvcc not found")

    with pytest.raises(_build.BuildError, match="nvcc not found"):
        batch_encode.encode_resilient(cfg, _frames(4, 1), CPU, retries=2,
                                      fail_hook=no_compiler)
    assert calls == [(0, 4, 0)]

    def engine_gone():
        raise _build.BuildError("g++ not found")

    monkeypatch.setattr(enc, "load_batch", engine_gone)
    with pytest.raises(_build.BuildError, match="g\\+\\+ not found"):
        batch_encode.encode_resilient(cfg, _frames(2, 1), CPU, retries=2)


@pytest.fixture(scope="module")
def y4m_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("batch_in")
    frames = _frames(3, 3, seed=4)
    for i in range(3):
        yuv.write_y4m(str(d / f"s{i}.y4m"),
                      {k: v[i] for k, v in frames.items()}, (30, 1))
    return d


@pytest.mark.parametrize("flags,rate", [
    (["-q", "10", "-i", "3"], dict(fixed_quant=10)),
    (["-r", "192000", "-i", "2", "--chunk", "2"],
     dict(bit_rate=192_000, frame_rate=30))], ids=["q10", "rc192k_chunk2"])
def test_batch_encode_cli_matches_jax_encode_shard(tmp_path, y4m_dir, flags,
                                                   rate, capsys):
    outdir = tmp_path / "out"
    assert batch_encode.main(["-o", str(outdir), *flags, "--device", "cpu",
                              "-v", str(y4m_dir / "*.y4m")]) == 0
    out = capsys.readouterr().out
    assert "3 streams x 3 frames (QCIF)" in out
    search = int(flags[flags.index("-i") + 1])
    _, jcfg = _cfgs(search=search, emit_recon=False, rate=rate)
    loaded = [yuv.load_input(str(y4m_dir / f"s{i}.y4m"))[0]
              for i in range(3)]
    batch = {k: np.stack([fr[k] for fr in loaded]) for k in ("y", "cb",
                                                             "cr")}
    want = _jax_want(jcfg, batch)
    for i, (data, nbits) in enumerate(want):
        assert (outdir / f"s{i}.p64").read_bytes() == data
        assert f"s{i}.p64: {nbits} bits" in out
    assert f"{sum(b for _, b in want)} total bits" in out


def test_batch_encode_cli_refusals(tmp_path, y4m_dir, capsys):
    src = str(y4m_dir / "s0.y4m")
    assert batch_encode.main(["-o", str(tmp_path), "-i", "16", "--device",
                              "cpu", src]) == 1
    assert "0..15" in capsys.readouterr().err
    if not torch.cuda.is_available():
        assert batch_encode.main(["-o", str(tmp_path / "x"), src]) == 2
        assert "--device cpu" in capsys.readouterr().err
        assert not os.path.exists(tmp_path / "x")
