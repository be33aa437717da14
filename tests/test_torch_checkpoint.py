"""Checkpoint/resume of the PyTorch port against the JAX package: an encode
resumed from a checkpoint continues the uninterrupted run bit for bit, the
on-disk format is crash-safe as the reference's, and each package resumes
from the other's checkpoints."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from p64tpu.control.ratecontrol import RateConfig as JRateConfig
from p64tpu.core import encoder as jenc
from p64tpu.entropy.encode import serialize_sequence as jserialize
from p64tpu.io import checkpoint as jcheckpoint
from p64tpu.spec.constants import QCIF
from p64tpu_torch.control.ratecontrol import RateConfig
from p64tpu_torch.core import encoder as enc
from p64tpu_torch.io import checkpoint
from p64tpu_torch.spec.constants import QCIF as TQCIF

torch.set_num_threads(1)

T, SPLIT = 6, 3
RATE = dict(bit_rate=200_000)
SYMBOL_KEYS = ("coded", "mtype", "mv", "cbp", "levels8", "dc_intra",
               "gquant", "quant_mb", "n_stuff", "tr", "total_bits",
               "frame_coded")


def _frames(streams, seed=21):
    rng = np.random.default_rng(seed)
    y = (rng.integers(0, 256, (streams, T, QCIF.height, QCIF.width),
                      dtype=np.uint8) // 3 + 80).astype(np.uint8)
    return dict(y=y, cb=y[:, :, ::2, ::2].copy(), cr=y[:, :, 1::2, ::2].copy())


def _cfgs():
    return (enc.EncoderConfig(fmt=TQCIF, search=3, rate=RateConfig(**RATE)),
            jenc.EncoderConfig(fmt=QCIF, search=3, rate=JRateConfig(**RATE)))


def _bits(data, n):
    return np.unpackbits(np.frombuffer(data, np.uint8))[:n]


def _assert_continues(full, full_bits, first, first_bits, second,
                      second_bits):
    """first then second, bit for bit, is the uninterrupted stream."""
    assert first_bits + second_bits == full_bits
    np.testing.assert_array_equal(
        np.concatenate([_bits(first, first_bits),
                        _bits(second, second_bits)]),
        _bits(full, full_bits))


def _jax_full(jcfg, frames, s=0):
    fr = {k: jnp.asarray(v[s]) for k, v in frames.items()}
    data, out, _ = jenc.encode_to_bytes(jcfg, fr)
    return data, out, int(np.asarray(out["total_bits"]).sum())


def test_resume_bitstream_identical(tmp_path):
    cfg, jcfg = _cfgs()
    frames = _frames(2)
    data_full, out_full, _ = enc.encode_to_bytes(cfg, frames, device="cpu")

    half1 = {k: v[:, :SPLIT] for k, v in frames.items()}
    st1, out1 = enc.encode_sequence(cfg, half1, device="cpu")
    first = enc.serialize_streams(cfg, out1)
    ck = str(tmp_path / "ck")
    checkpoint.save(ck, st1, streams=[b for b, _ in first],
                    meta={"frames_done": SPLIT})

    # "new process": resume
    st_loaded, streams, meta = checkpoint.load(ck, device="cpu")
    assert meta["frames_done"] == SPLIT
    assert streams == [b for b, _ in first]
    for k, v in st1.items():
        assert st_loaded[k].dtype == v.dtype and torch.equal(st_loaded[k], v)
    half2 = {k: v[:, SPLIT:] for k, v in frames.items()}
    _, out2 = enc.encode_sequence(cfg, half2, st_loaded, device="cpu")
    second = enc.serialize_streams(cfg, out2)

    for s in range(2):
        full_bits = int(out_full["total_bits"][s].sum())
        _assert_continues(data_full[s], full_bits, streams[s], first[s][1],
                          *second[s])
        # and the uninterrupted run is the JAX package's
        jdata, _, jbits = _jax_full(jcfg, frames, s)
        assert (jdata, jbits) == (data_full[s], full_bits)
    # state equality => every later frame encodes identically (n_stuff
    # included: minimum-rate fill depends on the carried buffer)
    for k in SYMBOL_KEYS:
        assert torch.equal(out2[k], out_full[k][:, SPLIT:]), k


def test_state_only_save_removes_stale_bits(tmp_path):
    """A state-only save leaves no earlier stream bytes visible, removes
    the old layout's companion files and leaves no temp file behind."""
    ck = str(tmp_path / "ck")
    state = dict(frame_idx=torch.tensor([3, 3], dtype=torch.int32),
                 buffer=torch.tensor([7, 9], dtype=torch.int32))
    open(ck + ".bits", "wb").close()
    open(ck + ".json", "w").close()
    checkpoint.save(ck, state, streams=[b"abc", b"defg"])
    st, streams, _ = checkpoint.load(ck, device="cpu")
    assert streams == [b"abc", b"defg"]
    assert torch.equal(st["buffer"], state["buffer"])
    assert not os.path.exists(ck + ".bits")
    assert not os.path.exists(ck + ".json")

    checkpoint.save(ck, state)            # state-only
    st, streams, _ = checkpoint.load(ck, device="cpu")
    assert streams == []
    assert not any(f.endswith(".tmp") or ".tmp." in f
                   for f in os.listdir(tmp_path))


def test_interrupted_save_leaves_old_checkpoint_loadable(tmp_path):
    """A crash mid-save (temp written, never published) leaves the previous
    checkpoint intact, and a later good save wins."""
    ck = str(tmp_path / "ck")
    checkpoint.save(ck, dict(frame_idx=torch.tensor([1])), streams=[b"v1"],
                    meta={"v": 1})
    with open(ck + ".npz.tmp.npz", "wb") as f:
        f.write(b"garbage not an npz")
    st, streams, meta = checkpoint.load(ck, device="cpu")
    assert streams == [b"v1"] and meta == {"v": 1}
    assert int(st["frame_idx"][0]) == 1
    checkpoint.save(ck, dict(frame_idx=np.asarray([2])), streams=[b"v2"])
    st, streams, _ = checkpoint.load(ck, device="cpu")
    assert streams == [b"v2"] and int(st["frame_idx"][0]) == 2


def test_load_rejects_pre_round5_layout(tmp_path):
    """Bare state keys (the old three-file layout) raise instead of loading
    as empty state."""
    ck = str(tmp_path / "old")
    np.savez_compressed(ck + ".npz", frame_idx=np.asarray([3]),
                        buffer=np.asarray([7]))
    with pytest.raises(ValueError, match="pre-round-5"):
        checkpoint.load(ck, device="cpu")
    with pytest.raises(ValueError, match="pre-round-5"):
        jcheckpoint.load(ck)


def test_port_resumes_a_jax_checkpoint(tmp_path):
    """The JAX package encodes the first frames and checkpoints; the port
    loads that file and encodes the rest: its outputs are the JAX
    uninterrupted run's, and its bytes continue the JAX bytes to the
    uninterrupted stream."""
    cfg, jcfg = _cfgs()
    frames = _frames(1, seed=5)
    data_full, out_full, full_bits = _jax_full(jcfg, frames)

    j1 = {k: jnp.asarray(v[0, :SPLIT]) for k, v in frames.items()}
    jst1, jout1 = jenc.encode_sequence_jit(jcfg, j1, jenc.init_state(jcfg))
    first, first_bits = jserialize(jcfg.fmt,
                                   jenc.outputs_to_symbols(jcfg, jout1))
    ck = str(tmp_path / "jax_ck")
    jcheckpoint.save(ck, jst1, streams=[first], meta={"frames_done": SPLIT})

    st, streams, meta = checkpoint.load(ck, device="cpu")
    assert streams == [first] and meta == {"frames_done": SPLIT}
    half2 = {k: v[:, SPLIT:] for k, v in frames.items()}
    data2, out2, _ = enc.encode_to_bytes(
        cfg, half2, enc.state_from_numpy(st, "cpu"), device="cpu")
    second_bits = int(out2["total_bits"].sum())
    _assert_continues(data_full, full_bits, streams[0], first_bits,
                      data2[0], second_bits)
    for k in SYMBOL_KEYS:
        np.testing.assert_array_equal(out2[k][0].numpy(),
                                      np.asarray(out_full[k])[SPLIT:],
                                      err_msg=k)


def test_jax_resumes_a_port_checkpoint(tmp_path):
    """The port checkpoints two streams; the JAX package loads equal arrays
    and bytes, and resumes stream 1 to its own uninterrupted run."""
    cfg, jcfg = _cfgs()
    frames = _frames(2, seed=8)
    half1 = {k: v[:, :SPLIT] for k, v in frames.items()}
    st1, out1 = enc.encode_sequence(cfg, half1, device="cpu")
    first = enc.serialize_streams(cfg, out1)
    ck = str(tmp_path / "port_ck")
    checkpoint.save(ck, st1, streams=[b for b, _ in first],
                    meta={"frames_done": SPLIT})

    jst, jstreams, jmeta = jcheckpoint.load(ck)
    assert jstreams == [b for b, _ in first]
    assert jmeta == {"frames_done": SPLIT}
    want = enc.state_to_numpy(st1)
    assert sorted(jst) == sorted(want)
    for k, v in want.items():
        got = np.asarray(jst[k])
        assert got.dtype == v.dtype, k
        np.testing.assert_array_equal(got, v, err_msg=k)

    data_full, out_full, full_bits = _jax_full(jcfg, frames, 1)
    _, jout2 = jenc.encode_sequence_jit(
        jcfg, {k: jnp.asarray(v[1, SPLIT:]) for k, v in frames.items()},
        {k: v[1] for k, v in jst.items()})
    second, second_bits = jserialize(jcfg.fmt,
                                     jenc.outputs_to_symbols(jcfg, jout2))
    _assert_continues(data_full, full_bits, jstreams[1], first[1][1],
                      second, second_bits)
