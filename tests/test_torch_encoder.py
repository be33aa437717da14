"""The PyTorch port's encode, end to end, against the JAX package: fixed
quantizer, rate control, MQUANT segments and frame skip -- bytes, every
output tensor and the final state, the pinned goldens, and resuming from a
state the JAX encoder left."""

import hashlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from p64tpu.control.decisions import DecisionConfig as JDecisionConfig
from p64tpu.control.ratecontrol import RateConfig as JRateConfig
from p64tpu.core import encoder as jenc
from p64tpu.spec.constants import QCIF as JQCIF
from p64tpu_torch.control.decisions import DecisionConfig
from p64tpu_torch.control.ratecontrol import RateConfig
from p64tpu_torch.core import encoder as enc
from p64tpu_torch.spec import luts
from p64tpu_torch.spec.constants import QCIF
from p64tpu_torch.tools import golden_content as gc
from p64tpu_torch.tools import pinned

torch.set_num_threads(1)

T = 4


def _content():
    """Two QCIF streams x T frames: moving square on a periodic background
    (exact SAD ties) and a smooth gradient with a moving square."""
    a = gc.config2_qcif_inter()
    b = gc.luma_to_frames(gc.adversarial_sequences()["smooth"])
    return {k: np.stack([a[k][:T], b[k][:T]]) for k in ("y", "cb", "cr")}


def _skip_content():
    """Two QCIF streams x 5 frames: noise, which overruns a low-rate buffer
    and skips, beside a smooth gradient, which never skips."""
    adv = gc.adversarial_sequences()
    a = gc.luma_to_frames(adv["noise"])
    b = gc.luma_to_frames(adv["smooth"])
    return {k: np.stack([a[k], b[k]]) for k in ("y", "cb", "cr")}


CONFIGS = {
    "s15_q10": dict(search=15, quant=10),
    "iperiod2_nofilter": dict(search=15, quant=10, intra_period=2,
                              filter_with_mc=False),
    "s7_q4_norecon": dict(search=7, quant=4, emit_recon=False),
    "rc192k": dict(search=15, rate=dict(bit_rate=192_000, frame_rate=30)),
    "rc256k_mquant3": dict(search=15, rate=dict(bit_rate=256_000,
                                                mquant_segments=3)),
    "rc700k_mquant3_s7_nofill": dict(
        search=7, rate=dict(bit_rate=700_000, mquant_segments=3,
                            min_rate_fill=False)),
}


def _configs(search, quant=8, intra_period=0, filter_with_mc=True,
             emit_recon=True, rate=None):
    common = dict(search=search, intra_period=intra_period,
                  emit_recon=emit_recon)
    rate = dict(fixed_quant=quant) if rate is None else rate
    return (enc.EncoderConfig(fmt=QCIF, rate=RateConfig(**rate),
                              decisions=DecisionConfig(
                                  filter_with_mc=filter_with_mc), **common),
            jenc.EncoderConfig(fmt=JQCIF, rate=JRateConfig(**rate),
                               decisions=JDecisionConfig(
                                   filter_with_mc=filter_with_mc), **common))


def _assert_matches_jax(tcfg, jcfg, frames, state=None, jstates=None):
    """Encode both streams at once through the port and one at a time
    through the JAX package; bytes, outputs and final state must agree.
    Returns the port's outputs."""
    data, out, final = enc.encode_to_bytes(tcfg, frames, state, device="cpu")
    assert len(data) == 2
    assert ("recon_y" in out) == tcfg.emit_recon
    for i in range(2):
        jdata, jout, jstate = jenc.encode_to_bytes(
            jcfg, {k: jnp.asarray(v[i]) for k, v in frames.items()},
            None if jstates is None else jstates[i])
        assert data[i] == jdata
        assert set(out) == set(jout)
        for k, want in jout.items():
            got = out[k][i].numpy()
            want = np.asarray(want)
            assert got.shape == want.shape, k
            if k == "sse_y":
                # the JAX float32 sum rounds in another order
                np.testing.assert_allclose(got, want, rtol=1e-5)
            else:
                assert got.dtype == want.dtype, k
                np.testing.assert_array_equal(got, want, err_msg=k)
        for k, v in enc.state_to_numpy(final).items():
            np.testing.assert_array_equal(v[i], np.asarray(jstate[k]),
                                          err_msg=k)
    return out, enc.state_to_numpy(final)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_slice_matches_jax_bytes_and_outputs(name):
    tcfg, jcfg = _configs(**CONFIGS[name])
    out, final = _assert_matches_jax(tcfg, jcfg, _content())
    if tcfg.rate.enabled:
        # the buffer law really ran: quantizers moved, buffers stay >= 0
        assert len(np.unique(out["gquant"].numpy())) > 1
        assert (final["buffer"] >= 0).all()
    if tcfg.rate.mquant_segments > 1:
        # MQUANT was signaled somewhere (an MTYPE with the MQUANT flag)
        assert luts.MTYPE_MQUANT[out["mtype"].numpy()][
            out["coded"].numpy()].any()


@pytest.mark.parametrize("mquant_segments", [1, 3])
def test_one_of_two_streams_skips(mquant_segments):
    rate = dict(bit_rate=128_000, mquant_segments=mquant_segments)
    tcfg, jcfg = _configs(search=15, rate=rate)
    out, _ = _assert_matches_jax(tcfg, jcfg, _skip_content())
    coded = out["frame_coded"].numpy()
    # stream 0 (noise) skips after its first frame, stream 1 never does
    assert coded[0, 0] and not coded[0, 1:].any()
    assert coded[1].all()
    assert (out["n_stuff"][1].numpy() > 0).any()
    assert not out["total_bits"][0, 1:].any()


# all thirteen pins: the six fixed-quantizer ones and the seven
# rate-controlled ones (two with MQUANT segments)
@pytest.mark.parametrize("name", pinned.ALL_PINS)
def test_fixed_q_pins_through_port(name):
    cfg, frames = pinned.pinned_case(name)
    data, _, _ = enc.encode_to_bytes(cfg, frames, device="cpu")
    assert hashlib.sha256(data[0]).hexdigest() == pinned.pinned_hashes()[name]


def _resume_from_jax(tcfg, jcfg):
    frames = _content()
    head = {k: v[:, :2] for k, v in frames.items()}
    tail = {k: v[:, 2:] for k, v in frames.items()}
    jstates, jtail = [], []
    for i in range(2):
        _, _, st = jenc.encode_to_bytes(
            jcfg, {k: jnp.asarray(v[i]) for k, v in head.items()})
        jstates.append({k: np.asarray(v) for k, v in st.items()})
        jtail.append(jenc.encode_to_bytes(
            jcfg, {k: jnp.asarray(v[i]) for k, v in tail.items()}, st))
    # one stream at a time, in the JAX layout (no stream axis)
    d0, _, _ = enc.encode_to_bytes(
        tcfg, {k: v[:1] for k, v in tail.items()},
        enc.state_from_numpy(jstates[0], "cpu"), device="cpu")
    assert d0[0] == jtail[0][0]
    # both streams at once, states stacked on a leading stream axis
    stacked = {k: np.stack([s[k] for s in jstates]) for k in jstates[0]}
    data, _, state = enc.encode_to_bytes(
        tcfg, tail, enc.state_from_numpy(stacked, "cpu"), device="cpu")
    final = enc.state_to_numpy(state)
    for i in range(2):
        assert data[i] == jtail[i][0]
        for k, v in final.items():
            np.testing.assert_array_equal(v[i], np.asarray(jtail[i][2][k]))
    return stacked


def test_resume_from_jax_state():
    _resume_from_jax(*_configs(search=15, quant=10))


def test_resume_from_jax_rate_controlled_state():
    # mid-sequence: a non-zero virtual buffer and refresh counters carry
    # over, and the MQUANT segments see the carried buffer
    tcfg, jcfg = _configs(search=15, rate=dict(bit_rate=256_000,
                                                mquant_segments=3))
    carried = _resume_from_jax(tcfg, jcfg)
    assert (carried["buffer"] > 0).all()
    assert (carried["frame_idx"] == 2).all()


def _init_state_matches(tcfg, jcfg):
    got = enc.state_to_numpy(enc.init_state(tcfg, 3, "cpu"))
    want = jax.tree.map(np.asarray, jenc.init_state(jcfg))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == (3,) + v.shape and got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k][1], v)
    return got


def test_init_state_matches_jax_layout():
    _init_state_matches(*_configs(search=15, quant=10))


@pytest.mark.parametrize("rate", [dict(bit_rate=192_000),
                                  dict(bit_rate=64000, initial_quant=20,
                                       qoffs=2)],
                         ids=["rc192k", "rc64k_iq20"])
def test_init_state_seeds_the_rate_buffer(rate):
    got = _init_state_matches(*_configs(search=15, rate=rate))
    assert (got["buffer"] == RateConfig(**rate).initial_buffer()).all()
    assert got["buffer"][0] > 0


def test_config_rejects_what_is_not_ported():
    with pytest.raises(ValueError):
        enc.EncoderConfig(fmt=QCIF, search=16)
    with pytest.raises(ValueError):
        enc.encode_sequence(enc.EncoderConfig(fmt=QCIF),
                            {k: v[0] for k, v in _content().items()},
                            device="cpu")
