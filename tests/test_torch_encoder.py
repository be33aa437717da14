"""The PyTorch port's fixed-quantizer encode, end to end, against the JAX
package: bytes, every output tensor, the pinned goldens, and resuming from
a state the JAX encoder left."""

import hashlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from p64tpu.control.decisions import DecisionConfig as JDecisionConfig
from p64tpu.control.ratecontrol import RateConfig as JRateConfig
from p64tpu.core import encoder as jenc
from p64tpu.spec.constants import QCIF
from p64tpu.tools import golden_content as gc
from p64tpu_torch.control.decisions import DecisionConfig
from p64tpu_torch.control.ratecontrol import RateConfig
from p64tpu_torch.core import encoder as enc
from p64tpu_torch.tools import pinned

torch.set_num_threads(1)

T = 4


def _content():
    """Two QCIF streams x T frames: moving square on a periodic background
    (exact SAD ties) and a smooth gradient with a moving square."""
    a = gc.config2_qcif_inter()
    b = gc.luma_to_frames(gc.adversarial_sequences()["smooth"])
    return {k: np.stack([a[k][:T], b[k][:T]]) for k in ("y", "cb", "cr")}


CONFIGS = {
    "s15_q10": dict(search=15, quant=10),
    "iperiod2_nofilter": dict(search=15, quant=10, intra_period=2,
                              filter_with_mc=False),
    "s7_q4_norecon": dict(search=7, quant=4, emit_recon=False),
}


def _configs(search, quant, intra_period=0, filter_with_mc=True,
             emit_recon=True):
    common = dict(fmt=QCIF, search=search, intra_period=intra_period,
                  emit_recon=emit_recon)
    return (enc.EncoderConfig(rate=RateConfig(fixed_quant=quant),
                              decisions=DecisionConfig(
                                  filter_with_mc=filter_with_mc), **common),
            jenc.EncoderConfig(rate=JRateConfig(fixed_quant=quant),
                               decisions=JDecisionConfig(
                                   filter_with_mc=filter_with_mc), **common))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_slice_matches_jax_bytes_and_outputs(name):
    tcfg, jcfg = _configs(**CONFIGS[name])
    frames = _content()
    data, out, state = enc.encode_to_bytes(tcfg, frames, device="cpu")
    assert len(data) == 2
    assert ("recon_y" in out) == tcfg.emit_recon
    for i in range(2):
        jdata, jout, jstate = jenc.encode_to_bytes(
            jcfg, {k: jnp.asarray(v[i]) for k, v in frames.items()})
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
        for k, v in enc.state_to_numpy(state).items():
            np.testing.assert_array_equal(v[i], np.asarray(jstate[k]),
                                          err_msg=k)


@pytest.mark.parametrize("name", pinned.FIXED_Q_PINS)
def test_fixed_q_pins_through_port(name):
    cfg, frames = pinned.pinned_case(name)
    data, _, _ = enc.encode_to_bytes(cfg, frames, device="cpu")
    assert hashlib.sha256(data[0]).hexdigest() == pinned.pinned_hashes()[name]


def test_resume_from_jax_state():
    tcfg, jcfg = _configs(search=15, quant=10)
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


def test_init_state_matches_jax_layout():
    tcfg, jcfg = _configs(search=15, quant=10)
    got = enc.state_to_numpy(enc.init_state(tcfg, 3, "cpu"))
    want = jax.tree.map(np.asarray, jenc.init_state(jcfg))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == (3,) + v.shape and got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k][1], v)


def test_config_rejects_what_is_not_ported():
    with pytest.raises(NotImplementedError):
        enc.EncoderConfig(fmt=QCIF, rate=RateConfig(bit_rate=64000))
    with pytest.raises(ValueError):
        enc.EncoderConfig(fmt=QCIF, search=16)
    with pytest.raises(ValueError):
        enc.encode_sequence(enc.EncoderConfig(fmt=QCIF),
                            {k: v[0] for k, v in _content().items()},
                            device="cpu")
