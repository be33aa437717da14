"""The port's hardware parity gate (`p64tpu_torch.tools.parity`), run on
the CPU: its SAD and DCT checks pass, its oracle is the JAX gate's, its
encodes reproduce the pinned streams and the JAX encoder, it catches a
wrong formulation, and its command refuses to run without a card."""

import hashlib
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from p64tpu.control.ratecontrol import RateConfig as JRateConfig
from p64tpu.core import encoder as jenc
from p64tpu.spec.constants import CIF
from p64tpu.tools import golden_content as gc
from p64tpu_torch.tools import parity, pinned

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tpu_parity():
    spec = importlib.util.spec_from_file_location(
        "tpu_parity", os.path.join(REPO, "tools", "tpu_parity.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def parts():
    return parity.split_blob(parity.encode_all("cpu"))


def test_check_sad_passes_on_cpu():
    assert parity.check_sad("cpu")


def test_check_dct_passes_on_cpu():
    assert parity.check_dct("cpu")


# offset 480 is (0, 0), valid for MB 0; offset 0 is (-15, -15), which
# leaves the picture for MB 0
@pytest.mark.parametrize("offset", [480, 0], ids=["valid", "out_of_picture"])
def test_check_sad_catches_a_wrong_formulation(monkeypatch, offset):
    real = parity._formulations

    def with_broken(device):
        out = real(device)
        plain = out["sad_map_rp_plain"]

        def off_by_one(c, r, s):
            m = plain(c, r, s)
            m[:, offset, 0] += 1
            return m
        out["broken"] = off_by_one
        return out

    monkeypatch.setattr(parity, "_formulations", with_broken)
    assert not parity.check_sad("cpu")


def test_oracle_and_planes_match_the_jax_gate():
    tp = _tpu_parity()
    planes = parity.parity_planes()
    assert set(planes) == {"random", "periodic"}
    for cur, ref in planes.values():
        assert cur.shape == ref.shape == (2, 144, 176)
        got = parity.sad_oracle(cur, ref, 15)
        for i in range(2):
            np.testing.assert_array_equal(got[i],
                                          tp.np_sad_oracle(cur[i], ref[i], 15))
    # the periodic planes hold exact ties, one stream at an odd shift
    per = planes["periodic"]
    gold = parity.sad_oracle(*per, 15)
    assert ((gold == gold.min(axis=1, keepdims=True)).sum(axis=1) > 1).all()
    np.testing.assert_array_equal(per[1][1], np.roll(per[1][0], 1, axis=1))


def test_encode_all_layout(parts):
    assert list(parts) == [f"{n}:{t}" for n in
                           ("noise", "periodic", "scenecut", "smooth")
                           for t in ("q10", "rc")] + ["cif:q10", "cif:rc"]
    blob = b"".join(f"{k}:{len(v)}\n".encode() + v for k, v in parts.items())
    assert parity.split_blob(blob) == parts


def test_encode_all_parts_match_the_pins(parts):
    want = pinned.pinned_hashes()
    covered = {f"{n}:q10": f"adv_{n}_q10" for n in
               ("noise", "periodic", "scenecut", "smooth")}
    covered.update({f"{n}:rc": f"adv_{n}_rc192k" for n in
                    ("noise", "periodic", "scenecut", "smooth")})
    covered["cif:rc"] = "cif_rc1M_mquant3_t3"
    for part, pin in covered.items():
        assert hashlib.sha256(parts[part]).hexdigest() == want[pin], part


def test_encode_all_cif_q10_matches_the_jax_encoder(parts):
    frames = {k: jnp.asarray(v[:3]) for k, v in gc.config3_cif_rc(3).items()}
    data, _, _ = jenc.encode_to_bytes(
        jenc.EncoderConfig(fmt=CIF, rate=JRateConfig(fixed_quant=10)), frames)
    assert parts["cif:q10"] == data


def test_gate_command_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert parity.main([]) != 0
    assert "no CUDA device" in capsys.readouterr().err
    assert parity.main(["--cpu"]) == 2
