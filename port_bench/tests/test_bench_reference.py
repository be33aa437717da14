"""The benchmark's frozen reference against the port's plain CPU path and
against the pinned bitstreams of the JAX package's reference encoder."""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from p64tpu_torch.core import encoder as port_encoder
from p64tpu_torch.tools import pinned
from port_bench import entries, harness
from port_bench.content import make_content
from port_bench.reference import decode, serialize
from port_bench.reference import encoder as ref_encoder

PIN_FILE = os.path.join(harness.ROOT, "tests", "pinned_goldens.json")


def _configs():
    m = harness.Manifest()
    return {name: m.config(cell) for cell, w in m.cells.items()
            for name in [w["config"]]}


@pytest.mark.parametrize("fmt", ["QCIF", "CIF"])
@pytest.mark.parametrize("name", sorted(_configs()))
def test_reference_equals_the_ports_cpu_path(name, fmt):
    config = dict(_configs()[name], format=fmt, emit_recon=True)
    if config["rate"].get("bit_rate") and fmt == "QCIF":
        config["rate"] = dict(config["rate"], bit_rate=64000)
    h, w = (144, 176) if fmt == "QCIF" else (288, 352)
    frames = make_content(h, w, 2, 3, 5, 2**31 + 5, "cpu")
    data, outputs, _ = port_encoder.encode_to_bytes(
        entries.port_config(config), {k: v.numpy() for k, v in
                                      frames.items()}, device="cpu")
    got, kept = entries.reference_encode(config, frames,
                                         keep=ref_encoder.RECON_KEYS)
    assert [d for d, _ in got] == data
    for key in ref_encoder.RECON_KEYS:
        np.testing.assert_array_equal(kept[key], outputs[key].numpy())


def test_reference_reproduces_every_pinned_stream():
    with open(PIN_FILE) as f:
        pins = json.load(f)
    for name in pinned.ALL_PINS:
        cfg, frames = pinned.pinned_case(name)
        rate = {f: getattr(cfg.rate, f) for f in
                cfg.rate.__dataclass_fields__}
        config = dict(format=cfg.fmt.name, search=cfg.search,
                      intra_only=cfg.intra_only, rate=rate)
        (data, nbits), = entries.reference_encode(
            config, {k: torch.from_numpy(v) for k, v in frames.items()})[0]
        assert hashlib.sha256(data).hexdigest() == pins[name]["sha256"], name
        assert len(data) == pins[name]["bytes"] == (nbits + 7) // 8


def test_reference_decode_from_symbols_equals_its_reconstruction():
    config = dict(_configs()["cif_rc_p16"], format="QCIF")
    config["rate"] = dict(config["rate"], bit_rate=48000)
    cfg = entries.reference_config(config)
    _, out = ref_encoder.encode_sequence(
        cfg, make_content(144, 176, 3, 6, 40, 11, "cpu"))
    assert not bool(out["frame_coded"].all()), "no frame was skipped"
    for got, key in zip(decode.reconstruct_sequence(cfg.fmt, out),
                        ref_encoder.RECON_KEYS):
        assert torch.equal(got, out[key])


def test_serializer_pads_each_stream_alone():
    """Streams serialized in one block equal each serialized alone."""
    config = dict(_configs()["cif_q10"], format="QCIF")
    cfg = entries.reference_config(config)
    _, out = ref_encoder.encode_sequence(
        cfg, make_content(144, 176, 3, 2, 5, 3, "cpu"))
    together = serialize.serialize_streams(cfg.fmt, out)
    alone = [serialize.serialize_streams(
        cfg.fmt, {k: v[i:i + 1] for k, v in out.items()})[0]
        for i in range(3)]
    assert together == alone
    assert [n for _, n in together] == out["total_bits"].sum(1).tolist()


def test_content_is_seeded():
    a = make_content(144, 176, 2, 3, 5, 2**31 + 9, "cpu")
    b = make_content(144, 176, 2, 3, 5, 2**31 + 9, "cpu")
    c = make_content(144, 176, 2, 3, 5, 2**31 + 10, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["y"], c["y"])
    assert int(a["y"].max()) <= 255 and a["cb"].shape == (2, 3, 72, 88)
