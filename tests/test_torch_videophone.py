"""The H.320 basic-rate videophone on the port's CPU path: the benchmark's
`qcif_p2` (H.261 at p = 2, 128 kbit/s, QCIF at 30 Hz) over its traffic's
texture, at a few streams and enough frames that the buffer law skips
frames in every stream.  The port's bytes, bit counts and reconstruction
equal the benchmark's plain reference and the JAX package, through
`encode_to_bytes` and through the batch encode the benchmark drives;
`serialize_streams` counts the coded frames while tracing is on; the
reader of that counter; the configuration and the cells that list it."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from p64tpu.control.ratecontrol import RateConfig as JRateConfig
from p64tpu.core import encoder as jenc
from p64tpu.spec.constants import FORMATS as JFORMATS
from p64tpu_torch import trace
from p64tpu_torch.core import encoder as enc
from p64tpu_torch.distrib import mesh as dm
from p64tpu_torch.tools.batch_encode import encode_resilient
from port_bench import entries, harness, tracing
from port_bench.content import make_content
from port_bench.reference import encoder as ref_encoder

torch.set_num_threads(1)

CELL = "qcif_p2.encode"
RATE_CELLS = ("cif_rc_p30_mq3.encode", "cif_rc_p16.encode", CELL)
STREAMS, FRAMES, CHUNK = 3, 8, 2
SEED = 2**31 + 24
COUNTER = "p64.rate.coded_frames"
READER = "coded_frame_share.encode"


def _config(cell=CELL, **changes):
    return dict(harness.Manifest().config(cell), **changes)


def _frames(fmt="QCIF", frames=FRAMES):
    noise = harness.Manifest().traffic(CELL)["noise"]
    h, w = (288, 352) if fmt == "CIF" else (144, 176)
    return make_content(h, w, STREAMS, frames, noise, SEED, "cpu")


@pytest.fixture(scope="module")
def encoded():
    """(configuration, frames, the port's bytes, outputs)."""
    config, frames = _config(emit_recon=True), _frames()
    data, outputs, _ = enc.encode_to_bytes(
        entries.port_config(config), {k: v.numpy() for k, v in
                                      frames.items()}, device="cpu")
    return config, frames, data, outputs


def test_every_stream_skips_frames(encoded):
    """The first picture is coded; every stream then skips at least one
    input frame, and codes at least one after its first."""
    coded = encoded[3]["frame_coded"].numpy()
    assert coded.shape == (STREAMS, FRAMES)
    assert coded[:, 0].all()
    assert (~coded).any(axis=1).all()
    assert coded[:, 1:].any(axis=1).all()


def test_the_port_equals_the_reference(encoded):
    """Bytes, bit counts and reconstruction of the port's encode_to_bytes
    against the benchmark's plain reference."""
    config, frames, data, outputs = encoded
    got, kept = entries.reference_encode(
        config, frames, keep=ref_encoder.RECON_KEYS + ("frame_coded",))
    assert [d for d, _ in got] == data
    assert [n for _, n in got] == outputs["total_bits"].sum(dim=1).tolist()
    for key in ref_encoder.RECON_KEYS + ("frame_coded",):
        np.testing.assert_array_equal(kept[key], outputs[key].numpy(),
                                      err_msg=key)


def test_the_port_equals_the_jax_package(encoded):
    """Each stream's bytes and every output against the JAX package's
    encode_to_bytes on the same configuration."""
    config, frames, data, outputs = encoded
    jcfg = jenc.EncoderConfig(
        fmt=JFORMATS[config["format"]], rate=JRateConfig(**config["rate"]),
        search=config["search"], intra_only=config["intra_only"],
        intra_period=config["intra_period"], emit_recon=True)
    for i in range(STREAMS):
        jdata, jout, _ = jenc.encode_to_bytes(
            jcfg, {k: jnp.asarray(v[i].numpy()) for k, v in frames.items()})
        assert data[i] == jdata
        assert set(outputs) == set(jout)
        for k, want in jout.items():
            got, want = outputs[k][i].numpy(), np.asarray(want)
            if k == "sse_y":
                # the JAX float32 sum rounds in another order
                np.testing.assert_allclose(got, want, rtol=1e-5)
            else:
                assert got.dtype == want.dtype, k
                np.testing.assert_array_equal(got, want, err_msg=k)


def test_the_batch_encode_equals_the_reference(encoded):
    """The benchmark's path, encode_resilient on a CPU mesh in chunks that
    split the streams, gives the reference's (bytes, nbits) per stream."""
    config, frames, data, _ = encoded
    cfg = entries.port_config(_config())
    got = encode_resilient(cfg, {k: v.numpy() for k, v in frames.items()},
                           dm.make_mesh(devices=[torch.device("cpu")]),
                           chunk=CHUNK)
    want, _ = entries.reference_encode(config, frames)
    assert got == want
    assert [d for d, _ in got] == data


def _traced_count(cfg, outputs):
    """The counter's rise in serialize_streams, untraced (None where it
    did not move) and traced."""
    before = trace.counters().get(COUNTER)
    enc.serialize_streams(cfg, outputs)
    after = trace.counters().get(COUNTER)
    untraced = None if after == before else after - (before or 0)
    with profile(activities=[ProfilerActivity.CPU]):
        enc.serialize_streams(cfg, outputs)
    return untraced, trace.counters()[COUNTER] - (after or 0)


def test_serialize_counts_the_coded_frames(encoded):
    """p64.rate.coded_frames is the sum of frame_coded while tracing is
    on, and is not touched while it is off."""
    config, _, _, outputs = encoded
    untraced, traced = _traced_count(entries.port_config(config), outputs)
    assert untraced is None
    coded = int(outputs["frame_coded"].sum())
    assert traced == coded < STREAMS * FRAMES


def test_a_fixed_quantizer_counts_every_frame():
    config = _config("cif_q10.encode", format="QCIF")
    cfg = entries.port_config(config)
    _, outputs = enc.encode_sequence(cfg, _frames(frames=2), device="cpu")
    assert _traced_count(cfg, outputs) == (None, STREAMS * 2)


# ---------------------------------------------------------------------------
# the reader, on a synthetic whole trace and program log
# ---------------------------------------------------------------------------

MS = 1_000_000


def _reading(launches=1, frames=FRAMES):
    """A 10 ms window with one one-kernel graph replay, read as a trace of
    `launches` replays."""
    ev = [tracing.Event(tracing.WINDOW, "annotation", 0, 10 * MS),
          tracing.Event("cudaGraphLaunch", "runtime", MS, MS + 5_000, 1),
          tracing.Event("step_kernel", "kernel", MS + 10_000, MS + 90_000,
                        1)]
    return harness.Reading(tracing.read_trace(ev, launches), {},
                           dict(frames=frames), {})


def _program(monkeypatch, counters, jobs=((1.0, 4.0),)):
    log = [trace.Span("p64.encode.job", int(s * MS), int(e * MS), 11, i,
                      None, i) for i, (s, e) in enumerate(jobs, 1)]
    monkeypatch.setattr(trace, "spans", lambda: list(log))
    monkeypatch.setattr(trace, "counters", lambda: dict(counters))


@pytest.mark.parametrize("count,streams,frames,want", [
    (8_648, 512, 32, 0.52783203125), (4_096, 128, 32, 1.0),
    (0, 4, 3, 0.0), (7, 2, 4, 0.875)])
def test_reader_reads_the_share(monkeypatch, count, streams, frames, want):
    _program(monkeypatch, {COUNTER: count, "p64.serialize.streams": streams})
    got = harness.Manifest().reader(READER)(_reading(frames=frames))
    assert got == pytest.approx(want, rel=1e-12)


def test_reader_reads_what_serialize_counted(monkeypatch, encoded):
    """The reader over the counters a traced serialize of the fixture's
    outputs added: the share of its frames coded."""
    config, _, _, outputs = encoded
    before = trace.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        enc.serialize_streams(entries.port_config(config), outputs)
    added = {k: v - before.get(k, 0) for k, v in trace.counters().items()}
    _program(monkeypatch, added)
    got = harness.Manifest().reader(READER)(_reading())
    coded = outputs["frame_coded"].numpy()
    assert got == pytest.approx(coded.mean(), rel=1e-12)
    assert 0 < got < 1


@pytest.mark.parametrize("case", ["no_trace_module", "no_counter",
                                  "no_streams", "no_job_span", "not_whole"])
def test_reader_reads_none_without_what_it_reads(monkeypatch, case):
    counters = {COUNTER: 12, "p64.serialize.streams": 2}
    reading = _reading()
    if case == "no_trace_module":
        # a program without the trace module
        monkeypatch.delattr(sys.modules["p64tpu_torch"], "trace")
        monkeypatch.setitem(sys.modules, "p64tpu_torch.trace", None)
    elif case == "no_counter":
        # a program before this counter: the other rate counters only
        _program(monkeypatch, {"p64.serialize.streams": 2,
                               "p64.rate.stuffing_codes": 5})
    elif case == "no_streams":
        _program(monkeypatch, {COUNTER: 12})
    elif case == "no_job_span":
        _program(monkeypatch, counters, jobs=())
    else:
        _program(monkeypatch, counters)
        reading = _reading(launches=2)
    assert harness.Manifest().reader(READER)(reading) is None


# ---------------------------------------------------------------------------
# the manifest
# ---------------------------------------------------------------------------

ENCODE_READERS = {
    "encode_step_ms", "sad_search_roofline", "device_idle_pct.encode",
    "frames_in_ms.encode", "host_wait_ms.encode", "symbols_ms.encode",
    "serialize_ms.encode", "finalize_idle_pct.encode",
    "host_card_bytes_per_mb.encode", "stuffing_codes_per_frame.encode",
    "chain_kernel_gobs_per_frame.encode", READER}
DECODE_READERS = {
    "decode_step_ms", "device_idle_pct.decode", "native_parse_ms.decode",
    "stack_ms.decode", "host_wait_ms.decode", "planes_out_ms.decode",
    "parse_idle_pct.decode", "host_card_bytes_per_mb.decode",
    "packed_mb_share.decode", "planes_pinned_share.decode"}


def test_the_configuration():
    """The file keeps cif_rc_p16's keys, reduces nothing, and states what
    the manifest entry states."""
    m = harness.Manifest()
    config = m.config(CELL)
    assert set(config) == set(m.config("cif_rc_p16.encode"))
    assert config["reduced"] == [] == m.configs["qcif_p2"]["reduced"]
    assert config["source"] == m.configs["qcif_p2"]["source"]
    assert len(config["source"]) <= 200
    assert (config["format"], config["search"], config["intra_only"],
            config["intra_period"], config["emit_recon"]) == (
        "QCIF", 15, False, 0, False)
    assert config["rate"] == dict(bit_rate=128_000, frame_rate=30)
    assert config["assumed"]["streams_per_card"] == m.traffic(CELL)[
        "streams"] == 512


def test_the_cells_and_their_metrics():
    """The videophone cell reports the encode readers named for it and the
    archive cell the decode readers; the coded-frame share is listed for
    the three rate encode cells exactly."""
    m = harness.Manifest()
    cells = {c: {x["name"] for x in m.per_layer(c)} for c in m.cells}
    assert cells[CELL] == ENCODE_READERS
    assert cells["cif_q10.decode"] == DECODE_READERS
    assert {c for c, names in cells.items() if READER in names} == set(
        RATE_CELLS)
    assert m.cells[CELL]["chips"] == m.cells["cif_q10.decode"]["chips"] == 1
    assert m.traffic(CELL) == dict(
        entry="batch_encode", rate_metric="encode_mb_per_s", streams=512,
        frames=32, chunk=128, noise=16, trace_jobs=2, span_jobs=3)
    assert m.cells["cif_q10.decode"]["traffic"] == "decode"
    entry = next(x for x in m.data["per_layer"] if x["name"] == READER)
    assert (entry["unit"], entry["better"], entry["source"], entry["layer"],
            entry["moves"]) == ("share", "higher", "program_counter",
                                "frame loop", "encode_mb_per_s")
