"""The E1 room-system deployment on the port's CPU path: the benchmark's
`cif_rc_p30_mq3` (H.261 at p = 30, 1,920 kbit/s, CIF at 30 Hz, three MQUANT
segments a GOB) over its textured traffic, and QCIF at a quarter of the rate.
The port's bytes, bit counts and reconstruction equal the benchmark's plain
reference and the JAX package; the texture makes the buffer law, not MBA
stuffing, fill the channel; `serialize_streams` counts the rate control's
MQUANT MBs and stuffing codes while tracing is on; the batch serializer
equals the per-stream engine; the two readers of those counters."""

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
from p64tpu_torch.entropy.encode import serialize_sequence
from p64tpu_torch.native import load_batch
from p64tpu_torch.spec.luts import MTYPE_MQUANT
from port_bench import entries, harness, tracing
from port_bench.content import make_content
from port_bench.reference import encoder as ref_encoder

torch.set_num_threads(1)

CELL = "cif_rc_p30_mq3.encode"
STREAMS, FRAMES = 2, 4
SEED = 2**31 + 20
#: the rate of each picture format: the configuration's, and a quarter of
#: it for QCIF, a quarter of the macroblocks
RATE_SHARE = {"CIF": 1, "QCIF": 4}
STUFF_BITS = 11
READERS = ("mquant_mbs_per_frame.encode", "stuffing_codes_per_frame.encode")
COUNTERS = {"mquant_mbs_per_frame.encode": "p64.rate.mquant_mbs",
            "stuffing_codes_per_frame.encode": "p64.rate.stuffing_codes"}


def _config(fmt, cell=CELL):
    config = dict(harness.Manifest().config(cell), format=fmt,
                  emit_recon=True)
    if config["rate"].get("bit_rate"):
        config["rate"] = dict(config["rate"], bit_rate=config["rate"][
            "bit_rate"] // RATE_SHARE[fmt])
    return config


def _frames(fmt, frames=FRAMES):
    noise = harness.Manifest().traffic(CELL)["noise"]
    h, w = (288, 352) if fmt == "CIF" else (144, 176)
    return make_content(h, w, STREAMS, frames, noise, SEED, "cpu")


def _mquant_mbs(outputs):
    """MBs per (stream, frame) coded with an MTYPE that carries MQUANT."""
    return (MTYPE_MQUANT[outputs["mtype"].numpy()]
            & outputs["coded"].numpy()).sum(axis=-1)


@pytest.fixture(scope="module", params=["CIF", "QCIF"])
def encoded(request):
    """(format, configuration, frames, the port's bytes, outputs)."""
    fmt = request.param
    config, frames = _config(fmt), _frames(fmt)
    data, outputs, _ = enc.encode_to_bytes(
        entries.port_config(config), {k: v.numpy() for k, v in
                                      frames.items()}, device="cpu")
    return fmt, config, frames, data, outputs


def test_the_port_equals_the_reference(encoded):
    """Bytes, bit counts and reconstruction of the port's encode_to_bytes
    against the benchmark's plain reference."""
    _, config, frames, data, outputs = encoded
    got, kept = entries.reference_encode(config, frames,
                                         keep=ref_encoder.RECON_KEYS)
    assert [d for d, _ in got] == data
    assert [n for _, n in got] == outputs["total_bits"].sum(dim=1).tolist()
    for key in ref_encoder.RECON_KEYS:
        np.testing.assert_array_equal(kept[key], outputs[key].numpy(),
                                      err_msg=key)


def test_the_port_equals_the_jax_package(encoded):
    """Each stream's bytes and every output against the JAX package's
    encode_to_bytes on the same configuration."""
    fmt, config, frames, data, outputs = encoded
    jcfg = jenc.EncoderConfig(
        fmt=JFORMATS[fmt], rate=JRateConfig(**config["rate"]),
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


def test_the_buffer_law_fills_the_channel(encoded):
    """At the traffic's texture every frame after the first carries MQUANT
    MBs, and stuffing is under 5% of the bits."""
    _, _, _, _, outputs = encoded
    assert outputs["frame_coded"].all()
    assert (_mquant_mbs(outputs)[:, 1:] > 0).all()
    stuffing = STUFF_BITS * int(outputs["n_stuff"].sum())
    assert stuffing < 0.05 * int(outputs["total_bits"].sum())


def _traced_counters(cfg, outputs):
    """The rate counters serialize_streams adds, untraced and traced."""
    names = tuple(COUNTERS.values())
    before = trace.counters()
    enc.serialize_streams(cfg, outputs)
    untraced = {k: trace.counters().get(k, 0) - before.get(k, 0)
                for k in names}
    before = trace.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        enc.serialize_streams(cfg, outputs)
    after = trace.counters()
    return untraced, {k: after[k] - before.get(k, 0) for k in names}


def test_serialize_counts_the_rate_control(encoded):
    """p64.rate.mquant_mbs is the coded MBs whose MTYPE carries MQUANT and
    p64.rate.stuffing_codes the sum of n_stuff, while tracing is on."""
    _, config, _, _, outputs = encoded
    untraced, traced = _traced_counters(entries.port_config(config), outputs)
    assert untraced == {k: 0 for k in COUNTERS.values()}
    mquant = int(_mquant_mbs(outputs).sum())
    assert mquant > 0
    assert traced == {"p64.rate.mquant_mbs": mquant,
                      "p64.rate.stuffing_codes":
                          int(outputs["n_stuff"].sum())}


def test_a_fixed_quantizer_counts_no_rate_control():
    config = _config("CIF", cell="cif_q10.encode")
    cfg = entries.port_config(config)
    frames = _frames("CIF", frames=2)
    _, outputs = enc.encode_sequence(cfg, frames, device="cpu")
    _, traced = _traced_counters(cfg, outputs)
    assert traced == {k: 0 for k in COUNTERS.values()}


def test_the_batch_serializer_equals_the_per_stream_engine(encoded):
    """Bytes per stream, and its MQUANT count per stream however the
    streams are split into ranges."""
    fmt, config, _, _, outputs = encoded
    cfg = entries.port_config(config)
    got = enc.serialize_streams(cfg, outputs)
    assert got == [serialize_sequence(cfg.fmt, syms)
                   for syms in enc.outputs_to_symbols(cfg, outputs)]
    host = {k: outputs[k].numpy() for k in enc.SYMBOL_KEYS}
    want = _mquant_mbs(outputs).sum(axis=1)
    engine = load_batch()
    for ranges in ([(0, STREAMS)], [(s, s + 1) for s in range(STREAMS)]):
        batch = engine.prepare(cfg.fmt, host)
        parts = [engine.run(batch, a, b) for a, b in ranges]
        batch.check()
        assert [r for p in parts for r in p] == got
        np.testing.assert_array_equal(batch.mquant_mbs, want)


# ---------------------------------------------------------------------------
# the two readers, on a synthetic whole trace and program log
# ---------------------------------------------------------------------------

MS = 1_000_000


def _reading(launches=1, replays=1, frames=3):
    """A 10 ms window with `replays` one-kernel graph replays, read as a
    trace of `launches` replays."""
    ev = [tracing.Event(tracing.WINDOW, "annotation", 0, 10 * MS)]
    for corr in range(1, replays + 1):
        ev.append(tracing.Event("cudaGraphLaunch", "runtime", corr * MS,
                                corr * MS + 5_000, corr))
        ev.append(tracing.Event("step_kernel", "kernel", corr * MS + 10_000,
                                corr * MS + 90_000, corr))
    return harness.Reading(tracing.read_trace(ev, launches), {},
                           dict(frames=frames), {})


def _program(monkeypatch, counters, jobs=((1.0, 4.0),)):
    log = [trace.Span("p64.encode.job", int(s * MS), int(e * MS), 11, i,
                      None, i) for i, (s, e) in enumerate(jobs, 1)]
    monkeypatch.setattr(trace, "spans", lambda: list(log))
    monkeypatch.setattr(trace, "counters", lambda: dict(counters))


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("count,streams,frames,want", [
    (30, 4, 3, 2.5), (0, 4, 3, 0.0), (7, 1, 2, 3.5)])
def test_reader_reads_the_counter_per_stream_frame(monkeypatch, name, count,
                                                   streams, frames, want):
    _program(monkeypatch, {COUNTERS[name]: count,
                           "p64.serialize.streams": streams})
    got = harness.Manifest().reader(name)(_reading(frames=frames))
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("case", ["no_trace_module", "no_counter",
                                  "no_streams", "no_job_span", "not_whole"])
def test_reader_reads_none_without_what_it_reads(monkeypatch, name, case):
    counters = {COUNTERS[name]: 12, "p64.serialize.streams": 2}
    reading = _reading()
    if case == "no_trace_module":
        # a program without the trace module
        monkeypatch.delattr(sys.modules["p64tpu_torch"], "trace")
        monkeypatch.setitem(sys.modules, "p64tpu_torch.trace", None)
    elif case == "no_counter":
        # a program before the rate counters: its other counters only
        _program(monkeypatch, {"p64.serialize.streams": 2})
    elif case == "no_streams":
        _program(monkeypatch, {COUNTERS[name]: 12})
    elif case == "no_job_span":
        _program(monkeypatch, counters, jobs=())
    else:
        _program(monkeypatch, counters)
        reading = _reading(launches=2)
    assert harness.Manifest().reader(name)(reading) is None


#: the cells that list each reader, exactly: MQUANT in the two CIF rate
#: cells; stuffing in those and the QCIF videophone, whose GOBs never
#: change the quantizer mid-GOB
LISTED = {"mquant_mbs_per_frame.encode": {CELL, "cif_rc_p16.encode"},
          "stuffing_codes_per_frame.encode": {CELL, "cif_rc_p16.encode",
                                              "qcif_p2.encode"}}


def test_the_cells_and_their_configuration():
    """The configuration file keeps cif_rc_p16's keys, reduces nothing and
    is named by its manifest entry; each reader is reported by exactly the
    cells LISTED gives, all batch encode cells without the finalize
    re-run."""
    m = harness.Manifest()
    config = m.config(CELL)
    assert set(config) == set(m.config("cif_rc_p16.encode"))
    assert config["reduced"] == [] == m.configs["cif_rc_p30_mq3"]["reduced"]
    assert config["source"] == m.configs["cif_rc_p30_mq3"]["source"]
    assert config["rate"] == dict(bit_rate=1_920_000, frame_rate=30,
                                  mquant_segments=3)
    names = {c: [x["name"] for x in m.per_layer(c)] for c in m.cells}
    for reader in READERS:
        assert {c for c in m.cells if reader in names[c]} == LISTED[
            reader], reader
    for cell in set().union(*LISTED.values()):
        assert "finalize_ms.encode" not in names[cell]
        assert m.traffic(cell)["entry"] == "batch_encode"
