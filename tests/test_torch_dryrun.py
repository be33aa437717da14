"""The port's single-device compile check and multi-device dry run
(`p64tpu_torch.tools.dryrun`) on the CPU, against the JAX package's
(`__graft_entry__.py`): the dry run over 8 logical CPU shards gives the
JAX bit total, coded count and per-stream bytes of the same content; the
entry step equals the JAX entry step in every output and the new state,
also from a carried state; the CLI runs on the CPU, and without a card the
default refuses."""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as jentry
from p64tpu.control.ratecontrol import RateConfig as JRateConfig
from p64tpu.core import encoder as jenc
from p64tpu.distrib import mesh as jdm
from p64tpu.spec.constants import QCIF as JQCIF
from p64tpu_torch.core import encoder as enc
from p64tpu_torch.tools import dryrun

torch.set_num_threads(1)

N = 8
#: the JAX package's dry run at 8 devices (MULTICHIP_r05.json)
JAX_BITS, JAX_CODED = 798_196, 8


@pytest.fixture(scope="module")
def port_run():
    return dryrun.dryrun_multichip(N, devices=["cpu"] * N)


def test_jax_dry_run_totals_equal_the_port(port_run, capsys):
    jentry.dryrun_multichip(N)
    line = capsys.readouterr().out
    m = re.search(r"(\d+) frames coded\), (\d+) total bits", line)
    assert m, line
    assert (int(m.group(2)), int(m.group(1))) == (JAX_BITS, JAX_CODED)
    assert (port_run["total_bits"], port_run["frames_coded"]) == (
        JAX_BITS, JAX_CODED)
    assert sum(n for _, n in port_run["streams"]) == JAX_BITS


def test_port_dry_run_bytes_equal_the_jax_mesh(port_run):
    cfg = dryrun.dryrun_config()
    jcfg = jenc.EncoderConfig(
        fmt=JQCIF, search=cfg.search,
        rate=JRateConfig(bit_rate=cfg.rate.bit_rate,
                         frame_rate=cfg.rate.frame_rate,
                         mquant_segments=cfg.rate.mquant_segments))
    mesh = jdm.make_mesh(N)
    frames = {k: jnp.asarray(v) for k, v in dryrun.dryrun_content(N).items()}
    _, outputs, agg = jdm.make_sharded_encoder(jcfg, mesh)(
        jdm.shard_batch(mesh, jdm.init_states(jcfg, N)),
        jdm.shard_batch(mesh, frames))
    want = jdm.serialize_streams(jcfg, outputs)
    assert port_run["streams"] == want
    assert jdm.agg_total_bits(agg) == port_run["total_bits"]
    assert int(agg["frames_coded"]) == port_run["frames_coded"]


def _assert_step_equal(got, want):
    (state, out), (jstate, jout) = got, want
    assert set(out) == set(jout)
    for k, w in jout.items():
        g, w = out[k][0].numpy(), np.asarray(w)
        assert g.shape == w.shape, k
        if k == "sse_y":
            # the JAX float32 sum rounds in another order
            np.testing.assert_allclose(g, w, rtol=1e-5)
        else:
            assert g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)
    for k, v in enc.state_to_numpy(state).items():
        np.testing.assert_array_equal(v[0], np.asarray(jstate[k]), err_msg=k)


def test_entry_step_equals_the_jax_entry_step():
    fn, args = dryrun.entry(device="cpu")
    jfn, jargs = jentry.entry()
    jstep = jax.jit(jfn)
    want = jstep(*jargs)
    got = dryrun.compile_check(fn, args)
    _assert_step_equal(got, want)
    # the JAX step's new state carried into the port, on a frame with
    # content (the dry run's first stream, second frame)
    content = dryrun.dryrun_content(1)
    frame = {k: v[:, 1] for k, v in content.items()}
    state = enc.state_from_numpy(
        {k: np.asarray(v) for k, v in want[0].items()}, "cpu")
    got = dryrun.compile_check(
        fn, (state, {k: torch.as_tensor(v) for k, v in frame.items()}))
    _assert_step_equal(got, jstep(want[0], {k: jnp.asarray(v[0])
                                            for k, v in frame.items()}))


def test_cli_on_cpu_shards(capsys):
    assert dryrun.main(["--device", "cpu", "4"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    assert lines[0].startswith("dryrun_multichip OK: 4 devices (1 distinct: "
                               "cpu), production shape (search=15, t=2, ")
    assert lines[0].endswith(" total bits")


def test_without_a_card_the_default_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(N)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.entry()


def test_shards_take_distinct_cards_first(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert dryrun.shard_devices(8) == tuple(
        torch.device("cuda", i) for i in (0, 1, 2, 0, 1, 2, 0, 1))
