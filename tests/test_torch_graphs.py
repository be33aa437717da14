"""The captured-program runner (`p64tpu_torch.core.graphs`) on the CPU,
where it runs with capture off: copy-in, state carry, copy-out, fresh
results and the program cache, held to the eager loops and to the JAX
package's compiled programs (`encode_sequence_jit`, `_decode_scan_batch`),
exactly (the JAX package's float32 `sse_y` sum to 1e-5, as in
test_torch_encoder); and a static guard that the frame step has no host
sync, which would break a capture on the card."""

import ast
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from p64tpu.control.ratecontrol import RateConfig as JRateConfig
from p64tpu.core import decoder as jdec
from p64tpu.core import encoder as jenc
from p64tpu.spec import constants as jconstants
from p64tpu_torch.control.ratecontrol import RateConfig
from p64tpu_torch.core import decoder, encoder, graphs
from p64tpu_torch.spec import constants
from p64tpu_torch.spec.luts import MTYPE_MQUANT
from p64tpu_torch.tools.content import make_content

import rate_goldens

torch.set_num_threads(1)

T = 3

#: name -> (format, streams, EncoderConfig fields, content): QCIF at a
#: fixed quantizer and search 7; CIF under rate control with 3 MQUANT
#: segments, where the noise stream skips frames; intra only
CASES = {
    "qcif_q10_s7": ("QCIF", 4, dict(search=7, rate=dict(fixed_quant=10)),
                    "bench"),
    "cif_rc_mquant3_skip": ("CIF", 2, dict(search=7, rate=dict(
        bit_rate=1_024_000, mquant_segments=3)), "noise+bench"),
    "qcif_intra": ("QCIF", 2, dict(intra_only=True,
                                   rate=dict(fixed_quant=6)), "bench"),
}


def _frames(fmt_name, streams, content, t=T, seed=5):
    fmt = getattr(constants, fmt_name)
    frames = make_content(fmt, streams, t)
    if content == "noise+bench":
        rng = np.random.default_rng(seed)
        y = rng.integers(0, 256, (t, fmt.height, fmt.width)).astype(np.uint8)
        frames["y"][0] = y
        frames["cb"][0] = y[:, ::2, ::2]
        frames["cr"][0] = y[:, 1::2, ::2]
    return frames


def _configs(fmt_name, fields):
    rate = fields.get("rate", {})
    rest = {k: v for k, v in fields.items() if k != "rate"}
    return (encoder.EncoderConfig(fmt=getattr(constants, fmt_name),
                                  rate=RateConfig(**rate), **rest),
            jenc.EncoderConfig(fmt=getattr(jconstants, fmt_name),
                               rate=JRateConfig(**rate), **rest))


def _assert_same(got, want, what):
    assert got.keys() == want.keys(), what
    for k in want:
        assert got[k].dtype == want[k].dtype, (what, k)
        assert torch.equal(got[k], want[k]), (what, k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_graphed_encode_equals_eager_and_jax(case):
    fmt_name, streams, fields, content = CASES[case]
    tcfg, jcfg = _configs(fmt_name, fields)
    frames = _frames(fmt_name, streams, content)
    cache = graphs.ProgramCache()
    state, out = encoder.encode_sequence_graphed(tcfg, frames, device="cpu",
                                                 cache=cache)
    want_state, want = encoder.encode_sequence_eager(tcfg, frames,
                                                     device="cpu")
    _assert_same(out, want, "outputs")
    _assert_same(state, want_state, "final state")
    assert cache.builds == 1
    if case == "cif_rc_mquant3_skip":
        assert not bool(out["frame_coded"].all())          # a skip
        assert MTYPE_MQUANT[out["mtype"].numpy()][out["coded"].numpy()].any()
    for i in range(streams):
        jstate, jout = jenc.encode_sequence_jit(
            jcfg, {k: jnp.asarray(v[i]) for k, v in frames.items()},
            jenc.init_state(jcfg))
        assert set(jout) == set(out)
        for k, v in jout.items():
            if k == "sse_y":
                # the port's SSE is an exact integer cast to float32; JAX
                # sums in float32, which rounds above 2^24 (the noise
                # stream's skipped frames): test_torch_encoder's tolerance
                np.testing.assert_allclose(out[k][i].numpy(), np.asarray(v),
                                           rtol=1e-5)
            else:
                np.testing.assert_array_equal(out[k][i].numpy(),
                                              np.asarray(v), err_msg=k)
        for k, v in encoder.state_to_numpy(state).items():
            np.testing.assert_array_equal(v[i], np.asarray(jstate[k]),
                                          err_msg=k)


def _qcif():
    cfg, _ = _configs("QCIF", CASES["qcif_q10_s7"][2])
    return cfg, _frames("QCIF", 2, "bench", t=4)


def test_callers_state_is_left_unchanged():
    cfg, frames = _qcif()
    start = encoder.encode_sequence_eager(
        cfg, {k: v[:, :1] for k, v in frames.items()}, device="cpu")[0]
    copy = {k: v.clone() for k, v in start.items()}
    state, _ = encoder.encode_sequence_graphed(
        cfg, frames, start, device="cpu", cache=graphs.ProgramCache())
    _assert_same(start, copy, "the caller's state")
    assert not any(state[k].data_ptr() == start[k].data_ptr() for k in start)


def test_outputs_of_a_call_survive_the_next_call():
    cfg, frames = _qcif()
    other = {k: np.ascontiguousarray(v[:, ::-1]) for k, v in frames.items()}
    cache = graphs.ProgramCache()
    state1, out1 = encoder.encode_sequence_graphed(cfg, frames, device="cpu",
                                                   cache=cache)
    keep = ({k: v.clone() for k, v in state1.items()},
            {k: v.clone() for k, v in out1.items()})
    encoder.encode_sequence_graphed(cfg, other, device="cpu", cache=cache)
    assert cache.builds == 1                         # the same program
    _assert_same(state1, keep[0], "call 1's final state")
    _assert_same(out1, keep[1], "call 1's outputs")


def test_two_resumed_halves_equal_one_call():
    cfg, jcfg = _configs("CIF", CASES["cif_rc_mquant3_skip"][2])
    frames = _frames("CIF", 2, "noise+bench", t=4)
    cache = graphs.ProgramCache()
    want_state, want = encoder.encode_sequence_graphed(
        cfg, frames, device="cpu", cache=cache)
    st, first = encoder.encode_sequence_graphed(
        cfg, {k: v[:, :2] for k, v in frames.items()}, device="cpu",
        cache=cache)
    st, second = encoder.encode_sequence_graphed(
        cfg, {k: v[:, 2:] for k, v in frames.items()}, st, device="cpu",
        cache=cache)
    _assert_same(st, want_state, "resumed final state")
    _assert_same({k: torch.cat([first[k], second[k]], dim=1) for k in want},
                 want, "resumed outputs")


def test_program_cache_keys_and_releases_least_recently_used():
    frames = _frames("QCIF", 1, "bench", t=2)
    cfgs = [_configs("QCIF", dict(search=s, rate=dict(fixed_quant=10)))[0]
            for s in (1, 2, 3)]
    cache = graphs.ProgramCache(size=2)

    def programs():
        return [p for _, p in cache.items()]

    encoder.encode_sequence_graphed(cfgs[0], frames, device="cpu",
                                    cache=cache)
    encoder.encode_sequence_graphed(cfgs[1], frames, device="cpu",
                                    cache=cache)
    a, b = programs()
    encoder.encode_sequence_graphed(cfgs[0], frames, device="cpu",
                                    cache=cache)
    assert programs() == [b, a] and cache.builds == 2     # a hit, moved up
    two = _frames("QCIF", 2, "bench", t=2)             # another stream count
    encoder.encode_sequence_graphed(cfgs[0], two, device="cpu", cache=cache)
    assert cache.builds == 3 and programs()[0] is a     # b released
    assert [k for k, _ in cache.items()] == [
        ("encode", cfgs[0], 1, torch.device("cpu")),
        ("encode", cfgs[0], 2, torch.device("cpu"))]


def test_program_cache_is_bounded_per_device():
    """The encoder keys of an 8-card mesh, two calls: each card keeps its
    program, so the second call builds none (a bound of 4 in all would
    evict on every shard and build 16)."""
    cache = graphs.ProgramCache()
    cards = [torch.device("cuda", i) for i in range(8)]
    built = []
    for _ in range(2):
        for dev in cards:
            cache.get(("encode", "cfg", 1, dev),
                      lambda dev=dev: built.append(dev) or dev, dev)
    assert cache.builds == 8 and built == cards and len(cache) == 8


def test_program_cache_evicts_per_device_least_recently_used():
    """5 keys on one device evict down to `size`, least recently used
    first; the programs of another device stay."""
    cache = graphs.ProgramCache()
    cache.get("other", lambda: "other", torch.device("cuda", 1))
    dev = torch.device("cuda", 0)
    for k in range(4):
        cache.get(k, lambda k=k: k, dev)
    cache.get(0, lambda: "rebuilt", dev)             # a hit, moved up
    cache.get(4, lambda: 4, dev)                      # 1 is released
    assert [k for k, _ in cache.items()] == ["other", 2, 3, 0, 4]
    assert cache.builds == 6 and len(cache) == 5


def test_a_failed_build_leaves_nothing_cached():
    def broken(state, frame):
        raise RuntimeError("step fails")

    cache = graphs.ProgramCache()
    state = {"a": torch.zeros(2)}
    with pytest.raises(RuntimeError, match="step fails"):
        graphs.run("k", broken, state, {"x": torch.zeros(2, 3)}, axis=1,
                   cache=cache)
    assert len(cache) == 0 and cache.builds == 0


def _passthrough(state, frame):
    """A step whose new state passes one tensor through unchanged and
    whose outputs are static buffers themselves."""
    b = state["b"] + frame["x"]
    return {"a": state["a"], "b": b}, {"a": state["a"], "old_b": state["b"],
                                       "x": frame["x"], "b": b}


def test_a_state_copied_onto_itself_and_aliased_outputs():
    rng = np.random.default_rng(0)
    state = {"a": torch.as_tensor(rng.integers(0, 9, (2, 3))),
             "b": torch.zeros((2, 3), dtype=torch.int64)}
    xs = {"x": torch.as_tensor(rng.integers(0, 9, (2, 4, 3)))}
    final, out = graphs.run("toy", _passthrough, state, xs, axis=1,
                            cache=graphs.ProgramCache())
    st, want = dict(state), {}
    for i in range(4):
        st, o = _passthrough(st, {"x": xs["x"][:, i]})
        for k, v in o.items():
            want.setdefault(k, []).append(v)
    _assert_same(final, st, "final state")
    _assert_same(out, {k: torch.stack(v, dim=1) for k, v in want.items()},
                 "outputs")


def test_entry_points_on_the_cpu_do_not_capture(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CPU path went through core.graphs")

    monkeypatch.setattr(graphs, "run", refuse)
    cfg, frames = _qcif()
    _, out = encoder.encode_sequence(cfg, frames, device="cpu")
    seqs = [decoder.parse_to_tensors(d)[2] for d in
            encoder.encode_to_bytes(cfg, frames, device="cpu")[0]]
    planes = decoder.reconstruct_seq(
        cfg.fmt, decoder.stack_seqs(cfg.fmt, seqs, "cpu"))
    for got, k in zip(planes, encoder.RECON_KEYS):
        assert torch.equal(got, out[k])


def _decode_batch():
    cfg, _ = _configs("QCIF", dict(search=15, rate=dict(bit_rate=192_000)))
    datas = encoder.encode_to_bytes(cfg, _frames("QCIF", 3, "bench", t=4),
                                    device="cpu")[0]
    return [decoder.parse_to_tensors(d)[2] for d in datas]


def test_graphed_reconstruct_equals_eager_and_jax():
    seqs = _decode_batch()
    fmt = constants.QCIF
    batch = decoder.stack_seqs(fmt, seqs, "cpu")
    cache = graphs.ProgramCache()
    got = decoder.reconstruct_seq_graphed(fmt, batch, cache=cache)
    want = decoder.reconstruct_seq_eager(fmt, batch)
    jy, jcb, jcr = jdec._decode_scan_batch(
        jconstants.QCIF, {k: jnp.stack([jnp.asarray(s[k]) for s in seqs])
                          for k in decoder.SEQ_KEYS})
    for g, w, j in zip(got, want, (jy, jcb, jcr)):
        assert torch.equal(g, w)
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    # resumed from planes: the second half from the first half's last frame
    half = {k: v[2:] for k, v in batch.items()}
    init = tuple(p[:, 1].contiguous() for p in want)
    for g, w in zip(decoder.reconstruct_seq_graphed(fmt, half, init,
                                                    cache=cache),
                    want):
        assert torch.equal(g, w[:, 2:])
    assert cache.builds == 1


#: the modules one frame step reaches (core.graphs captures it), and the
#: host-side functions in them that may read the device
STEP_MODULES = ("core/encoder.py", "core/predict.py", "core/reconstruct.py",
                "core/blocks.py", "kernels/me.py", "kernels/me_cuda.py",
                "kernels/rate_chain_cuda.py", "kernels/dct.py", "kernels/quant.py", "kernels/filter.py",
                "control/decisions.py", "control/ratecontrol.py",
                "entropy/lengths.py")
HOST_FUNCTIONS = {"state_from_numpy", "state_to_numpy", "outputs_to_host",
                  "outputs_to_symbols", "serialize_streams",
                  "encode_to_bytes"}
#: calls that wait for the device or copy to the host
SYNCING = {"item", "tolist", "cpu", "numpy", "nonzero", "synchronize"}
PORT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "p64tpu_torch")


def _syncing_calls(src, path="<src>"):
    tree = ast.parse(src, path)
    found = []

    def walk(node, host):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            host = host or node.name in HOST_FUNCTIONS
        if (isinstance(node, ast.Call) and not host
                and isinstance(node.func, (ast.Attribute, ast.Name))):
            name = (node.func.attr if isinstance(node.func, ast.Attribute)
                    else node.func.id)
            if name in SYNCING:
                found.append((node.lineno, name))
        for child in ast.iter_child_nodes(node):
            walk(child, host)

    walk(tree, False)
    return found


@pytest.mark.parametrize("module", STEP_MODULES)
def test_the_frame_step_has_no_host_sync(module):
    path = os.path.join(PORT, module)
    with open(path) as f:
        assert _syncing_calls(f.read(), path) == []


def test_the_sync_guard_sees_a_sync():
    src = ("def step(x):\n"
           "    return x.sum().item() + torch.nonzero(x)\n"
           "def outputs_to_host(x):\n"
           "    return x.cpu()\n")
    assert _syncing_calls(src) == [(2, "item"), (2, "nonzero")]


@pytest.mark.parametrize("nseg", rate_goldens.SEGMENTS)
def test_rate_goldens_are_the_jax_package_and_the_port(nseg):
    """tests/rate_goldens.json, which the card's encode through the rate
    chain's kernels is held to (test_torch_cuda), is what the JAX package
    and the port's CPU encode (the plain chain) give; the case codes every
    frame, and with 3 segments sends MQUANT."""
    want = rate_goldens.pinned()[str(nseg)]
    assert rate_goldens.jax_digests(nseg) == want
    frames = {k: torch.as_tensor(v) for k, v in rate_goldens.frames().items()}
    state, out = encoder.encode_sequence_graphed(
        rate_goldens.config(nseg), frames, device="cpu",
        cache=graphs.ProgramCache())
    assert rate_goldens.port_digests(state, out) == want
    assert bool(out["frame_coded"].all())
    mquant = MTYPE_MQUANT[out["mtype"].numpy()] & out["coded"].numpy()
    assert mquant.any() == (nseg > 1)


def test_capture_probe_exits_2_without_a_card(monkeypatch, capsys):
    """The capture probe times the card's graph capture: without a card
    it prints nothing on stdout and exits 2, as it does for an unknown
    variant."""
    from p64tpu_torch.tools import capture_probe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert capture_probe.main([]) == 2
    out, err = capsys.readouterr()
    assert out == "" and "no CUDA device" in err
    assert capture_probe.main(["base16", "xla_me"]) == 2
    out, err = capsys.readouterr()
    assert out == "" and "unknown variants ['xla_me']" in err
