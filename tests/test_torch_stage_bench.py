"""The port's stage bench (`p64tpu_torch.tools.stage_bench`) against the
JAX stage bench (`tools/stage_bench.py`, loaded from its file, not edited)
on the CPU: at 1 CIF stream and 2 iterations every stage's checksum equals
the JAX tool's.  Two of the port's stage inputs follow the port's kernel
contracts (the module docstring says why); the JAX tool runs with the same
two rules patched in for this comparison: the ME plane cast to uint8
modulo 256, and the MC / reconstruction motion vectors clipped into the
picture.  Every other stage runs the JAX tool as it is."""

import contextlib
import importlib.util
import io
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p64tpu.core import predict as jpredict
from p64tpu.core import reconstruct as jreconstruct
from p64tpu.kernels import me as jme
from p64tpu_torch.spec.constants import CIF, MB_SIZE
from p64tpu_torch.tools import stage_bench

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_stage_bench", os.path.join(REPO, "tools", "stage_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_legal(mv):
    """legal_mvs for one stream's (nMB, 2) vectors, in jnp."""
    idx = jnp.arange(CIF.num_mbs)
    y0 = (idx // CIF.mb_cols) * MB_SIZE
    x0 = (idx % CIF.mb_cols) * MB_SIZE
    return jnp.stack([jnp.clip(mv[:, 0], -x0, CIF.width - MB_SIZE - x0),
                      jnp.clip(mv[:, 1], -y0, CIF.height - MB_SIZE - y0)],
                     axis=-1).astype(mv.dtype)


@pytest.fixture(scope="module")
def jax_checksums():
    """stage -> the JAX stage bench's logged checksum (low 16 bits) at 1
    stream, 2 iterations."""
    tool = _jax_tool()
    full_search = jme.full_search
    mc_predict = jpredict.mc_predict
    reconstruct_frame = jreconstruct.reconstruct_frame

    def me_uint8(cy, ry, *rest):
        return full_search((cy & 255).astype(jnp.uint8), ry, *rest)

    def mc_legal(ry, rcb, rcr, mv, *rest, **kw):
        return mc_predict(ry, rcb, rcr, _jax_legal(mv), *rest, **kw)

    def recon_legal(fmt, lv, q, im, mv, *rest, **kw):
        return reconstruct_frame(fmt, lv, q, im, _jax_legal(mv), *rest, **kw)

    err = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tool, "STREAMS", 1)
        mp.setattr(tool, "ITERS", 2)
        mp.setattr(jme, "full_search", me_uint8)
        mp.setattr(jpredict, "mc_predict", mc_legal)
        mp.setattr(jreconstruct, "reconstruct_frame", recon_legal)
        with contextlib.redirect_stderr(err):
            assert tool.main(["stage_bench.py"]) == 0
    got = dict(re.findall(r"^(\w+): [\d.]+ ms/iter  \(checksum (\d+)\)$",
                          err.getvalue(), re.M))
    assert list(got) == list(stage_bench.STAGES), err.getvalue()
    return {k: int(v) for k, v in got.items()}


@pytest.fixture(scope="module")
def port_results():
    return stage_bench.run_stages(stage_bench.STAGES, 1, 2, device="cpu")


@pytest.mark.parametrize("stage", stage_bench.STAGES)
def test_stage_checksum_equals_jax(stage, jax_checksums, port_results):
    res = port_results[stage]
    assert res.checksum & 0xffff == jax_checksums[stage]
    assert -(1 << 31) <= res.checksum < (1 << 31)
    assert res.device_ms is None and res.busy_ms is None
    assert res.wall_ms > 0


def test_legal_mvs_keep_blocks_inside_and_legal_ones_unchanged():
    rng = np.random.default_rng(3)
    mv = torch.as_tensor(rng.integers(-15, 16, (2, CIF.num_mbs, 2),
                                      np.int32))
    got = stage_bench.legal_mvs(CIF, mv)
    assert got.dtype == torch.int32
    idx = np.arange(CIF.num_mbs)
    y = (idx // CIF.mb_cols) * MB_SIZE + got[..., 1].numpy()
    x = (idx % CIF.mb_cols) * MB_SIZE + got[..., 0].numpy()
    assert (y >= 0).all() and (y + MB_SIZE <= CIF.height).all()
    assert (x >= 0).all() and (x + MB_SIZE <= CIF.width).all()
    inside = got == mv
    assert inside.any() and not inside.all()
    assert torch.equal(stage_bench.legal_mvs(CIF, got), got)
    np.testing.assert_array_equal(
        np.asarray(_jax_legal(jnp.asarray(mv[1].numpy()))), got[1].numpy())


def test_run_stages_refuses_unknown_stage():
    with pytest.raises(ValueError, match="unknown stages"):
        stage_bench.run_stages(["fdct", "nope"], 1, 1, device="cpu")


def test_uint8_cast_wraps_modulo_256():
    """frame_step's and me_full_search's plane (cur_y + pert) reaches 511;
    the port takes it modulo 256, as the JAX tool's astype(uint8) does."""
    v = torch.tensor([0, 255, 256, 300, 511], dtype=torch.int32)
    got = (v & 255).to(torch.uint8)
    assert got.tolist() == [0, 255, 0, 44, 255]
    want = np.asarray(jnp.asarray(v.numpy()).astype(jnp.uint8))
    assert got.tolist() == want.tolist()


def test_main_exits_2_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert stage_bench.main([]) == 2
    out, err = capsys.readouterr()
    assert out == "" and "no CUDA device" in err
