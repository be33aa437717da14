"""The PyTorch port runs where JAX is not installed (the GPU host has none)
and without the JAX package: in a fresh interpreter whose import system
refuses `jax`, `jaxlib`, `p64tpu` and every `p64tpu.*`, the port imports
every module, encodes QCIF at a fixed quantizer and under rate control with
MQUANT segments, decodes both streams through the native engine, runs the
parity gate's SAD checks on the CPU, encodes on a mesh of two CPU shards
and round-trips a checkpoint."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib.abc
import sys


BLOCKED = ("jax", "jaxlib", "p64tpu")


class _NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked in this test")
        return None


sys.meta_path.insert(0, _NoJax())
for blocked in ("jax", "p64tpu", "p64tpu.spec.constants"):
    try:
        __import__(blocked)
    except ImportError:
        pass
    else:
        raise SystemExit(f"the blocker did not stop {blocked}")

import numpy as np
import torch

torch.set_num_threads(1)
import p64tpu_torch
from p64tpu_torch import cli
from p64tpu_torch.kernels import me_variants, me_variants_cuda
from p64tpu_torch.tools import (batch_decode, batch_encode, parity, pinned,
                                profile)
from p64tpu_torch.distrib import mesh, multihost
from p64tpu_torch.io import checkpoint
from p64tpu_torch.core import decoder, encoder
from p64tpu_torch.entropy import parse
from p64tpu_torch.native import load
from p64tpu_torch.control.ratecontrol import RateConfig
from p64tpu_torch.spec.constants import QCIF
from p64tpu_torch.tools import golden_content as gc

frames = {k: v[None] for k, v in gc.config1_qcif_intra().items()}
cfg = encoder.EncoderConfig(fmt=QCIF, rate=RateConfig(fixed_quant=12))
data, out, _ = encoder.encode_to_bytes(cfg, frames, device="cpu")
assert len(data) == 1 and len(data[0]) > 0
rc = encoder.EncoderConfig(fmt=QCIF, rate=RateConfig(bit_rate=64000,
                                                     mquant_segments=3))
rc_data, rc_out, _ = encoder.encode_to_bytes(rc, frames, device="cpu")
assert len(rc_data[0]) > 0
fmt, tr, seq = decoder.parse_to_tensors(data[0])
y, cb, cr = decoder.decode_seq(fmt, seq, device="cpu")
assert torch.equal(torch.from_numpy(y), out["recon_y"][0])
assert torch.equal(torch.from_numpy(cr), out["recon_cr"][0])
y, cb, cr, parsed = decoder.decode_stream(rc_data[0], device="cpu")
coded = rc_out["frame_coded"][0]
assert torch.equal(torch.from_numpy(cb), rc_out["recon_cb"][0][coded])
assert len(parsed) == len(parse.parse_stream(rc_data[0]))
assert parity.check_dct("cpu")
two = {k: np.concatenate([v, v]) for k, v in frames.items()}
two["y"][1] = 255 - two["y"][1]
m = mesh.make_mesh(devices=["cpu"] * 2)
states, sh_out, agg = mesh.make_sharded_encoder(cfg, m)(
    mesh.shard_batch(m, mesh.init_states(cfg, 2)), mesh.shard_batch(m, two))
sh_data = mesh.serialize_streams(cfg, sh_out)
assert sh_data[0][0] == data[0] and sh_data[1][0] != data[0]
assert mesh.agg_total_bits(agg) == sum(n for _, n in sh_data)
assert batch_encode.encode_resilient(cfg, two, m, chunk=1) == sh_data
import tempfile
with tempfile.TemporaryDirectory() as tmp:
    checkpoint.save(tmp + "/ck", states[1], streams=[sh_data[1][0]],
                    meta={"frames": 2})
    st, streams, meta = checkpoint.load(tmp + "/ck", device="cpu")
assert streams == [sh_data[1][0]] and meta == {"frames": 2}
assert all(torch.equal(st[k], v) for k, v in states[1].items())
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not bad, bad
print("NOJAX OK", len(data[0]))
"""


def test_port_imports_and_encodes_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "NOJAX OK" in r.stdout
