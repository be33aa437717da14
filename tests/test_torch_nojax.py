"""The PyTorch port runs where JAX is not installed (the GPU host has none):
in a fresh interpreter whose import system refuses `jax`, the port imports
every module, encodes QCIF at a fixed quantizer and under rate control with
MQUANT segments, decodes both streams through the native engine, and runs
the parity gate's SAD checks on the CPU."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib.abc
import sys


class _NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"{name} is blocked in this test")
        return None


sys.meta_path.insert(0, _NoJax())
try:
    import jax  # noqa: F401
except ImportError:
    pass
else:
    raise SystemExit("the jax blocker did not work")

import torch

torch.set_num_threads(1)
import p64tpu_torch
from p64tpu_torch import cli
from p64tpu_torch.kernels import me_variants, me_variants_cuda
from p64tpu_torch.tools import batch_decode, parity, pinned
from p64tpu_torch.core import decoder, encoder
from p64tpu_torch.entropy import parse
from p64tpu_torch.native import load
from p64tpu_torch.control.ratecontrol import RateConfig
from p64tpu.spec.constants import QCIF
from p64tpu.tools import golden_content as gc

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
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
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
