"""The PyTorch port runs where JAX is not installed (the GPU host has none):
in a fresh interpreter whose import system refuses `jax`, the port imports
and encodes one QCIF frame on the CPU."""

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
from p64tpu_torch.core import encoder
from p64tpu_torch.control.ratecontrol import RateConfig
from p64tpu.spec.constants import QCIF
from p64tpu.tools import golden_content as gc

frames = {k: v[None] for k, v in gc.config1_qcif_intra().items()}
cfg = encoder.EncoderConfig(fmt=QCIF, rate=RateConfig(fixed_quant=12))
data, out, _ = encoder.encode_to_bytes(cfg, frames, device="cpu")
assert len(data) == 1 and len(data[0]) > 0
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
