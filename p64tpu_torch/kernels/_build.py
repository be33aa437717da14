"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/*.cu` file is compiled on first use into a shared library with a
plain C interface:

  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
       -Xcompiler -fPIC -o build/kernels/<name>.so csrc/<name>.cu

The build directory (`build/` at the repository root) is git-ignored; a
library is rebuilt when its source is newer.  A missing nvcc or a failed
compile raises -- there is no fallback.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
#: where the CUDA toolkit puts nvcc when neither CUDA_HOME nor PATH says
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then DEFAULT_NVCC."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append(DEFAULT_NVCC)
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        f"nvcc not found (looked in $CUDA_HOME/bin, PATH and {DEFAULT_NVCC})"
        ": the CUDA kernels cannot be built")


def nvcc_command(nvcc: str, source: str, out: str) -> List[str]:
    return [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-o", out, source]


def build(name: str) -> str:
    """Compile csrc/<name>.cu if its library is missing or stale; returns
    the library path."""
    source = os.path.join(CSRC, name + ".cu")
    out = os.path.join(BUILD_DIR, name + ".so")
    if (os.path.exists(out)
            and os.path.getmtime(out) >= os.path.getmtime(source)):
        return out
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    # compile to a private name, then rename: concurrent builds never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        r = subprocess.run(nvcc_command(nvcc, source, tmp),
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {source} (exit {r.returncode}):\n"
                f"{r.stdout}{r.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu, once per process."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name))
        _loaded[name] = lib
    return lib
