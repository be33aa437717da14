"""Build the port's native code and load it with ctypes.

Each `csrc/*.cu` file is compiled on first use into a shared library with a
plain C interface:

  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xptxas -v
       -shared -Xcompiler -fPIC -o build/kernels/<name>.so csrc/<name>.cu

`-Xptxas -v` makes ptxas report each kernel's registers, shared memory and
spills; `ptxas_report(name)` returns those lines of the last build.

The host bit-I/O engine is the port's copy of the JAX package's C++ source
(`csrc/bitio.cpp`, held byte-identical to `p64tpu/native/bitio.cpp` by
tests/test_torch_imports.py, so both engines keep one byte contract),
compiled with the flags of the JAX package's Makefile:

  g++ -O3 -Wall -Wextra -fPIC -std=c++17 -shared
      -o build/native/libp64bitio.so p64tpu_torch/csrc/bitio.cpp

The batch serializer (`csrc/serialize_batch.cpp`, which includes
`bitio.cpp`) is built the same way into `build/native/libp64serialize.so`,
and rebuilt when either source is newer; the decode's level packer
(`csrc/levels_pack.cpp`) into `build/native/libp64pack.so`.

The build directory (`build/` at the repository root) is git-ignored; a
library is rebuilt when its source is newer.  A missing compiler, a failed
compile or a library that does not load raises BuildError -- there is no
fallback.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from typing import Callable, Dict, List, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO = os.path.dirname(_PKG)
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_REPO, "build", "kernels")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
#: where the CUDA toolkit puts nvcc when neither CUDA_HOME nor PATH says
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

#: the bit-I/O engine's source and its library
NATIVE_SOURCE = os.path.join(CSRC, "bitio.cpp")
NATIVE_BUILD_DIR = os.path.join(_REPO, "build", "native")
NATIVE_LIB = "libp64bitio.so"
#: the batch serializer's source (it includes NATIVE_SOURCE) and library
BATCH_SOURCE = os.path.join(CSRC, "serialize_batch.cpp")
BATCH_LIB = "libp64serialize.so"
#: the level packer's source and library
PACK_SOURCE = os.path.join(CSRC, "levels_pack.cpp")
PACK_LIB = "libp64pack.so"
#: the JAX package's `native/Makefile` CXXFLAGS plus -shared
CXX_FLAGS = ["-O3", "-Wall", "-Wextra", "-fPIC", "-std=c++17", "-shared"]

_loaded: Dict[str, ctypes.CDLL] = {}


class BuildError(RuntimeError):
    """A library could not be built or loaded: no compiler, a failed
    compile, or a library the loader refuses.  Callers that retry failed
    work (tools.batch_encode.encode_resilient) let it through: a retry
    cannot fix a build."""


def open_library(path: str) -> ctypes.CDLL:
    """ctypes.CDLL(path), raising BuildError if the loader refuses it."""
    try:
        return ctypes.CDLL(path)
    except OSError as e:
        raise BuildError(f"cannot load {path}: {e}") from e


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
    raise BuildError(
        f"nvcc not found (looked in $CUDA_HOME/bin, PATH and {DEFAULT_NVCC})"
        ": the CUDA kernels cannot be built")


def find_cxx() -> str:
    """Path of the C++ compiler: $CXX if set, else g++ on PATH."""
    cxx = shutil.which(os.environ.get("CXX") or "g++")
    if cxx is None:
        raise BuildError(
            "g++ not found (looked at $CXX and PATH): the native bit-I/O "
            "engine cannot be built")
    return cxx


def nvcc_command(nvcc: str, source: str, out: str) -> List[str]:
    return [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v",
            "-shared", "-Xcompiler", "-fPIC", "-o", out, source]


def cxx_command(cxx: str, source: str, out: str) -> List[str]:
    return [cxx, *CXX_FLAGS, "-o", out, source]


def _compile(source: str, out: str, find: Callable[[], str],
             command: Callable[[str, str, str], List[str]],
             includes: Sequence[str] = ()) -> str:
    """Compile source into out if out is missing or older than source or
    a file it includes; returns out."""
    if (os.path.exists(out) and os.path.getmtime(out) >= max(
            os.path.getmtime(f) for f in (source, *includes))):
        return out
    tool = find()
    build_dir = os.path.dirname(out)
    os.makedirs(build_dir, exist_ok=True)
    # compile to a private name, then rename: concurrent builds never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        r = subprocess.run(command(tool, source, tmp),
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise BuildError(
                f"{os.path.basename(tool)} failed on {source} (exit "
                f"{r.returncode}):\n{r.stdout}{r.stderr}")
        with open(out + ".log", "w") as f:
            f.write(r.stdout + r.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def build(name: str) -> str:
    """Compile csrc/<name>.cu if its library is missing or stale; returns
    the library path."""
    return _compile(os.path.join(CSRC, name + ".cu"),
                    os.path.join(BUILD_DIR, name + ".so"), find_nvcc,
                    nvcc_command)


def ptxas_report(name: str) -> List[str]:
    """The ptxas lines (registers, shared memory, spills per kernel) of the
    last build of csrc/<name>.cu; empty if the log is missing."""
    log = os.path.join(BUILD_DIR, name + ".so.log")
    if not os.path.exists(log):
        return []
    with open(log) as f:
        return [ln.strip() for ln in f
                if "ptxas info" in ln or "bytes stack frame" in ln]


def build_native() -> str:
    """Compile the bit-I/O engine if its library is missing or stale;
    returns the library path (under NATIVE_BUILD_DIR)."""
    return _compile(NATIVE_SOURCE, os.path.join(NATIVE_BUILD_DIR, NATIVE_LIB),
                    find_cxx, cxx_command)


def build_batch_serializer() -> str:
    """Compile the batch serializer if its library is missing or older
    than its source or the bit-I/O engine's; returns the library path
    (under NATIVE_BUILD_DIR)."""
    return _compile(BATCH_SOURCE, os.path.join(NATIVE_BUILD_DIR, BATCH_LIB),
                    find_cxx, cxx_command, includes=(NATIVE_SOURCE,))


def build_levels_pack() -> str:
    """Compile the level packer if its library is missing or stale;
    returns the library path (under NATIVE_BUILD_DIR)."""
    return _compile(PACK_SOURCE, os.path.join(NATIVE_BUILD_DIR, PACK_LIB),
                    find_cxx, cxx_command)


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu, once per process."""
    lib = _loaded.get(name)
    if lib is None:
        lib = open_library(build(name))
        _loaded[name] = lib
    return lib
