"""Build and dispatch rules of the PyTorch port's CUDA kernel, checked
without a card: the wrapper refuses CPU tensors, the build refuses to run
without nvcc, the nvcc line targets sm_90a, and the port imports no JAX."""

import os
import re

import pytest
import torch

from p64tpu_torch.kernels import _build, me_cuda, me_variants, me_variants_cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_sad_search_cuda_refuses_cpu_tensors():
    cur = torch.zeros((1, 48, 64), dtype=torch.uint8)
    before = me_cuda.LAUNCHES
    with pytest.raises(ValueError, match="not a CUDA device"):
        me_cuda.sad_search_cuda(cur, cur.clone(), 4)
    assert me_cuda.LAUNCHES == before


@pytest.mark.parametrize("name", sorted(me_variants_cuda.LAUNCHES))
def test_map_kernels_refuse_cpu_tensors(name):
    cur = torch.zeros((1, 48, 64), dtype=torch.uint8)
    before = dict(me_variants_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="not a CUDA device"):
        getattr(me_variants_cuda, name + "_cuda")(cur, cur.clone(), 4)
    assert me_variants_cuda.LAUNCHES == before
    # the dispatching entry point takes the plain path on the CPU alone
    got = getattr(me_variants, name)(cur, cur.clone(), 4)
    assert me_variants_cuda.LAUNCHES == before
    assert got.shape == (1, 81, 12) and got.dtype == torch.int32


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("sad_search")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("sad_search")
    assert not (tmp_path / "build" / "sad_search.so").exists()


def test_nvcc_command_targets_sm90a():
    cmd = _build.nvcc_command("nvcc", "src.cu", "out.so")
    line = " ".join(cmd)
    assert "-gencode arch=compute_90a,code=sm_90a" in line
    for flag in ("-std=c++17", "-O3", "-shared", "-Xcompiler -fPIC",
                 "-o out.so"):
        assert flag in line
    assert cmd[-1] == "src.cu"
    assert os.path.isfile(os.path.join(_build.CSRC, "sad_search.cu"))


def test_port_never_imports_jax():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax[\s.])", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "p64tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    offenders = []
    for path in files:
        with open(path) as f:
            if pat.search(f.read()):
                offenders.append(os.path.relpath(path, REPO))
    assert not offenders, offenders
