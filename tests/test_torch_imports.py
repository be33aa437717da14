"""The port stands without the JAX package: no file of `p64tpu_torch/` and
not `chip_smoke.py` imports `p64tpu` or `p64tpu.*`, `jax`, or the JAX
package's tools at the repository root (`bench`, `tools.*`), the native
engine builds from the port's own copy of its source, and the modules the port
copied from the JAX package (the H.261 spec tables, the Python bit I/O,
YUV I/O, statistics and the golden content) give the JAX package's values,
so the two packages keep one bitstream contract."""

import ast
import dataclasses
import os
import types

import numpy as np
import pytest

from p64tpu import stats as jstats
from p64tpu.core import encoder as jencoder
from p64tpu.entropy import bitio as jbitio
from p64tpu.io import yuv as jyuv
from p64tpu.spec import constants as jconstants
from p64tpu.spec import luts as jluts
from p64tpu.spec import tables as jtables
from p64tpu.spec import zigzag as jzigzag
from p64tpu.tools import golden_content as jgc
from p64tpu_torch import stats as tstats
from p64tpu_torch.entropy import bitio as tbitio
from p64tpu_torch.io import yuv as tyuv
from p64tpu_torch.kernels import _build
from p64tpu_torch.spec import constants as tconstants
from p64tpu_torch.spec import luts as tluts
from p64tpu_torch.spec import tables as ttables
from p64tpu_torch.spec import zigzag as tzigzag
from p64tpu_torch.tools import golden_content as tgc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "p64tpu_torch")


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in sorted(names)
                  if n.endswith(".py")]
    return sorted(files)


#: top-level modules the port must not import: the JAX package, JAX, and
#: the JAX package's tools at the repository root (`bench.py`, `tools/`)
FORBIDDEN = ("p64tpu", "jax", "jaxlib", "bench", "tools")


def _jax_package_imports(path, forbidden=FORBIDDEN):
    """(line, module) of every absolute import in path of a `forbidden`
    module or one of its submodules (relative imports are the port's
    own)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            if name.split(".")[0] in forbidden:
                found.append((node.lineno, name))
    return found


def test_no_port_file_imports_the_jax_package():
    files = _port_sources()
    assert len(files) > 40
    offenders = {os.path.relpath(p, REPO): _jax_package_imports(p)
                 for p in files}
    assert not {k: v for k, v in offenders.items() if v}


def test_the_import_scan_finds_an_import_of_the_jax_package(tmp_path):
    """The scan above is not vacuous: it flags each spelling."""
    src = tmp_path / "m.py"
    src.write_text("import os\nimport p64tpu\nfrom p64tpu.spec import luts\n"
                   "from p64tpu_torch.spec import luts as l2\n"
                   "def f():\n    import p64tpu.io.yuv\n"
                   "from . import p64tpu\n")
    assert _jax_package_imports(str(src)) == [
        (2, "p64tpu"), (3, "p64tpu.spec"), (6, "p64tpu.io.yuv")]


def test_the_import_scan_finds_imports_of_jax_and_the_repo_tools(tmp_path):
    """bench.py and tools/ at the repository root are the JAX package's
    tools; the port's own tools (p64tpu_torch.tools) pass."""
    src = tmp_path / "m.py"
    src.write_text("import bench\nfrom tools import stage_bench\n"
                   "import tools.bench_breadth as bb\nimport jax.numpy\n"
                   "from p64tpu_torch.tools import content\n"
                   "from ..tools import stage_bench\nimport benchmark\n"
                   "from p64tpu_torch import tools\n")
    assert _jax_package_imports(str(src)) == [
        (1, "bench"), (2, "tools"), (3, "tools.bench_breadth"),
        (4, "jax.numpy")]


def test_the_port_has_its_benchmark_tools():
    """The stage bench and the bench content are the port's; its one
    benchmark is `port_bench/`, so no second bench tool lies in the
    package."""
    names = {os.path.relpath(p, PORT) for p in _port_sources()}
    assert {os.path.join("tools", f"{n}.py") for n in
            ("stage_bench", "content")} <= names
    assert not {os.path.join("tools", f"{n}.py") for n in
                ("bench", "bench_breadth")} & names


def test_the_port_never_imports_its_benchmark():
    """The layering runs one way, benchmark -> port: no module of the port
    imports `port_bench` (absolutely; relative imports are the port's)."""
    files = [p for p in _port_sources() if p.startswith(PORT + os.sep)]
    assert len(files) > 40
    offenders = {os.path.relpath(p, REPO):
                 _jax_package_imports(p, ("port_bench",)) for p in files}
    assert not {k: v for k, v in offenders.items() if v}


def test_the_port_has_its_dry_run():
    """The counterpart of `__graft_entry__.py` lies in the port, so the
    scan above covers it."""
    names = {os.path.relpath(p, PORT) for p in _port_sources()}
    assert os.path.join("tools", "dryrun.py") in names


def _public_names(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


#: public names of the JAX package the port leaves out on purpose: TPU
#: workarounds (the Pallas kernels became CUDA, the XLA SAD formulations,
#: the barrel-shift MC whose oracle is the gather the port does) and JAX
#: machinery (the jitted sequence became core.graphs, the mesh axis name)
NOT_PORTED = {
    os.path.join("kernels", "me_pallas.py"): None,
    os.path.join("kernels", "me.py"): {"sad_map_i8", "sad_map_shifted"},
    os.path.join("core", "predict.py"): {"mc_predict_gather"},
    os.path.join("core", "encoder.py"): {"encode_sequence_jit"},
    os.path.join("distrib", "mesh.py"): {"STREAM_AXIS"},
}


def _jax_modules():
    root = os.path.join(REPO, "p64tpu")
    return sorted(os.path.relpath(os.path.join(d, n), root)
                  for d, _, names in os.walk(root) for n in names
                  if n.endswith(".py"))


@pytest.mark.parametrize("module", _jax_modules())
def test_every_public_name_of_the_jax_package_has_a_counterpart(module):
    want = NOT_PORTED.get(module, set())
    port = os.path.join(PORT, module)
    if want is None:                   # its kernels are in p64tpu_torch/csrc
        assert not os.path.exists(port)
        return
    assert os.path.isfile(port), module
    missing = (_public_names(os.path.join(REPO, "p64tpu", module))
               - _public_names(port))
    assert missing == want


def test_native_source_lies_inside_the_port():
    src = os.path.realpath(_build.NATIVE_SOURCE)
    assert os.path.commonpath([src, os.path.realpath(PORT)]) == \
        os.path.realpath(PORT)
    assert os.path.isfile(src)


def test_native_source_is_byte_identical_to_the_jax_engine():
    with open(_build.NATIVE_SOURCE, "rb") as a, open(
            os.path.join(REPO, "p64tpu", "native", "bitio.cpp"), "rb") as b:
        assert a.read() == b.read()


def _assert_same(a, b, what):
    """a (the port's) equals b (the JAX package's), recursively; formats
    and other dataclasses compare field by field, since each package's
    are instances of its own class."""
    if isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    elif dataclasses.is_dataclass(b) and not isinstance(b, type):
        assert type(a).__name__ == type(b).__name__, what
        for f in dataclasses.fields(b):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{what}.{f.name}")
    elif isinstance(b, dict):
        assert list(a) == list(b), what
        for k in b:
            _assert_same(a[k], b[k], f"{what}[{k!r}]")
    elif isinstance(b, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{what}[{i}]")
    else:
        assert type(a) is type(b) and a == b, what


def _values(module):
    """Public data of a module: no functions, classes or modules."""
    return {n: v for n, v in vars(module).items()
            if not n.startswith("_") and n != "annotations"
            and not isinstance(v, (types.FunctionType, types.ModuleType,
                                   type))}


@pytest.mark.parametrize("port,jax_mod", [
    (tconstants, jconstants), (ttables, jtables), (tluts, jluts),
    (tzigzag, jzigzag)], ids=["constants", "tables", "luts", "zigzag"])
def test_spec_copies_hold_the_jax_values(port, jax_mod):
    want = _values(jax_mod)
    if port is tluts:
        # the MTYPE -> MQUANT-variant table, which the JAX package keeps in
        # its encoder
        want["MQ_UPGRADE"] = jencoder._MQ_UPGRADE
    assert sorted(_values(port)) == sorted(want)
    assert want
    for name, value in want.items():
        _assert_same(getattr(port, name), value, name)


def test_spec_functions_agree():
    for is_cif in (False, True):
        assert tconstants.ptype_value(is_cif) == jconstants.ptype_value(
            is_cif)
    for name, fmt in jconstants.FORMATS.items():
        got = tconstants.format_for_size(fmt.width, fmt.height)
        assert got is tconstants.FORMATS[name]
        _assert_same(got, fmt, name)
    for mod in (tconstants, jconstants):
        with pytest.raises(ValueError, match="unsupported picture size"):
            mod.format_for_size(64, 48)


def test_bitio_copy_writes_and_reads_the_same_bits():
    rng = np.random.default_rng(9)
    lens = rng.integers(0, 33, 500)
    codes = np.array([rng.integers(0, 1 << int(n)) for n in lens], np.uint64)
    want = jbitio.pack_symbols(codes, lens)
    assert tbitio.pack_symbols(codes, lens) == want
    w, jw = tbitio.BitWriter(), jbitio.BitWriter()
    for c, n in zip(codes[:100], lens[:100]):
        w.put(int(c), int(n))
        jw.put(int(c), int(n))
    w.put_str("0110")
    jw.put_str("0110")
    assert w.getvalue() == jw.getvalue()
    r, jr = tbitio.BitReader(want[0]), jbitio.BitReader(want[0])
    for n in lens[:100]:
        assert r.read(int(n)) == jr.read(int(n))
    assert r.pos == jr.pos


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_golden_content_copy_gives_equal_frames(seed):
    rng = np.random.default_rng(seed)
    luma = rng.integers(0, 256, (2, 32, 48)).astype(np.uint8)
    _assert_same(tgc.luma_to_frames(luma), jgc.luma_to_frames(luma),
                 "luma_to_frames")
    t = 2 + seed
    _assert_same(tgc.config2_qcif_inter(t), jgc.config2_qcif_inter(t),
                 "config2_qcif_inter")
    _assert_same(tgc.config3_cif_rc(t), jgc.config3_cif_rc(t),
                 "config3_cif_rc")


@pytest.mark.parametrize("name", ["config1_qcif_intra", "kernel_probe_blocks",
                                  "adversarial_sequences",
                                  "graded_energy_qcif"])
def test_golden_content_fixed_sequences_equal(name):
    _assert_same(getattr(tgc, name)(), getattr(jgc, name)(), name)
    assert sorted(tgc.ALL) == sorted(jgc.ALL)


def test_yuv_and_stats_copies_agree(tmp_path):
    frames = tgc.config2_qcif_inter(2)
    ours, theirs = tmp_path / "t.y4m", tmp_path / "j.y4m"
    tyuv.write_y4m(str(ours), frames, (30, 1))
    jyuv.write_y4m(str(theirs), frames, (30, 1))
    assert ours.read_bytes() == theirs.read_bytes()
    got, fmt = tyuv.load_input(str(ours))
    want, jfmt = jyuv.load_input(str(theirs))
    assert fmt is tconstants.QCIF and jfmt is jconstants.QCIF
    _assert_same(got, want, "load_input")
    a, b = frames["y"][0], frames["y"][1]
    assert tstats.psnr(a, b) == jstats.psnr(a, b)
    assert tstats.sequence_report(12345, 2, 3, 30) == \
        jstats.sequence_report(12345, 2, 3, 30)
