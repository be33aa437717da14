"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port: an `ast` scan of every file under
port_bench/, top-level module names compared whole (`p64tpu_torch` starts
with `p64tpu` and is not the JAX package)."""

import ast
import os

from port_bench import harness

FORBIDDEN = ("jax", "jaxlib", "flax", "p64tpu")
PORT = "p64tpu_torch"


def imports(path):
    """Top-level names of every import in path; a relative import inside
    port_bench resolves to port_bench."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            found.add("port_bench" if node.level else
                      (node.module or "").split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in
              ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            found.add(str(node.args[0].value).split(".")[0])
    return found


def sources(root):
    for d, _, names in os.walk(root):
        for n in sorted(names):
            if n.endswith(".py"):
                yield os.path.join(d, n)


def offenders(root, forbidden):
    return {os.path.relpath(p, root): sorted(imports(p) & set(forbidden))
            for p in sources(root) if imports(p) & set(forbidden)}


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    files = list(sources(harness.BENCH))
    assert len(files) > 30
    assert offenders(harness.BENCH, FORBIDDEN) == {}


def test_the_reference_imports_nothing_of_the_port():
    ref = os.path.join(harness.BENCH, "reference")
    assert offenders(ref, FORBIDDEN + (PORT,)) == {}
    # nor anything of the harness that calls the port
    for p in sources(ref):
        assert imports(p) <= {"__future__", "contextlib", "dataclasses",
                              "typing", "numpy", "torch", "port_bench"}, p


def test_the_scan_finds_each_kind_of_import(tmp_path):
    (tmp_path / "a.py").write_text("import jax.numpy as jnp\n")
    (tmp_path / "b.py").write_text("from p64tpu.core import encoder\n")
    (tmp_path / "c.py").write_text("import importlib\n"
                                   "importlib.import_module('jaxlib')\n")
    (tmp_path / "d.py").write_text("import p64tpu_torch\n")
    found = offenders(str(tmp_path), FORBIDDEN)
    assert found == {"a.py": ["jax"], "b.py": ["p64tpu"], "c.py": ["jaxlib"]}
    assert offenders(str(tmp_path), (PORT,)) == {"d.py": [PORT]}


def test_the_run_refuses_a_loaded_jax_package(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "p64tpu.core",
                        types.ModuleType("p64tpu.core"))
    assert harness.forbidden_loaded() == ["p64tpu"]
    monkeypatch.delitem(sys.modules, "p64tpu.core")
    assert "p64tpu" not in harness.forbidden_loaded()
