"""Runs a reference fuzz tool (`tools/fuzz_encoder.py`,
`tools/fuzz_differential.py`, loaded from its file, not edited) under
patches that capture what its loop draws, for the port's fuzz tests."""

import contextlib
import importlib.util
import io
import os
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Stop(Exception):
    """Raised by a patch to end the tool's loop once enough is captured."""


def run_reference(name, seed, patches):
    """Run tools/<name>.py's main with FUZZ_SEED=seed and a budget far
    beyond a test's, under `patches` ((object, attribute, value)), until a
    patch raises Stop.  jax.config.update is a no-op for the call, so the
    tool's platform and cache settings leave the test's as they were."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FUZZ_SEED", str(seed))
        mp.setattr(sys, "argv", [f"{name}.py", "3600"])
        mp.setattr(jax.config, "update", lambda *a, **k: None)
        for obj, attr, value in patches:
            mp.setattr(obj, attr, value)
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()):
            with pytest.raises(Stop):
                tool.main()
