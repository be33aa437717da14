"""The lower-precision control through the harness: a run whose timed job
is the reference with its DCT and IDCT on TF32-rounded float32 operands
comes out not correct, at a size the CPU holds and, on the card, at the
cells' own sizes.  `port_bench/control.py` runs it on more seeds there."""

import pytest
import torch

from port_bench import control, harness
from port_bench.tests.small import small_checkout

CELLS = sorted(harness.Manifest().cells)


def _not_correct(r):
    assert not r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(tmp_path, cell):
    m = small_checkout(str(tmp_path))
    for seed in (7, 2**31 + 1, 123456789):
        _not_correct(control.run_control(cell, seed, "tf32",
                                         torch.device("cpu"), m))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _not_correct(control.run_control(cell, 2**31 + 5, "tf32",
                                     torch.device("cuda", 0)))
