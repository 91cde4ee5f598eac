"""The control, the reference computed in TF32 (the step below the
configurations' float32; emulated on the CPU by rounding every
convolution's and dense layer's operands to TF32) in the program's place,
comes out not correct at the cell's limits, while the program's numbers
stay within them. Tiny sizes on the CPU; on the card the readings come
from ``control.py`` at the cells' own sizes."""

import pytest

from portbench.precision import round_tf32
from portbench.tests import tiny

CELLS = tiny.CELLS


def test_tf32_rounding():
    import torch

    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 1.0 + 2 ** -12])
    assert round_tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, 1.0]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell):
    program, control, limits = tiny.control_values(cell)
    lim = {k: v["limit"] for k, v in limits["numbers"].items()}
    assert all(program[k] <= lim[k] for k in lim), (program, lim)
    assert any(control[k] > lim[k] for k in lim), (control, lim)
