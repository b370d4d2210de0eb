"""The control, the reference on qualities one bit short, comes out not
correct: on several seeds, for every cell's configuration and for a
single-end one."""

import pytest

from trimbench import compare, control

from .helpers import CELLS, SCALE, SE, parts


@pytest.mark.parametrize("cell", CELLS + (SE,))
@pytest.mark.parametrize("seed", [11, 2**31 + 12, 13])
def test_the_control_is_not_correct(cell, seed):
    _, cfg, mix = parts(cell)
    numbers = control.readings(cfg, mix, seed, "cpu", scale=SCALE[cell])
    assert numbers["wrong_records"] > 0
    assert not compare.verdict({**numbers, "failed_calls": 0})
