"""A short run of each cell on the card, and of a single-end cell of the
tests' own: the whole harness, traced."""

import pytest

from trimbench import catalog, run

from .helpers import CELLS, SCALE, SE, SEED, se_bench, tiny_run


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_traced_run_on_the_card(card, cell):
    line = run.run_cell(catalog.benchmark(), cell, SEED, 2.0, True, card,
                        scale=10 * SCALE[cell])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0
    assert "cuts_kernel_roofline" in " ".join(line["metrics"])


@pytest.mark.cuda
def test_a_short_traced_single_end_run_on_the_card(card, tmp_path):
    line = tiny_run(SE, True, 2.0, bench=se_bench(tmp_path), device=card,
                    scale=10)
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0
