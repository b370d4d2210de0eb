"""With the timed path broken underneath, ``correct`` comes out false, once
for each fault the cells can have.  A trimmer's step is the cuts of a
chunk's reads; each fault is planted where the engine hands them to the
writer (``engine/pipeline.py::_write_two_file_chunk``), on every route.
Both cells run on one chip, so no exchange between chips can be left out."""

import numpy as np
import pytest

from sickle_tpu_torch.engine import pipeline

from .helpers import CELLS, tiny_run


def _alter(kind, packed, result):
    five, three, bad = (np.array(r, copy=True) for r in result)
    n = five.size
    if kind == "unchanged":  # the step hands its reads back untrimmed
        five[:] = 0
        three[:] = packed.lengths[:n]
    elif kind == "half_left_out":  # the second half of the batch dropped
        five[n // 2:] = -1
        three[n // 2:] = -1
    elif kind == "one_answer_altered":  # one read's 3' cut moved by one
        i = int(np.flatnonzero(three > five + 1)[0])
        three[i] -= 1
    return five, three, bad


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("kind", ["unchanged", "half_left_out",
                                  "one_answer_altered"])
def test_a_broken_step_is_not_correct(monkeypatch, cell, kind):
    write = pipeline._write_two_file_chunk

    def broken(p1, p2, r1, r2, *args, **kw):
        return write(p1, p2, _alter(kind, p1, r1), _alter(kind, p2, r2),
                     *args, **kw)

    monkeypatch.setattr(pipeline, "_write_two_file_chunk", broken)
    line = tiny_run(cell)
    assert line["attempted"] >= 1
    assert line["checks"]["wrong_records"]["value"] > 0
    assert line["correct"] is False
