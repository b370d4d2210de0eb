"""The plain reference against a scalar witness, and the port run on the
CPU through the whole harness (pipes, drain, ``-g`` decompressed) against
the reference."""

import pytest
import torch

from trimbench import corpus, reference

from .helpers import CELLS, SE, parts, se_bench, tiny_run


def scalar_cuts(phred, q, min_len):
    """sickle's window loop, read by read, as a second witness."""
    n = len(phred)
    if n < min_len:
        return -1, -1
    w = int(0.1 * n) or n
    total = sum(phred[:w])
    five, three, found = 0, n, False
    for i in range(n - w + 1):
        if not found and total >= q * w:
            five = next(j for j in range(i, i + w) if phred[j] >= q)
            found = True
        if found and total < q * w:
            three = next(j for j in range(i, i + w) if phred[j] < q)
            break
        total -= phred[i]
        if i + w < n:
            total += phred[i + w]
    if not found or three - five < min_len:
        return -1, -1
    return five, three


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("q,min_len", [(20, 20), (30, 60), (0, 0)])
def test_cuts_equal_the_scalar_loop(cell, q, min_len):
    _, cfg, _ = parts(cell)
    block = corpus.pair_block(cfg, 5, 0, 0, 300, "cpu")
    for mate in (1, 2):
        qual = block[f"qual{mate}"]
        five, three = reference.cuts(qual, cfg["qual_offset"], q, min_len)
        phred = (qual.long() - cfg["qual_offset"]).tolist()
        got = list(zip(five.tolist(), three.tolist()))
        assert got == [scalar_cuts(p, q, min_len) for p in phred]


@pytest.mark.parametrize("q,min_len", [(20, 20), (30, 40), (0, 0)])
@pytest.mark.parametrize("drop_bit", [False, True])
def test_trim_single_equals_the_scalar_loop(q, min_len, drop_bit):
    _, cfg, _ = parts(SE)
    block = corpus.pair_block(cfg, 5, 0, 0, 300, "cpu")
    assert "qual2" not in block and block["qual1"].shape == (300, 50)
    out, counts = reference.trim_single(block, cfg["qual_offset"], q,
                                        min_len, drop_bit)
    want = []
    for i, row in enumerate((block["qual1"].long() - cfg["qual_offset"])
                            .tolist()):
        five, three = scalar_cuts([p & ~1 if drop_bit else p for p in row],
                                  q, min_len)
        if three >= 0:
            name = bytes(block["name1"][i].tolist())
            seq = bytes(block["seq1"][i, five:three].tolist())
            qual = bytes(block["qual1"][i, five:three].tolist())
            want.append(name + b"\n" + seq + b"\n+\n" + qual + b"\n")
    assert bytes(out.tolist()) == b"".join(want)
    assert counts == {"total": 300, "kept": len(want),
                      "discarded": 300 - len(want)}
    assert 0 < len(want) < 300 or q == 0


def test_the_se_summary_is_sickles():
    text = reference.summary_se("in.fq", {"total": 10, "kept": 7,
                                          "discarded": 3})
    assert text == ("\nSE input file: in.fq\n\nTotal FastQ records: 10\n"
                    "FastQ records kept: 7\nFastQ records discarded: 3\n\n")
    assert reference.summary_of(["in.fq"], {"total": 10, "kept": 7,
                                            "discarded": 3}) == text


def test_records_and_singles_keep_pair_order():
    name = torch.tensor([list(b"@a"), list(b"@b")], dtype=torch.uint8)
    seq = torch.tensor([list(b"ACGTAC"), list(b"GGGTTT")], dtype=torch.uint8)
    qual = torch.tensor([list(b"IIIIII"), list(b"######")], dtype=torch.uint8)
    text = reference.records(name, seq, qual, torch.tensor([1, 0]),
                             torch.tensor([4, 6]))
    assert bytes(text.tolist()) == b"@a\nCGT\n+\nIII\n@b\nGGGTTT\n+\n######\n"


def test_thresholds_follow_the_flags():
    assert reference.thresholds(["-g"]) == (20, 20)
    assert reference.thresholds(["-g", "-q", "30", "-l", "50"]) == (30, 50)


@pytest.mark.parametrize("cell", CELLS + (SE,))
@pytest.mark.parametrize("trace", [False, True])
def test_the_port_on_the_cpu_equals_the_reference(tmp_path, cell, trace):
    result = tiny_run(cell, trace, bench=se_bench(tmp_path) if cell == SE
                      else None)
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert all(c["value"] == 0 for c in result["checks"].values())
    assert result["correct"] is True
