"""The generator and the BGZF writer: deterministic by seed, and what the
configurations say."""

import gzip
import io
import struct
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from trimbench import bgzf, corpus, run

from .helpers import CELLS, PLATE, POOLED, SE, SEED, parts


@pytest.mark.parametrize("cell", CELLS)
def test_blocks_are_deterministic_by_seed(cell):
    _, cfg, _ = parts(cell)
    a = corpus.pair_block(cfg, SEED, 0, 0, 300, "cpu")
    b = corpus.pair_block(cfg, SEED, 0, 0, 300, "cpu")
    c = corpus.pair_block(cfg, SEED + 1, 0, 0, 300, "cpu")
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["qual1"], c["qual1"])
    assert not torch.equal(a["seq2"], c["seq2"])


@pytest.mark.parametrize("cell", CELLS)
def test_reads_have_the_configured_shape(cell):
    _, cfg, _ = parts(cell)
    block = corpus.pair_block(cfg, SEED, 3, 0, 500, "cpu")
    model = cfg["quality"]
    for mate in (1, 2):
        qual = block[f"qual{mate}"]
        assert qual.shape == (500, cfg["read_length"][mate - 1])
        phred = qual.long() - cfg["qual_offset"]
        assert int(phred.min()) >= 0 and int(phred.max()) <= model["max_q"]
        if model.get("bins"):
            assert set(phred.unique().tolist()) <= set(model["bins"])
        assert set(block[f"seq{mate}"].unique().tolist()) <= set(b"ACGT")
    n1, n2 = block["name1"], block["name2"]
    assert n1.shape == n2.shape and int(n1[:, 0].eq(ord("@")).all())
    first = bytes(n1[0].tolist()).decode()
    cut = first.index(" ")
    assert bytes(n2[0].tolist()).decode()[:cut] == first[:cut]


def test_a_single_end_block_is_a_pairs_mate_one():
    _, se, _ = parts(SE)
    pe = dict(se, read_length=[50, 50])
    one = corpus.pair_block(se, SEED, 1, 0, 400, "cpu")
    two = corpus.pair_block(pe, SEED, 1, 0, 400, "cpu")
    assert sorted(one) == ["name1", "qual1", "seq1"]
    assert all(torch.equal(one[k], two[k]) for k in one)


def test_the_pooled_files_are_the_plates_files_one_after_another(tmp_path):
    _, cfg, plate = parts(PLATE)
    _, _, pooled = parts(POOLED)
    scale = 0.002
    got = {}
    for mix in (plate, pooled):
        work = tmp_path / mix["name"]
        work.mkdir()
        got[mix["name"]] = run.write_inputs(cfg, mix, SEED, work, "cpu",
                                            scale)
    samples = got["plate"][0]
    (pool,) = got["pooled"][0]
    assert [s.parts for s in samples] == [[p] for p in pool.parts]
    assert [n for _, n in pool.parts] == corpus.sample_pairs(cfg, scale)
    assert pool.pairs == sum(s.pairs for s in samples)
    for mate in (0, 1):
        whole = b"".join(open(s.paths[mate], "rb").read() for s in samples)
        assert open(pool.paths[mate], "rb").read() == whole
        assert pool.paths[mate].endswith(f"pool_R{mate + 1}.fastq")
    # the warm-up, and the bytes written, are the plate's
    assert got["plate"][1].parts == got["pooled"][1].parts
    assert got["plate"][2:4] == got["pooled"][2:4]


def test_a_single_end_cell_writes_mate_one_alone(tmp_path):
    _, cfg, mix = parts(SE)
    files, warmup, _, _, _ = run.write_inputs(cfg, mix, SEED, tmp_path,
                                              "cpu", 0.0005)
    assert len(files) == cfg["samples"]
    for f in files + [warmup]:
        (path,) = f.paths
        assert path.endswith("_R1.fastq")
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        f"{s}_R1.fastq" for s in ["0", "1", corpus.WARMUP])


def test_read_two_decays_faster_where_configured():
    _, cfg, _ = parts(PLATE)
    block = corpus.pair_block(cfg, SEED, 0, 0, 2000, "cpu")
    tail1 = block["qual1"][:, -25:].float().mean()
    tail2 = block["qual2"][:, -25:].float().mean()
    assert tail2 < tail1 - 5


def test_sample_sizes_are_one_set_for_every_seed():
    _, cfg, _ = parts(PLATE)
    sizes = corpus.sample_pairs(cfg)
    assert len(sizes) == cfg["samples"] == 16
    assert sizes == sorted(sizes) and len(set(sizes)) == 16
    mean = sum(sizes) / len(sizes)
    assert abs(mean - cfg["depth"]["mean_pairs"]) < 0.05 * mean
    orders = {tuple(corpus.plate_order(16, s)) for s in range(6)}
    assert len(orders) > 1
    assert all(sorted(o) == list(range(16)) for o in orders)
    assert corpus.plate_order(16, 7) == corpus.plate_order(16, 7)


def test_bgzf_members_are_gzip_and_name_their_size():
    data = bytes(range(256)) * 700 + b"tail"
    buf = io.BytesIO()
    with ThreadPoolExecutor(2) as pool:
        writer = bgzf.Writer(buf, 1, pool)
        writer.write(data[:1000])
        writer.write(data[1000:])
        writer.close()
    raw = buf.getvalue()
    assert gzip.decompress(raw) == data
    pos = members = 0
    while pos < len(raw):
        assert raw[pos:pos + 4] == b"\x1f\x8b\x08\x04"
        assert raw[pos + 12:pos + 14] == b"BC"
        pos += struct.unpack("<H", raw[pos + 16:pos + 18])[0] + 1
        members += 1
    assert pos == len(raw) and members == 5
    assert raw.endswith(bgzf.EOF_BLOCK)
