"""The benchmark's ENCODE ChIP-seq cell, ``encode_se50.bgzf``: single-end
1x50 reads in one BGZF file through ``sickle se``, held to the benchmark's
plain reference (``trimbench/reference.py``).

The cell's runs go through ``trimbench.run.run_cell`` in a subprocess: the
harness refuses a process that has loaded JAX, and this suite's conftest
loads it.
"""

import contextlib
import io
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

from sickle_tpu_torch import cli
from sickle_tpu_torch.io.compression import BgzfReader
from trimbench import bgzf, catalog, corpus, reference, run
from trimbench.drain import gunzip

CELL = "encode_se50.bgzf"
SEED = 2**31 + 1616
# the cell at a test's size: 4,000 of its 4,000,000 reads
SCALE = 0.001
READS = 12_000  # three chunks of 4,096 reads under -b 1
SPAN_READERS = ["read_ns_per_base.se", "pack_ns_per_base.se",
                "consume_ns_per_base.se", "compress_ns_per_base.se",
                "dispatch_starved_share.se", "writer_backpressure_share.se"]
SE_READERS = SPAN_READERS + ["carry_bytes_per_base.se",
                             "h2d_bytes_per_base.se",
                             "cuts_kernel_roofline.se",
                             "device_idle_share.se"]


def _cell_config() -> dict:
    bench = catalog.benchmark()
    return catalog.config(bench, catalog.workload(bench, CELL)["config"])


def test_the_cell_is_a_single_end_bgzf_deployment():
    bench = catalog.benchmark()
    entry = catalog.workload(bench, CELL)
    cfg = _cell_config()
    mix = catalog.traffic(entry["traffic"])
    assert entry["chips"] == 1 and corpus.mates(cfg) == 1
    assert cfg["read_length"] == [50] and cfg["qual_type"] == "sanger"
    assert mix["input"] == "bgzf" and mix["flags"] == ["-g"]
    assert corpus.files(cfg, mix) == [[(0, 4_000_000)]]
    # a 161-byte record: records straddle bgzip's 65,280-byte blocks
    block = corpus.pair_block(cfg, SEED, 0, 0, 64, "cpu")
    text = corpus.fastq_text(block["name1"], block["seq1"], block["qual1"])
    assert text.numel() == 64 * 161 and bgzf.BLOCK_BYTES % 161
    rate = next(e for e in bench["end_to_end"] if e["name"] == "bases_per_s")
    assert CELL in rate["workloads"]
    cell_readers = [e["name"] for e in bench["per_layer"]
                    if CELL in e.get("workloads", [])]
    assert sorted(cell_readers) == sorted(SE_READERS)


@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_run_of_the_cell_is_correct(trace):
    code = ("import json; from trimbench import catalog, run; "
            "print(json.dumps(run.run_cell(catalog.benchmark(), "
            f"{CELL!r}, {SEED}, 0.5, {bool(trace)}, 'cpu', "
            f"scale={SCALE})))")
    done = subprocess.run([sys.executable, "-c", code], cwd=catalog.ROOT,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    line = json.loads(done.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, done.stderr[-3000:]
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert all(c["value"] == 0 for c in line["checks"].values())
    if not trace:
        assert set(line["metrics"]) == {"bases_per_s", "setup_s"}
        return
    for name in SPAN_READERS + ["carry_bytes_per_base.se",
                                "h2d_bytes_per_base.se"]:
        value = line["metrics"][name]["value"]
        assert value >= 0, name
        if name.split(".")[0].endswith("share"):
            assert value <= 100, name
    assert not any(m.endswith((".stream", ".plate", ".pooled"))
                   for m in line["metrics"])


@pytest.mark.parametrize("window_blocks", [None, 2])
def test_se_on_one_bgzf_file_equals_the_reference(tmp_path, monkeypatch,
                                                  window_blocks):
    """``sickle se -g`` on one BGZF file of 1x50 reads, in three chunks,
    equals the reference byte for byte; with windows of two blocks the
    producer rotates its buffer and counts the live bytes it carries."""
    cfg = _cell_config()
    block = corpus.pair_block(cfg, SEED, 0, 0, READS, "cpu")
    path = tmp_path / "rep1.fastq.gz"
    with open(path, "wb") as f, ThreadPoolExecutor(2) as pool:
        w = bgzf.Writer(f, 1, pool)
        w.write(corpus.fastq_text(block["name1"], block["seq1"],
                                  block["qual1"]).numpy())
        w.close()
    q, min_len = reference.thresholds([])
    want, counts = reference.trim_single(block, cfg["qual_offset"], q,
                                         min_len)
    if window_blocks is not None:
        monkeypatch.setattr(BgzfReader, "WINDOW_BLOCKS", window_blocks)
    out_path = tmp_path / "trimmed.fastq.gz"
    out, err = (io.TextIOWrapper(io.BytesIO(), write_through=True)
                for _ in range(2))
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(["se", "-t", "sanger", "-g", "-b", "1", "--metrics",
                       "-f", str(path), "-o", str(out_path)], device="cpu")
    stderr = err.buffer.getvalue().decode()
    assert rc == 0, stderr[-2000:]
    assert gunzip(out_path.read_bytes()) == want.numpy().tobytes()
    assert out.buffer.getvalue().decode() == reference.summary_se(
        str(path), counts)
    summary = run._metrics_summary(stderr)
    assert summary["chunks"] == 3 and summary["records"] == READS
    size = READS * 161
    assert summary["counters"]["read_bytes"] == size
    carried = summary["counters"]["carry_bytes"]
    if window_blocks is None:
        assert carried == 0  # one buffer holds the whole file
    else:
        windows = -(-size // (window_blocks * bgzf.BLOCK_BYTES))
        assert summary["spans"]["read"]["n"] >= windows and carried > 0
