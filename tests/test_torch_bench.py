"""The port's bench (``tools/bench.py``) at a tiny size on the CPU.

Every cell runs in its four modes through the CLI entry point on the CPU
device (each wrapper's plain version), with the bench's gate: outputs and
summaries equal across modes, the first records equal to the oracle.
What is held here is the harness and its JSON line; its rates on the CPU
say nothing about the card, and the kernel rows are not measured.
"""

import json

from sickle_tpu_torch.tools import bench

CELLS = ["se_uniform", "se_ragged", "se_binned", "pe_two_file",
         "pe_interleaved_M", "se_bgzf"]


def test_bench_tiny_on_cpu(tmp_path, capsys):
    out = tmp_path / "bench.json"
    rc = bench.main(["--reads-scale", "0.001", "--passes", "1", "--out",
                     str(out)], device="cpu")
    stdout = capsys.readouterr().out
    assert rc == 0
    line = json.loads(stdout.splitlines()[-1])
    assert json.loads(out.read_text()) == line
    assert line["metric"] == "se_reads_per_s" and line["unit"] == "reads/s"
    em = line["extra_metrics"]
    assert em["gate"] and em["errors"] == {}
    assert list(em["cells"]) == CELLS
    assert line["value"] == em["cells"]["se_uniform"]["modes"]["auto"]["median"]
    assert line["vs_host"] > 0
    for name, cell in em["cells"].items():
        assert list(cell["modes"]) == ["auto", "device", "raw", "host"]
        for mode, row in cell["modes"].items():
            assert len(row["passes"]) == 1 and row["median"] > 0
            # a stalled device shows as chunks the router rescued
            assert (row["hybrid"] is None) == (mode in ("device", "raw"))
            if row["hybrid"] is not None:
                assert row["hybrid"]["chunks_rescued"] == 0
            assert (row["h2d_bytes_per_read"] == 0) == (mode == "host"), name
            assert set(row["stage_total_ms"]) == {
                "pack", "prep", "dispatch", "fetch", "consume"}
        assert cell["gate"]["oracle_equal"] and cell["gate"]["outputs_equal"]
    # the router's split is reported for the modes that run it
    assert em["cells"]["se_uniform"]["modes"]["auto"]["hybrid"] is not None
    assert em["cells"]["se_uniform"]["modes"]["device"]["hybrid"] is None
    assert em["kernels"] == "not measured (CPU run)"
    assert em["device"]["platform"] == "cpu"
    fresh = em["fresh_process"]
    assert fresh["se_s"] > 0 and fresh["version_s"] > 0
    assert [fresh["se_output_sha256"]] == em["cells"]["se_uniform"]["gate"]["sha256"]
