"""The port's kernel-verify tool (``tools/kernel_verify.py``) on the CPU.

On the CPU every kernel wrapper takes its plain PyTorch version, so what
these tests hold is the tool's own part: its seeded batches and the plain
outputs it compares against, equal to the JAX package's
``sickle_tpu.ops.trim.compute_cuts`` (tolerance 0: integer outputs) on
every config, form and source; its artifact; and its exit code when a
wrapper returns a wrong code.  The card runs it whole (``chip_smoke.py``
phase 6).
"""

import json

import numpy as np
import pytest
import torch

from sickle_tpu.constants import Compat as JCompat
from sickle_tpu.constants import QualityType as JQualityType
from sickle_tpu.ops import TrimParams as JTrimParams
from sickle_tpu.ops.trim import compute_cuts as jax_compute_cuts
from sickle_tpu_torch.ops import trim_cuda
from sickle_tpu_torch.ops.trim import wire_codes
from sickle_tpu_torch.tools import kernel_verify as kv

ROWS = 1024
SCALE = 1 / 128  # the tool's batches of 512 rows, variant files of 156 reads


def _jax_params(p):
    return JTrimParams(JQualityType(int(p.qualtype)), p.qual_threshold,
                       p.length_threshold, p.no_fiveprime, p.trunc_n,
                       JCompat(p.compat.value))


NAMES = ["q60-fork", "q20", "q30-n", "q40-x"]
# every config on raw rows; the wires take no -n (the tool skips it too)
CASES = [(k, source) for source in ("raw", "band", "rank")
         for k, p in enumerate(kv.CONFIGS)
         if source == "raw" or not p.trunc_n]


@pytest.mark.parametrize("k,source", CASES,
                         ids=[f"{NAMES[k]}-{s}" for k, s in CASES])
def test_plain_outputs_match_jax(k, source):
    """On the tool's batch of each source, uniform (generic and uniform
    forms) and ragged: the plain cuts (raw rows) or the plain wire step
    (band, rank) equal the JAX package's cuts of the same reads."""
    p = kv.CONFIGS[k]
    for kind, ul in (("uniform", None), ("uniform", 150), ("ragged", None)):
        s, q, n = kv.batch(kind, ROWS, source)
        five, three, bad = (np.asarray(x) for x in jax_compute_cuts(
            s, q, n, _jax_params(p), uniform_len=ul))
        if source == "raw":
            got = kv.unpack(trim_cuda.trim_cuts(
                torch.from_numpy(q), p, seq=torch.from_numpy(s),
                uniform_len=ul))
        else:
            buf, pw, kw = kv.wire_args(q, source == "rank", p.qualtype)
            assert pw == (3 if source == "rank" else 6)
            got = kv.unpack(wire_codes(torch.from_numpy(buf), pw, kv.L, p,
                                       uniform_len=ul, **kw))
        assert np.array_equal(got[0].numpy(), five), (kind, ul)
        assert np.array_equal(got[1].numpy(), three), (kind, ul)
        assert np.array_equal(got[2].numpy(), (bad < n).astype(np.int32))
        if source == "raw":  # the raw batch exercises the flag and -n
            assert (bad < n).any() and (s == ord("N")).any()


def test_tool_passes_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "verify.json"
    assert kv.main([str(out)], device="cpu", scale=SCALE) == 0
    last = capsys.readouterr().out.splitlines()[-1]
    res = json.loads(out.read_text())
    assert json.loads(last) == res and res["equal"]
    # 4 configs raw + 3 on each wire, each on uniform x {generic, uniform}
    # and ragged x generic
    assert len(res["configs"]) == 3 * (4 + 3 + 3)
    assert {(c["source"], c["form"]) for c in res["configs"]} == {
        (s, f) for s in ("raw", "band", "rank")
        for f in ("generic", "uniform")}
    assert [v["name"] for v in res["variants"]] == [
        "trunc_n", "nul_in_read", "reads_50kbp", "reads_30_32.7kbp",
        "reads_32.8_33kbp"]
    assert all(v["equal"] and v["rc"] == 0 for v in res["variants"])
    assert res["times"] == "not measured (CPU run)"


@pytest.mark.parametrize("wrapper", ["trim_cuts", "trim_cuts_wire"])
def test_tool_exits_1_on_a_wrong_code(wrapper, tmp_path, monkeypatch):
    """The wrapper's codes come back with the bad-quality flag flipped.
    (Not the cuts: the host's emit trusts them to lie inside the read.)"""
    right = getattr(trim_cuda, wrapper)
    monkeypatch.setattr(trim_cuda, wrapper,
                        lambda *a, **kw: right(*a, **kw) ^ (1 << 15))
    out = tmp_path / "verify.json"
    assert kv.main([str(out)], device="cpu", scale=SCALE) == 1
    res = json.loads(out.read_text())
    bad = {c["source"] for c in res["configs"] if not c["equal"]}
    assert not res["equal"]
    assert bad == ({"raw"} if wrapper == "trim_cuts" else {"band", "rank"})
