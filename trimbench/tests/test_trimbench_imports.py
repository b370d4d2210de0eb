"""No entry of the benchmark loads JAX or the JAX package, and the
reference loads nothing of the port: each is run in a process of its own,
which then lists the top-level names of its modules."""

import json
import subprocess
import sys

import pytest

from trimbench import catalog

TAIL = ("\nimport sys, json\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
ENTRIES = {
    "run": ("from trimbench import catalog, run\n"
            "run.run_cell(catalog.benchmark(), 'amplicon_pe250.plate', 3, 0.3, "
            "True, 'cpu', scale=0.002)"),
    "control": ("from trimbench import catalog, control\n"
                "b = catalog.benchmark()\n"
                "control.readings(catalog.config(b, 'wgs_pe150'), "
                "catalog.traffic('bgzf_pair'), 3, 'cpu', scale=0.0005)"),
    "drain": "import trimbench.drain",
    "reference": ("import trimbench.reference, trimbench.compare, "
                  "trimbench.corpus, trimbench.roofline"),
}


def _top_names(code):
    done = subprocess.run([sys.executable, "-c", code + TAIL],
                          cwd=catalog.ROOT, capture_output=True, text=True,
                          timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    return set(json.loads(done.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_no_jax_is_loaded(entry):
    names = _top_names(ENTRIES[entry])
    assert not names & {"jax", "jaxlib", "flax", "sickle_tpu"}
    if entry != "run":
        assert "sickle_tpu_torch" not in names
    else:
        assert "sickle_tpu_torch" in names
