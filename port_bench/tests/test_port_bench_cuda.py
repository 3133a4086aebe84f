"""Each cell, run for a few seconds on the card, prints a sound last line."""

import json
import subprocess
import sys

import pytest
import torch

from port_bench.harness import cells

MANIFEST = cells.load_manifest()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_runs_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark runs on the card only")
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", cell,
                          "--seed", str(2**31 + 29), "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, cwd=cells.ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    names = {m["name"] for m in cells.load_cell(cell).end_to_end}
    assert set(res["metrics"]) == names
