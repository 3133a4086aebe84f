"""Nothing a run loads is JAX or the JAX package, by whole top-level names."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from port_bench.harness import cells, nojax

ROOT = cells.ROOT
CELLS = [w["name"] for w in cells.load_manifest()["workloads"]]


def test_names_are_compared_whole():
    assert nojax.loaded_forbidden(["glio_tpu_torch.models.batch", "numpy"]) == []
    assert nojax.loaded_forbidden(["glio_tpu.models", "jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "glio_tpu", "jax", "jaxlib"]


@pytest.mark.parametrize("name", CELLS)
def test_a_cell_imports_no_jax(name):
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
from port_bench.harness import cells, runner, nojax
cell = cells.load_cell({name!r})
drv = cells.load_driver(cell.run["driver"])
from port_bench.reference import window, batch
from port_bench import control, measure, roofline
import glio_tpu_torch.config, glio_tpu_torch.data.episode
import glio_tpu_torch.models.sliding_window, glio_tpu_torch.models.batch
for m in cell.per_layer:
    cells.load_reader(m["name"])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "glio_tpu_torch" in loaded
    assert nojax.loaded_forbidden(loaded) == []


def test_no_result_without_a_card():
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "window.tc",
                          "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert not out.stdout.strip()


def test_no_result_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "batch.l0",
                          "--seed", "5", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0
    assert not out.stdout.strip()
