"""The manifest and the files it names.

``BENCHMARK.json`` at the root of the checkout lists the configurations,
the cells (``workloads``) and the metrics. Everything else is found by name:
a cell's run parameters in ``workloads/<cell>.json`` (its ``driver``, the
units it warms up, checks and traces), its configuration in the file the
manifest gives, its traffic in ``traffic/<traffic>.json``, its driver in
``drivers/<driver>.py`` and each per-layer metric's reader in
``metrics/<metric>.py``.
"""

import importlib
import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclass
class Cell:
    name: str
    entry: dict          # the manifest's workload entry
    run: dict            # workloads/<cell>.json
    config: dict         # the configuration file
    traffic: dict        # traffic/<traffic>.json
    end_to_end: list     # the manifest's end-to-end metrics this cell reports
    per_layer: list      # the manifest's per-layer metrics this cell reports


def load_manifest(path: Path = MANIFEST) -> dict:
    return json.loads(Path(path).read_text())


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    """A metric with ``workloads`` is reported in those cells; one without,
    in every cell (per-layer: every cell that reports the metric it moves)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def load_cell(name: str, manifest: dict = None, overrides: dict = None) -> Cell:
    """The cell ``name`` with its files read; ``overrides`` replaces keys of
    its run parameters, configuration and traffic (``{"run": {...},
    "traffic": {...}, "config": {...}}``, shallow), for tests at small sizes."""
    manifest = load_manifest() if manifest is None else manifest
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"port_bench: no cell {name!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    run = json.loads((BENCH_DIR / "workloads" / f"{name}.json").read_text())
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / f"{entry['traffic']}.json").read_text())
    for key, part in (("run", run), ("config", config), ("traffic", traffic)):
        part.update((overrides or {}).get(key, {}))
    e2e = [m for m in manifest["end_to_end"] if _reports(m, name, ())]
    names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"] if _reports(m, name, names)]
    return Cell(name, entry, run, config, traffic, e2e, layer)


def load_driver(name: str):
    return importlib.import_module(f"port_bench.drivers.{name}")


def load_reader(metric: str):
    """``metrics/<metric>.py`` (the name may hold dots) as a module."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
