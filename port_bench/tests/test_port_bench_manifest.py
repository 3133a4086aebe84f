"""BENCHMARK.json and every file it names: loadable, and within the contract."""

import json

import pytest

from port_bench.harness import cells

MANIFEST = cells.load_manifest()
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CELLS = [w["name"] for w in MANIFEST["workloads"]]
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_top_level_keys_and_size():
    assert set(MANIFEST) == TOP_KEYS
    assert len(cells.MANIFEST.read_bytes()) <= 64 * 1024
    assert MANIFEST["paths"] == ["port_bench"]
    assert all(not w.startswith("/") and ".." not in w for w in MANIFEST["command"])
    assert 1 <= MANIFEST["run_seconds"] <= 51


def test_check_fits_with_24_cells():
    rs = MANIFEST["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", MANIFEST["configs"] + MANIFEST["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert cells.NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert cells.NAME.match(entry[key])
    if "unit" in entry:
        assert cells.UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
    texts = [entry[k] for k in ("why", "layer") if k in entry]
    if "file" in entry:                     # a configuration's source
        texts.append(entry["source"])
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)


@pytest.mark.parametrize("conf", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    data = json.loads((cells.ROOT / conf["file"]).read_text())
    assert conf["file"].startswith("port_bench/")
    assert data["name"] == conf["name"] and data["source"] == conf["source"]
    assert data["reduced"] == conf["reduced"]
    assert "assumed" in data and "glio" in data
    assert any(w["config"] == conf["name"] for w in MANIFEST["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_and_metrics(name):
    cell = cells.load_cell(name)
    assert cell.entry["chips"] in (1, 4)
    assert cells.load_driver(cell.run["driver"]).Driver
    assert cell.traffic["kind"]
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    assert set(cell.run["limits"]) and all(v >= 0 for v in cell.run["limits"].values())


@pytest.mark.parametrize("name", CELLS)
def test_run_parameters(name):
    run = cells.load_cell(name).run
    for key in ("warm_units", "check_units", "host_units", "trace_units", "breakdown_units"):
        assert isinstance(run[key], int) and run[key] >= 0, key
    assert run["warm_units"] >= 1 and run["check_units"] >= 1 and run["trace_units"] >= 1


@pytest.mark.parametrize("name", [c for c in CELLS if cells.load_cell(c).run["driver"] == "window"])
def test_window_cells_time_a_full_map(name):
    """The map ring holds ``local_map_width`` scans only after as many
    keyframes: the cell steps that many untimed first."""
    cell = cells.load_cell(name)
    assert cell.run["warm_units"] >= cell.config["glio"]["estimator"]["local_map_width"]


@pytest.mark.parametrize("metric", MANIFEST["per_layer"], ids=lambda m: m["name"])
def test_per_layer_reader(metric):
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert metric["moves"] in e2e
    for cell in metric.get("workloads", []):
        assert cell in CELLS
        assert cell in e2e[metric["moves"]].get("workloads", CELLS)
    assert callable(cells.load_reader(metric["name"]).read)
    if metric["name"].endswith("_roofline"):
        assert metric["unit"] == "%"


def test_bounds():
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
