"""BENCHMARK.json against the benchmark's contract, and every cell
resolving to its files: names, units, keys, sources, bounds, the run
length's budget, the configuration, traffic and cell files, the readers
of the per-layer metrics."""

import json
import os
import re

import pytest

from iblb_benchmark import check, harness

ROOT = harness.ROOT
with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
    BENCH = json.load(fh)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["iblb_benchmark"]
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert cmd == ["python3", "-m", "iblb_benchmark.run"]
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_run_seconds_fits_the_full_check():
    s = BENCH["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    runs = 2 + 14 * 24
    assert runs * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["why"])
        assert _line(c["source"]) and c["source"].startswith("https://")
        assert c["file"].startswith("iblb_benchmark/")
        with open(os.path.join(ROOT, c["file"])) as fh:
            data = json.load(fh)
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert data["source"] == c["source"]
        assert set(harness.SIM_FIELDS) <= set(data["sim"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_workloads_resolve_to_their_files():
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        cell = harness.load_cell(w["name"])
        assert set(cell.traffic) >= {"temporal", "dtype", "ib_x_edge"}
        assert cell.traffic["dtype"] in ("float32", "float64", "bfloat16")
        assert int(cell.spec["trace_intervals"]) >= 1
        assert "u_rel" in cell.spec["limits"]
        assert set(cell.spec["limits"]) <= set(check.NUMBERS)
        assert all(v > 0 for v in cell.spec["limits"].values())
        assert cell.spec["control"]["dtype"] != cell.traffic["dtype"]


def test_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert {"mlups", "setup_s"} <= e2e
    reports = {c: {m["name"] for m in BENCH["end_to_end"]
                   if c in m.get("workloads", CELLS)} for c in CELLS}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"][0]
    assert setup["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        # every cell it is read in reports the metric it moves
        assert all(m["moves"] in reports[c]
                   for c in m.get("workloads", CELLS))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        reader = harness.load_reader(m["name"])
        assert callable(reader.read)
        layers.setdefault(m["layer"], set()).add(m["name"])
    # one layer, one spelling: no two layer names differ only in case
    assert len({k.lower() for k in layers}) == len(layers)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_enough(cell):
    c = harness.load_cell(cell)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert [m["unit"] for m in c.end_to_end].count("MLUPS") == 1
    assert c.per_layer
