"""Each cell's run rehearsed at a tiny size on the CPU (the program's plain
versions at rehearse.py's one tiny size), with and without the trace; the
runs driven with the timed path broken underneath, which the check has to
call not correct; and a configuration under a name no test names,
rehearsed the same way."""

import dataclasses
import json
import os

import pytest

from iblb_benchmark import check, harness
from iblb_benchmark.tests import rehearse

with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as fh:
    CELLS = [w["name"] for w in json.load(fh)["workloads"]]


def _run(name, trace=False, seed=2**31 + 11, **kw):
    cell = harness.load_cell(name)
    return cell, rehearse.run(cell, seed, trace=trace, **kw)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_cell_rehearsal(name, trace):
    cell, r = _run(name, trace)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    run = r["run"]
    assert run["interval"] == 40 and run["steps"] == 40 * run["intervals"]
    assert run["first_step"] % 40 == 0 and 0 <= run["first_step"] < 1000
    if cell.traffic["temporal"] == "auto":
        assert run["resolved"]["band_leg"] == rehearse.LEG
    assert run["resolved"]["dtype"] == cell.traffic["dtype"]
    assert list(r["checks"]) == [n for n in check.NUMBERS
                                 if n in cell.spec["limits"]]
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]
    if trace:
        traced = cell.spec["trace_intervals"] + harness.HOST_TRACE_INTERVALS
        assert r["attempted"] >= traced
        assert run["traced_intervals"] == traced
        assert run["device_profile_s"] > 0 and run["host_profile_s"] > 0
        assert r["device"]["window_s"] == run["device_profile_s"]
        # no device on the CPU: only the host's counts are read
        host = {m["name"] for m in cell.per_layer if m["name"].split(".")[0]
                in ("aten_ops_per_step", "launch_calls_per_step")}
        assert set(r["metrics"]) == host and len(host) == 2
        aten = [n for n in host if n.startswith("aten")][0]
        assert r["metrics"][aten]["value"] > 10
        assert "busy_s" not in r["device"] and r["device"]["window_s"] > 0
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert all(m["value"] > 0 for m in r["metrics"].values())
        assert [m["unit"] for m in r["metrics"].values()].count("MLUPS") == 1
        parts = run["setup_parts"]
        assert list(parts) == ["start", "context", "sim", "warm"]
        assert list(parts.values()) == sorted(parts.values())
        assert parts["warm"] == run["setup_s"]


def test_seeds_pick_the_phase_not_the_work():
    _, a = _run(CELLS[0], seed=7)
    _, b = _run(CELLS[0], seed=7 + 25)
    _, c = _run(CELLS[0], seed=8)
    assert a["run"]["first_step"] == b["run"]["first_step"] == 7 * 40
    assert c["run"]["first_step"] == 8 * 40
    assert a["run"]["first"] == b["run"]["first"]


class _Broken:
    """The program's sim with its interval call broken by ``fault``."""

    def __init__(self, sim, fault):
        self._sim, self._fault = sim, fault

    def __getattr__(self, name):
        return getattr(self._sim, name)

    def run_chunk(self, state, n):
        return self._fault(self._sim, state, n)


def _unchanged(sim, state, n):
    """A step that returns its state unchanged (the counter moves on)."""
    return state._replace(it=state.it + n)


def _flux_altered(sim, state, n):
    """The interval's answer altered where it is produced: its flux, by a
    hundredth."""
    out = sim.run_chunk(state, n)
    return out._replace(q=out.q + 0.01 * (out.q - state.q).abs())


def _cell_altered(sim, state, n):
    """One cell of the flow altered where it is produced."""
    out = sim.run_chunk(state, n)
    f = out.f.clone()
    f[1, f.shape[1] // 2, f.shape[2] // 2] += 1e-3
    return out._replace(f=f)


def _half_left_out(sim, state, n):
    """The upper half of the grid left where it was (its rows not
    stepped)."""
    out = sim.run_chunk(state, n)
    f = out.f.clone()
    h = f.shape[1] // 2
    f[:, h:] = state.f[:, h:]
    return out._replace(f=f)


def _faults():
    """Every cell with each fault it can have: the flux altered only
    where the cell compares its flux."""
    out = []
    for name in CELLS:
        with open(os.path.join(harness.HERE, "workloads",
                               name + ".json")) as fh:
            limits = json.load(fh)["limits"]
        out += [(name, f) for f in (_unchanged, _cell_altered,
                                    _half_left_out)]
        if "q_rel" in limits:
            out.append((name, _flux_altered))
    return out


@pytest.mark.parametrize("name,fault", _faults())
def test_a_broken_timed_path_is_not_correct(name, fault):
    _, r = _run(name, wrap=lambda sim: _Broken(sim, fault))
    assert not r["correct"], r["checks"]
    assert r["failed"] >= 1


def test_the_window_runs_whole_intervals_for_its_seconds():
    cell = harness.load_cell(CELLS[0])
    r = rehearse.run(cell, 3, 2.0)
    run = r["run"]
    assert run["window_s"] >= 2.0 and run["intervals"] >= 2
    assert r["metrics"]["mlups"]["value"] == pytest.approx(
        96 * 256 * run["steps"] / run["window_s"] / 1e6)


def _renamed(name, config):
    """The cell ``name`` built from its files, its configuration renamed
    ``config`` and the cell ``config.<its traffic>``."""
    cell = harness.load_cell(name)
    traffic = name.split(".", 1)[1]
    return dataclasses.replace(
        cell, name=f"{config}.{traffic}",
        config={**cell.config, "name": config})


def test_a_configuration_under_a_new_name_rehearses():
    """Nothing keys on a configuration's name: the first cell's files under
    a name no test names run and pass as the cell does."""
    cell = _renamed(CELLS[0], "unnamed_array_q7")
    r = rehearse.run(cell, 2**31 + 11)
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert r["run"]["interval"] == 40
    _, same = _run(CELLS[0])
    assert r["run"]["first"] == same["run"]["first"]
