"""The port's BigData measurement (cuda_iblb_11_tpu_torch/
measure_bigdata.py) on the CPU, at 192^2 with 4 cilia, 64 steps and 2
snapshot pairs in the four configurations: the overlapped and the serial
run of each format leave the same bytes, every run is counted with its
snapshot writes timed on the thread that made them, the writer is timed
alone on each thread, the cuts are listed; and runner._resolve_overlap's
auto choice agrees with the card host's committed record of the same
module (what the overlap hides in each format there) and keeps text
inline on hosts of few cores."""

import json
import os

import pytest

from cuda_iblb_11_tpu_torch import measure_bigdata as mb
from cuda_iblb_11_tpu_torch import runner

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD = os.path.join(REPO, "cuda_iblb_11_tpu_torch", "records",
                      "bigdata_e2e.json")


def test_four_configurations_leave_the_same_bytes(tmp_path):
    cfg = mb.config(0.00064, 2).replace(c_num=4, c_space=48, ydim=192)
    entry = mb.measure(cfg, repeats=1, device="cpu",
                       work=str(tmp_path / "work"))
    assert entry["config"]["iterations"] == 64
    assert entry["config"]["interval"] == 32
    assert [(r["format"], r["overlap"]) for r in entry["runs"]] == list(
        mb.CONFIGS)
    by = {(r["format"], r["overlap"]): r for r in entry["runs"]}
    for fmt in ("dat", "npz"):
        on, off = by[(fmt, True)], by[(fmt, False)]
        assert on["digest"] == off["digest"], fmt
        assert on["bytes_written"] > 0
        assert on["resolved"]["dtype"] == "float32"
        assert entry["summary"]["faster"][fmt]["same_bytes"]
        # one run of each: no spread to judge a difference by
        assert entry["summary"]["faster"][fmt]["beyond_spread"] is None
    assert by[("dat", True)]["digest"] != by[("npz", True)]["digest"]
    for (fmt, overlap), r in by.items():
        # one timed write a snapshot pair, on the worker thread when
        # overlapped, on the main thread when serial
        assert [w["it"] for w in r["writes"]] == [0, 32]
        assert all(w["main_thread"] is not overlap for w in r["writes"])
        assert 0 < r["write_cpu_s"] and 0 < r["write_wall_s"]
        assert r["process_cpu_s"] > 0
        alone = entry["writer_alone"][fmt]
        assert [len(alone["main"]), len(alone["worker"])] == \
            [mb.WRITER_REPS] * 2
    assert "write_wall_s_mean" in entry["summary"]["configs"]["dat_on"]
    assert len(entry["reduced"]) == 3 and entry["card"] is None
    assert entry["runs"][0]["resolved"]["backend"] == "torch"
    assert not (tmp_path / "work").exists()


def test_summary_judges_the_spread():
    def run(fmt, overlap, t):
        return {"format": fmt, "overlap": overlap, "runtime_s": t,
                "mlups_end_to_end": 1.0 / t, "digest": fmt}

    runs = [run("dat", True, 10.0), run("dat", True, 11.0),
            run("dat", False, 12.0), run("dat", False, 13.0),
            run("npz", True, 6.0), run("npz", True, 7.0),
            run("npz", False, 6.0), run("npz", False, 6.5)]
    faster = mb.summarize(runs)["faster"]
    assert faster["dat"] == {"overlap": True, "beyond_spread": True,
                             "same_bytes": True, "hidden_s": None}
    assert faster["npz"] == {"overlap": False, "beyond_spread": False,
                             "same_bytes": True, "hidden_s": None}
    # with the writes timed: the runtime beyond them, per setting, and
    # what the overlap hides, whatever the writes themselves took
    timed = [dict(r, write_wall_s=w) for r, w in zip(
        runs, (9.8, 10.9, 9.0, 10.0, 5.0, 6.9, 5.0, 5.5))]
    summary = mb.summarize(timed)
    assert summary["configs"]["dat_on"]["runtime_beyond_writes_s_mean"] \
        == pytest.approx(0.15)
    assert summary["configs"]["dat_off"]["runtime_beyond_writes_s_mean"] \
        == pytest.approx(3.0)
    assert summary["faster"]["dat"]["hidden_s"] == pytest.approx(2.85)
    assert summary["faster"]["npz"]["hidden_s"] == pytest.approx(0.45)


def test_overlap_auto_follows_the_card_record(monkeypatch):
    with open(RECORD) as fh:
        entry = json.load(fh)["bigdata"]
    assert entry["card"].startswith("NVIDIA") and entry["repeats"] >= 2
    faster = mb.summarize(entry["runs"])["faster"]
    assert faster == entry["summary"]["faster"]
    assert set(faster) == {"dat", "npz"}
    cores = entry["host_cores"]
    assert cores > runner.SERIAL_TEXT_MAX_CORES
    monkeypatch.setattr(runner.os, "sched_getaffinity",
                        lambda pid: set(range(cores)), raising=False)
    for fmt, judged in faster.items():
        # on the card's host the overlap hides compute in both formats,
        # whatever the writes took, and auto overlaps both there
        assert judged["hidden_s"] > 0 and judged["same_bytes"], fmt
        on, reason = runner._resolve_overlap("auto", fmt)
        assert on and "overlapped" in reason
    # the JAX package's rule for hosts of few cores stays: text inline
    monkeypatch.setattr(runner.os, "sched_getaffinity",
                        lambda pid: {0}, raising=False)
    assert not runner._resolve_overlap("auto", "dat")[0]
    assert runner._resolve_overlap("auto", "npz")[0]
    for fmt in ("dat", "npz"):
        assert runner._resolve_overlap("on", fmt) == (True, "requested")
        assert runner._resolve_overlap(False, fmt) == (False, "requested")
    with pytest.raises(ValueError, match="overlap"):
        runner._resolve_overlap("sometimes", "dat")
