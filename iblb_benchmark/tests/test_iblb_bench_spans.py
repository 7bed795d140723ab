"""The readers of the program's host spans (program_spans.py and the three
metrics that read them) on synthetic records: the window cut at the device
profile's steps, child spans subtracted, 0 for a leg that did not run,
None without a device profile, without the recorder or without
iblb.run_chunk; and on the spans of a real run_chunk on the CPU."""

from types import SimpleNamespace

import pytest

from cuda_iblb_11_tpu_torch import MucociliarySim, SimConfig
from cuda_iblb_11_tpu_torch.utils import spans
from cuda_iblb_11_tpu_torch.utils.spans import Span
from iblb_benchmark import harness, program_spans

READERS = ("kinematics_host_us_per_step", "kstep_loop_host_us_per_step",
           "single_step_host_us_per_step")


@pytest.fixture
def readers():
    out = {name: harness.load_reader(name) for name in READERS}
    assert spans.span("iblb.x") is not spans.NULL   # begin() turned it on
    yield out
    spans.stop()


def _interval(records, t, scale=1, temporal=True):
    """One 40-step run_chunk from t ns: 32 steps in the K-step loop (its
    kinematics 5 us, band points 3 us, one B4 10 us; 60 us in all), 8
    single (kinematics 2 us; 39 us in all), 1 us of run_chunk's own;
    every time times ``scale``.  Returns its end."""
    def add(name, parent, start, us, n):
        records.append(Span(name, parent, t + scale * start,
                            t + scale * (start + us), n))
        return len(records) - 1

    run = add("iblb.run_chunk", -1, 0, 100_000 if temporal else 40_000,
              40 if temporal else 8)
    start = 0
    if temporal:
        loop = add("iblb.steps_temporal", run, 500, 60_000, 32)
        add("iblb.kinematics", loop, 500, 5_000, 32)
        add("iblb.band_points", loop, 5_500, 3_000, 32)
        add("iblb.B4", loop, 8_500, 10_000, 16)
        start = 60_500
    single = add("iblb.steps_single", run, start, 39_000, 8)
    add("iblb.kinematics", single, start, 2_000, 8)
    add("iblb.B2", single, start + 2_000, 1_000, 1)
    return records[run].end_ns


def _window(steps=80, busy_s=0.1):
    return SimpleNamespace(steps=steps, busy_s=busy_s)


def _read(readers, w):
    return {name: r.read(w) for name, r in readers.items()}


def test_readers_cut_the_window_and_subtract_children(readers, monkeypatch):
    records, t = [], 10**9
    for scale in (1, 1, 2):         # the device profile's two, the host's
        t = _interval(records, t, scale) + 5_000
    monkeypatch.setattr(spans, "records", lambda: list(records))
    got = _read(readers, _window(80))
    assert got == pytest.approx({
        "kinematics_host_us_per_step": 2 * 10.0 / 80,
        "kstep_loop_host_us_per_step": 2 * 52.0 / 80,
        "single_step_host_us_per_step": 2 * 37.0 / 80})
    # the three host legs and run_chunk's own 1 us a call are its time
    assert sum(got.values()) + 2 * 1.0 / 80 == pytest.approx(2 * 100.0 / 80)
    # one interval's window
    assert _read(readers, _window(40)) == pytest.approx({
        "kinematics_host_us_per_step": 10.0 / 40,
        "kstep_loop_host_us_per_step": 52.0 / 40,
        "single_step_host_us_per_step": 37.0 / 40})
    # steps the spans do not cover exactly: nothing read
    assert set(_read(readers, _window(60)).values()) == {None}
    assert set(_read(readers, _window(200)).values()) == {None}


def test_a_leg_that_did_not_run_reads_zero(readers, monkeypatch):
    records = []
    _interval(records, 0, temporal=False)
    monkeypatch.setattr(spans, "records", lambda: list(records))
    got = _read(readers, _window(8))
    assert got["kstep_loop_host_us_per_step"] == 0.0
    assert got["single_step_host_us_per_step"] == pytest.approx(37.0 / 8)
    assert got["kinematics_host_us_per_step"] == pytest.approx(2.0 / 8)


def test_nothing_to_read_reads_none(readers, monkeypatch):
    records = []
    _interval(records, 0)
    monkeypatch.setattr(spans, "records", lambda: list(records))
    # no device profile (a run off the card)
    assert set(_read(readers, _window(40, busy_s=None)).values()) == {None}
    # no iblb.run_chunk: a renamed or lost span
    monkeypatch.setattr(spans, "records", lambda: [
        r._replace(name="iblb.run") if r.parent == -1 else r
        for r in records])
    assert set(_read(readers, _window(40)).values()) == {None}
    # a program without the recorder
    monkeypatch.setattr(program_spans, "_recorder", lambda: None)
    program_spans.begin()
    assert set(_read(readers, _window(40)).values()) == {None}


def test_readers_on_a_run_chunk(readers):
    # the program's own spans: 40 steps at K = 16 on the CPU, 8 single
    sim = MucociliarySim(SimConfig(c_num=6, c_space=48, dtype="float32"),
                         backend="torch", device="cpu", temporal=16)
    sim.run_chunk(sim.init_state(), 40)
    got = _read(readers, _window(40))
    assert spans.span("iblb.x") is spans.NULL      # the first read stops it
    assert all(v > 0 for v in got.values())
    run = [r for r in spans.records() if r.name == "iblb.run_chunk"][0]
    assert sum(got.values()) <= run.ns / 1e3 / 40
