"""The model step's host spans (cuda_iblb_11_tpu_torch/utils/spans.py) on
the CPU: off by default, nothing recorded and nothing in a profile; on,
the tree of one 40-step run_chunk at K = 16 on the torch backend (32
steps in two super-steps, 8 single) on both band legs, and the same spans
as record_function events in torch.profiler unless started without
them."""

from collections import Counter

import pytest
import torch

from cuda_iblb_11_tpu_torch import MucociliarySim, SimConfig
from cuda_iblb_11_tpu_torch.utils import spans

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

# (grid, band leg): the band super-step grid of test_torch_band_super.py
# and the reference's channel
GRIDS = {"384x256": (dict(c_num=3, c_space=128, ydim=256),
                     "band_super_whole"),
         "288x192": (dict(c_num=6, c_space=48), "per_substep")}
SINGLE = Counter({("iblb.run_chunk", None, 40): 1,
                  ("iblb.steps_temporal", "iblb.run_chunk", 32): 1,
                  ("iblb.kinematics", "iblb.steps_temporal", 32): 1,
                  ("iblb.B4", "iblb.steps_temporal", 16): 2,
                  ("iblb.steps_single", "iblb.run_chunk", 8): 1,
                  ("iblb.kinematics", "iblb.steps_single", 8): 1,
                  ("iblb.B2", "iblb.steps_single", 1): 8,
                  ("iblb.ib", "iblb.steps_single", 1): 8})
LEG = {"band_super_whole": Counter({
    ("iblb.band_points", "iblb.steps_temporal", 32): 1,
    ("iblb.B5", "iblb.steps_temporal", 16): 2}),
    "per_substep": Counter({("iblb.B3", "iblb.steps_temporal", 1): 32,
                            ("iblb.ib", "iblb.steps_temporal", 1): 32})}
# the overlap mask inside each kinematics where cilia overlap: the
# channel's, 48 apart (r_max 4); none 128 apart
MASK = {"384x256": Counter(),
        "288x192": Counter({("iblb.overlap_mask", "iblb.kinematics", 32): 1,
                            ("iblb.overlap_mask", "iblb.kinematics", 8): 1})}


@pytest.fixture(autouse=True)
def recorder_off():
    spans.stop()
    yield
    spans.stop()


def _sim(grid):
    kw, leg = GRIDS[grid]
    sim = MucociliarySim(SimConfig(**kw, dtype="float32"), backend="torch",
                         device="cpu", temporal=16)
    assert sim.resolved_config()["band_leg"] == leg
    return sim, leg


def _tree(records):
    return Counter((r.name, records[r.parent].name if r.parent >= 0
                    else None, r.n) for r in records)


def test_spans_off_record_nothing():
    assert spans.span("iblb.x", 3) is spans.NULL
    with spans.span("iblb.x") as s:
        assert s is spans.NULL
    spans.start()
    spans.stop()
    sim, _ = _sim("288x192")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        sim.run_chunk(sim.init_state(), 20)
    assert spans.records() == []
    assert not [e.name for e in prof.events() if e.name.startswith("iblb.")]


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_run_chunk_records_the_step_tree(grid):
    sim, leg = _sim(grid)
    state = sim.init_state()
    spans.start()
    out = sim.run_chunk(state, 40)
    spans.stop()
    records = spans.records()
    assert out.it == state.it + 40
    assert _tree(records) == SINGLE + LEG[leg] + MASK[grid]
    assert records[0].name == "iblb.run_chunk" and records[0].parent == -1
    for r in records:
        assert r.start_ns <= r.end_ns
        if r.parent >= 0:
            p = records[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    # a second start() clears the first run's spans
    spans.start()
    spans.stop()
    assert spans.records() == []


@pytest.mark.parametrize("annotate", [True, False])
def test_spans_are_record_function_events_in_a_profile(annotate):
    # annotate=False: recorded, but kept out of the profiler's events
    sim, leg = _sim("384x256")
    spans.start(annotate=annotate)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        sim.run_chunk(sim.init_state(), 40)
    spans.stop()
    events = Counter(e.name for e in prof.events()
                     if e.name.startswith("iblb."))
    recorded = Counter(r.name for r in spans.records())
    assert recorded["iblb.B5"] == 2 and recorded["iblb.ib"] == 8
    assert events == (recorded if annotate else Counter())


def test_a_span_closes_on_an_exception():
    spans.start()
    with pytest.raises(ValueError):
        with spans.span("iblb.outer", 2):
            with spans.span("iblb.inner"):
                raise ValueError
    with spans.span("iblb.after"):
        pass
    spans.stop()
    outer, inner, after = spans.records()
    assert (outer.parent, inner.parent, after.parent) == (-1, 0, -1)
    assert (outer.n, inner.n) == (2, None)
