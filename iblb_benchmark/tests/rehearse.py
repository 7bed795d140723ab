"""A cell's run rehearsed at a tiny size on the CPU, as every test of a
run takes it: one tiny override of the sim fields for every configuration
(256 x 96, 4 cilia of 16 nodes, an interval of 40 steps of 1,000), and
temporal K = 16 where the cell runs auto, so the super-steps (32 steps an
interval, the band super-step leg) and the single-step remainder (8) both
run.  The overrides name every sim field by which the configurations
differ, so nothing here keys on a configuration's or a cell's name: a new
configuration needs only its files and its BENCHMARK.json entries."""

from __future__ import annotations

from iblb_benchmark import harness

TINY = dict(c_num=4, c_space=64, length=16, ydim=96, t_pow=3, p_num=25)
# the leg the tiny grid resolves to under auto
LEG = "band_super_whole"


def temporal(cell: harness.Cell):
    return 16 if cell.traffic["temporal"] == "auto" else None


def run(cell: harness.Cell, seed: int, seconds: float = 0.05,
        trace: bool = False, **kw) -> dict:
    """harness.run of the cell at its tiny size on the CPU."""
    return harness.run(cell, seed, seconds, trace, device="cpu",
                       sim_overrides=dict(TINY), temporal=temporal(cell),
                       **kw)
