"""probe_kstep.py's readers on the CPU: the K-step kernel's float and
double instantiations found in a ptxas log by their mangled names (the
bf16-storage ones left out), the mbarrier instructions per row step of a
SASS opcode list, and the arithmetic of the issue slots per collided
cell."""

import types

import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
from cuda_iblb_11_tpu_torch import probe_kstep as pk
from cuda_iblb_11_tpu_torch.ops.ghost_temporal import kstep_geometry

NS = "_ZN50_GLOBAL__N__8ca168ea_17_ghost_temporal_cu_1cf1794112"
LOG = "\n".join(
    line
    for name, regs in (("kstep_kernelIfffEEvNS_9KStepArgsIT_EE", 64),
                       ("kstep_kernelIff13__nv_bfloat16EEvNS_9KStepArgsIT_"
                        "EE", 61),
                       ("kstep_kernelIdddEEvNS_9KStepArgsIT_EE", 76))
    for line in (
        f"ptxas info    : Compiling entry function '{NS}{name}' for "
        "'sm_90a'",
        f"ptxas info    : Function properties for {NS}{name}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        f"ptxas info    : Used {regs} registers, used 1 barriers"))


def test_registers_of_the_float_and_double_kernels(monkeypatch):
    monkeypatch.setattr(pk.shutil, "which", lambda name: None)
    monkeypatch.setattr(pk._kernels, "CUDA_ROOT", "/nonexistent")
    lib = types.SimpleNamespace(build_log=LOG, path="/nonexistent/lib.so")
    assert pk.kernel_build_info(lib) == {"f": {"registers": 64},
                                         "d": {"registers": 76}}


def test_mbarrier_instructions_per_row_step():
    # three roles, each row loop unrolled into the ring's four steps: 12
    # row steps; a try-wait's retry is a second TRYWAIT; the inits
    # (SYNCS.EXCH) lie outside the loops
    ops = (["SYNCS.ARRIVE.TRANS64.A1T0"] * 12
           + ["SYNCS.PHASECHK.TRANS64.TRYWAIT"] * 48
           + ["SYNCS.EXCH.64", "BAR.SYNC.DEFER_BLOCKING", "FFMA", "LDS"])
    got = pk.sync_per_step(ops)
    assert got["syncs_total"] == 61
    assert got["syncs_per_row_step"] == 5.0
    assert got["syncs"] == {"SYNCS.ARRIVE.TRANS64.A1T0": 12,
                            "SYNCS.PHASECHK.TRANS64.TRYWAIT": 48,
                            "SYNCS.EXCH.64": 1}
    assert got["barriers"] == 1


def test_issue_slots_per_collided_cell():
    # 1 ms at 1.98 GHz on 132 SMs, 4 x 32 thread instructions a cycle
    # each, over 1e8 collided cells
    assert pk.issue_slots_per_cell(1.0, 1.98e9, 132, 1e8) == \
        pytest.approx(1e-3 * 1.98e9 * 132 * 128 / 1e8)
    # B4 at 2048^2, K = 16: the cells its CUDA blocks collide
    geo = kstep_geometry(1920, 0, 2048, 16, torch.float32)
    assert pk.collided_cells(geo) == pytest.approx(
        geo.redundancy * 16 * 1920 * 2048)


def test_sm_clock_is_the_median_sample(monkeypatch):
    # ops/probes.sm_clock_hz runs the call until its seconds are up while
    # nvidia-smi samples clocks.sm, and takes the median sample (MHz)
    from cuda_iblb_11_tpu_torch.ops import probes

    class FakeSmi:
        def __init__(self, cmd, **kw):
            assert "--query-gpu=clocks.sm" in cmd

        def terminate(self):
            pass

        def communicate(self, timeout=None):
            return "1980\n1755\n1980\n", ""

    calls = []
    monkeypatch.setattr(probes.subprocess, "Popen", FakeSmi)
    monkeypatch.setattr(probes.torch.cuda, "synchronize", lambda: None)
    assert probes.sm_clock_hz(lambda: calls.append(1), seconds=1e-3) == \
        1980e6
    assert calls and len(calls) % 10 == 0
