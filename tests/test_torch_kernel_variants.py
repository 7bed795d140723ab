"""The kernel library's build variants and the one reader of the card's
name: each variant build (the probes' A/B runs) differs from the default
build only by its define and hashes to its own key; only the probes ask
for one (identity_collide: probe_vpu.py and probe_kstep.py;
one_block_per_sm: probe_kstep.py); the default flags are unchanged and
hold no define; each define's branch sits in the one source it changes;
``_kernels.using`` swaps the library in use for a block and restores it.
The card's name and power limit are read by one function,
ops/probes.card_line, the only place of the port that runs nvidia-smi."""

import ast
import os
import subprocess

import pytest

from cuda_iblb_11_tpu_torch.ops import _kernels, probes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "cuda_iblb_11_tpu_torch")
DEFINE = "-DIBLB_IDENTITY_COLLIDE"
SMEM_DEFINE = f"-DIBLB_KSTEP_MIN_SMEM={120 * 1024}"


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return out


def _strings(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    return {n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)}


def test_identity_variant_flags_and_key():
    default = _kernels.nvcc_flags()
    assert default is _kernels.NVCC_FLAGS
    assert not any(f.startswith("-D") for f in default)
    assert _kernels.nvcc_flags("identity_collide") == default + [DEFINE]
    assert _kernels.VARIANTS == {"identity_collide": [DEFINE],
                                 "one_block_per_sm": [SMEM_DEFINE]}
    keys = {_kernels.source_digest(v) for v in (None, *_kernels.VARIANTS)}
    assert len(keys) == 1 + len(_kernels.VARIANTS)
    with pytest.raises(ValueError, match="variant"):
        _kernels.nvcc_flags("fast")
    with pytest.raises(ValueError, match="variant"):
        _kernels.load("fast")


def test_only_probe_vpu_asks_for_the_identity_build():
    def users(variant):
        return sorted(os.path.relpath(p, REPO) for p in _port_sources()
                      if variant in _strings(p))

    assert users("identity_collide") == [
        "cuda_iblb_11_tpu_torch/ops/_kernels.py",
        "cuda_iblb_11_tpu_torch/probe_kstep.py",
        "cuda_iblb_11_tpu_torch/probe_vpu.py"]
    assert users("one_block_per_sm") == [
        "cuda_iblb_11_tpu_torch/ops/_kernels.py",
        "cuda_iblb_11_tpu_torch/probe_kstep.py"]


def test_using_swaps_the_library_for_a_block(monkeypatch):
    default, other = object(), object()
    monkeypatch.setattr(_kernels, "_LIBRARY", default)
    with _kernels.using(other) as lib:
        assert lib is other and _kernels.load() is other
    assert _kernels.load() is default
    with pytest.raises(KeyError):
        with _kernels.using(other):
            raise KeyError("a launch failed")
    assert _kernels.load() is default


def test_identity_branch_sits_behind_its_define():
    sources = {}
    for name in os.listdir(_kernels.CSRC):
        with open(os.path.join(_kernels.CSRC, name)) as fh:
            sources[name] = fh.read()
    assert [n for n, s in sources.items()
            if "IBLB_IDENTITY_COLLIDE" in s] == ["collide.cuh"]
    assert [n for n, s in sources.items()
            if "IBLB_KSTEP_MIN_SMEM" in s] == ["ghost_temporal.cu"]
    launch = sources["ghost_temporal.cu"].split("int launch_pass(", 1)[1]
    assert launch.index("#ifdef IBLB_KSTEP_MIN_SMEM") \
        < launch.index("cudaFuncSetAttribute")
    body = sources["collide.cuh"].split("void collide_cell(", 1)[1]
    body = body.split("\n}\n", 1)[0]
    assert "#ifdef IBLB_IDENTITY_COLLIDE" in body
    assert body.index("f1[d] = f[d]") < body.index("#else") \
        < body.index("inv_rho") < body.index("#endif")


def test_one_reader_of_the_card_line(monkeypatch):
    users = sorted(os.path.relpath(p, REPO) for p in _port_sources()
                   if "nvidia-smi" in _strings(p))
    assert users == ["cuda_iblb_11_tpu_torch/ops/probes.py"]
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(
            cmd, 0, "NVIDIA H100 80GB HBM3, 700.00 W\nNVIDIA H100 80GB "
                    "HBM3, 700.00 W\n", "")

    monkeypatch.setattr(probes.subprocess, "run", fake_run)
    assert probes.card_line() == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert calls == [["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"]]


def test_entry_names_refuse_a_dtype_without_a_build(monkeypatch):
    # every entry has _f32, _f64 and _bf16 builds (the probes _f32 only);
    # any other pairing raises before a library is loaded, so no dtype
    # ever reaches another dtype's kernel (the f64 entry took every dtype
    # but f32 before bf16 had builds of its own)
    import torch

    assert _kernels.entry_name("iblb_fused_step", torch.bfloat16) == \
        "iblb_fused_step_bf16"
    assert _kernels.entry_name("iblb_band_super", torch.float64) == \
        "iblb_band_super_f64"
    assert set(_kernels.BF16_ENTRIES) == set(_kernels.SIGNATURES)
    loads = []
    monkeypatch.setattr(_kernels, "load", lambda *a: loads.append(a))
    for name, dtype in (("iblb_fused_step", torch.float16),
                        ("iblb_probe_chain", torch.bfloat16),
                        ("iblb_probe_copy", torch.float64),
                        ("iblb_ghost_temporal", torch.int32)):
        with pytest.raises(NotImplementedError, match="no .* kernel"):
            _kernels.launch(name, dtype, torch.device("cpu"))
    assert loads == []
    assert _kernels.entry_name("iblb_collide_slabs", torch.bfloat16) == \
        "iblb_collide_slabs_bf16"
