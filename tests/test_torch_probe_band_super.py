"""probe_band_super.py on the CPU: its reading of a ptxas -v build log
(the registers, shared memory and spills of band_super.cu's kernels, and
nothing of another source's), and its refusal without a card or without
the other checkout's kernel sources.
"""

import pytest
import torch

from cuda_iblb_11_tpu_torch import probe_band_super as pbs

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

NS = "_ZN61_GLOBAL__N__3f6c2a1b_13_band_super_cu_9e0c1d2a"
LOG = f"""/usr/local/cuda/bin/nvcc -gencode arch=compute_90a,code=sm_90a -O3 \
-c /r/cuda_iblb_11_tpu_torch/csrc/band_super.cu -o /b/band_super.cu.o
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{NS}13spread_kernelIfEEvNS_6IbArgsIT_EE' for 'sm_90a'
ptxas info    : Function properties for {NS}13spread_kernelIfEEvNS_6IbArgsIT_EE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 47 registers, used 1 barriers, 21536 bytes smem, 472 bytes cmem[0]
ptxas info    : Compiling entry function '{NS}11step_kernelIdLb1ELb1EEEvNS_8StepArgsIT_EE' for 'sm_90a'
ptxas info    : Function properties for {NS}11step_kernelIdLb1ELb1EEEvNS_8StepArgsIT_EE
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 63 registers, used 1 barriers, 24480 bytes smem, 472 bytes cmem[0]
ptxas info    : Compiling entry function '{NS}13interp_kernelIfEEvNS_6IbArgsIT_EE' for 'sm_90a'
ptxas info    : Function properties for {NS}13interp_kernelIfEEvNS_6IbArgsIT_EE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, 472 bytes cmem[0]
ptxas info    : Compiling entry function '{NS}11step_kernelIfffLb1ELb1ELb1EEEvNS_10StepKernelIT_XT4_EE4ArgsE' for 'sm_90a'
ptxas info    : Function properties for {NS}11step_kernelIfffLb1ELb1ELb1EEEvNS_10StepKernelIT_XT4_EE4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 57 registers, used 1 barriers, 21536 bytes smem, 808 bytes cmem[0]
/usr/local/cuda/bin/nvcc -gencode arch=compute_90a,code=sm_90a -O3 \
-c /r/cuda_iblb_11_tpu_torch/csrc/fused_step.cu -o /b/fused_step.cu.o
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111step_kernelIfLb1ELb1EEEvNS_8StepArgsIT_EE' for 'sm_90a'
ptxas info    : Used 99 registers, 472 bytes cmem[0]
"""


def test_kernel_resources_reads_the_ptxas_log():
    got = pbs.kernel_resources(LOG.replace(" \\\n", " "))
    assert got == {
        "spread_kernel<f>": dict(spill_stores=0, registers=47,
                                 smem_bytes=21536),
        "step_kernel<dLb1ELb1E>": dict(spill_stores=4, registers=63,
                                       smem_bytes=24480),
        "interp_kernel<f>": dict(spill_stores=0, registers=32,
                                 smem_bytes=0),
        # the band step with the spread folded in: three type arguments
        # and three flags
        "step_kernel<fffLb1ELb1ELb1E>": dict(spill_stores=0, registers=57,
                                             smem_bytes=21536),
    }
    # fused_step.cu's step kernel is another source's
    assert pbs.kernel_resources(LOG.replace(" \\\n", " "),
                                "fused_step.cu") == {
        "step_kernel<fLb1ELb1E>": dict(registers=99, smem_bytes=0)}


def test_probe_band_super_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible; this checks the no-GPU refusal")
    with pytest.raises(RuntimeError, match="CUDA"):
        pbs.main(["--json", str(tmp_path / "p.json")])
    assert not list(tmp_path.iterdir())
    with pytest.raises(FileNotFoundError, match="kernel sources"):
        pbs.other_library(str(tmp_path))
