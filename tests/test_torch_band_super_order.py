"""The band super-step's launch order against what the benchmark reads of
it: ``iblb_benchmark.counts.b5.device_seconds``, given a synthetic trace
in the order csrc/band_super.cu launches a call (per sub-step the band
step, the spread of the sub-step before folded into it from the second
on, then the interpolation; after the last, the spread and, where the
block owns the flux column, the flux sum), counts every band step, every
interpolation, the last spread and the flux sum, and nothing of the B2
single steps, B4 or a library kernel around them.
"""

import pytest

from iblb_benchmark.counts import b5
from iblb_benchmark.trace import DeviceOp

NS = "void (anonymous namespace)::"
STEP = (NS + "step_kernel<float, float, float, true, true, {}>"
        "((anonymous namespace)::StepKernel<float, {}>::Args)")
NAMES = {
    "step": STEP.format("false", "false"),          # B2 and sub-step 0
    "band_step": STEP.format("true", "true"),       # the spread folded in
    "interp": NS + "interp_kernel<float>((anonymous namespace)::"
                   "IbArgs<float>)",
    "spread": NS + "spread_kernel<float>((anonymous namespace)::"
                   "IbArgs<float>)",
    "column_sum": NS + "column_sum_kernel<float, false>(float const*, int, "
                       "long long, long long, float*)",
    "kstep": NS + "kstep_kernel<float, float, float>((anonymous "
                  "namespace)::KStepArgs<float>)",
    "gemm": "sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x32",
    "mul": "void at::native::vectorized_elementwise_kernel<4, "
           "at::native::AUnaryFunctor<float, float, float, "
           "at::native::binary_internal::MulFunctor<float> > >",
}


def band_super_call(K, owned):
    """The kernels of one call, by NAMES key: 2K + 2 with the flux
    column, 2K + 1 without."""
    seq = ["step", "interp"] + ["band_step", "interp"] * (K - 1) + ["spread"]
    return seq + (["column_sum"] if owned else [])


def single_step():
    """A B2 step and the eager IB around it (ops/ib_band.py)."""
    return ["step", "gemm", "mul", "gemm"]


def counted(keys):
    """The indices of the operations that device_seconds counts, in a
    trace of the keys in order: each in turn the one that takes time."""
    out = []
    for i in range(len(keys)):
        ops = [DeviceOp(NAMES[k], float(j), float(j) + (j == i))
               for j, k in enumerate(keys)]
        if b5.device_seconds(ops) == 1.0:
            out.append(i)
    return out


@pytest.mark.parametrize("owned", [True, False])
@pytest.mark.parametrize("K", [1, 2, 16])
def test_b5_device_seconds_counts_the_fused_launch_order(K, owned):
    call = band_super_call(K, owned)
    assert len(call) == 2 * K + 1 + owned
    # an interval's shape: single steps, a B4 call, a B5 call right after
    # the B4 flux sum, single steps, a B5 call right after a single step,
    # single steps and a B4 call
    one = single_step()
    keys = (one + ["kstep", "kstep", "column_sum"] + call + one + call + one
            + ["kstep", "column_sum"])
    first = len(one) + 3
    second = first + len(call) + len(one)
    assert keys[second - 1] == "gemm" and keys[first - 1] == "column_sum"
    assert counted(keys) == (list(range(first, first + len(call)))
                             + list(range(second, second + len(call))))


def test_b5_device_seconds_counts_no_single_step():
    # B2 steps alone, one followed by the flux sum of a B4 call: nothing
    keys = single_step() * 3 + ["step", "kstep", "column_sum", "step"]
    assert counted(keys) == []
