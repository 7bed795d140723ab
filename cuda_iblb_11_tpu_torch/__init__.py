"""PyTorch/CUDA port of the immersed-boundary lattice-Boltzmann framework.

The JAX package ``cuda_iblb_11_tpu`` is the reference this package is held
against; the module names mirror it one for one.  Plain tensor code is
PyTorch; the fused collide+stream kernel is CUDA C++ written by hand for
Hopper (``csrc/fused_step.cu``), built with nvcc at first use and bound with
ctypes (``ops/_kernels.py``).

Layout:
    core/      state tensors (lattice constants and SimConfig are shared
               with the JAX package)
    ops/       torch oracle, IB coupling (stencil + band matmuls), the
               fused-step wrapper and its plain version, the kernel loader
    models/    cilia kinematics (f64) + the single-step mucociliary model
    io/        npz checkpoints in the JAX package's format (the output
               writers are shared with the JAX package)
    csrc/      CUDA sources
    runner.py  interval-driven run loop
    cli.py     the reference's 10 positional args + framework flags
"""

from cuda_iblb_11_tpu.core.config import SimConfig
from cuda_iblb_11_tpu_torch.models.mucociliary import MucociliarySim

__all__ = ["SimConfig", "MucociliarySim"]
