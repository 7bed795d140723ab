"""PyTorch/CUDA port of the immersed-boundary lattice-Boltzmann framework.

The JAX package ``cuda_iblb_11_tpu`` is the reference this package is held
against; the module names mirror it one for one, and this package imports
nothing of it (it keeps its own copies of the JAX-free modules).  Plain
tensor code is PyTorch; every Pallas kernel of the path is CUDA C++ written
by hand for Hopper (``csrc/``), built with nvcc at first use and bound with
ctypes (``ops/_kernels.py``).

Layout:
    core/      SimConfig, lattice constants, state tensors
    ops/       torch oracle, IB coupling (stencil + band matmuls), the
               kernel wrappers with their plain versions (fused step, the
               step without emission, temporal bulk, band super-step, the
               probes), temporal eligibility, the kernel loader
    models/    cilia kinematics (f64) + the mucociliary model (single-step
               and K-step temporal, the quirk mode), the validation
               channel and cavity
    parallel/  the mesh of shards (sharded.py: in one process, or spread
               over the ranks of a --distributed run) and the process
               group with its transport (dist.py)
    io/        output writers (+ native C++ writers), npz checkpoints in
               the JAX package's format, sharded directory checkpoints
               (torch.distributed.checkpoint)
    utils/     timing
    csrc/      CUDA sources
    runner.py  interval-driven run loop
    cli.py     the reference's 10 positional args + framework flags
    probe_bw.py, probe_vpu.py  the card's own copy and f32 ceilings
    probe_nccl.py  whether NCCL takes two ranks on one card
"""

from cuda_iblb_11_tpu_torch.core.config import SimConfig
from cuda_iblb_11_tpu_torch.models.mucociliary import MucociliarySim

__all__ = ["SimConfig", "MucociliarySim"]
