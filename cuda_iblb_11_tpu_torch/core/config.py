"""Simulation configuration with reference CLI parity.

The port's own copy of cuda_iblb_11_tpu/core/config.py, with the same
arithmetic for every derived quantity (tests/test_torch_copies.py holds
the two equal).

Reproduces the 10 positional arguments and every derived quantity of the
reference host driver (reference: CUDA_IBLB_11/main.cu:267-321,336):

    c_fraction c_num c_space Re T_num T_pow I_pow P_num ShARC BigData

Derived:
    XDIM       = c_num * c_space                     (main.cu:298)
    T          = nearbyint(T_num * 10**T_pow)        (main.cu:299)
    ITERATIONS = T * I_pow                           (main.cu:300)
    INTERVAL   = ITERATIONS // P_num                 (main.cu:301)
    dx = 1/LENGTH, dt = 1/T, SPEED = 0.8*1000/T      (main.cu:312-314)
    TAU  = SPEED*LENGTH/(Re*C_S^2) + 1/2             (main.cu:320, C_S = 0.577)
    TAU2 = 1/(12*(TAU - 1/2)) + 1/2                  (main.cu:321, TRT magic 1/12)
    p_step = T * c_fraction // c_num                 (main.cu:336, integer division)
    scales: t_scale [ms], x_scale [um], s_scale [mm/s] (main.cu:316-318)
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from cuda_iblb_11_tpu_torch.core.lattice import CS_PARAM

# Physical scaling constants (reference: main.cu:33-34).
L_0 = 0.000006  # 6 micron cilium length [m]
T_0 = 0.067     # 67 ms beat period at 15 Hz [s]


@dataclass(frozen=True)
class SimConfig:
    """Full simulation parameterisation.

    The first ten fields mirror the reference CLI positionals; the remaining
    fields are fixed constants in the reference (LENGTH, YDIM — main.cu:271,279)
    exposed here for testing, plus new framework options.
    """

    c_fraction: int = 1      # metachronal wavelengths in the domain
    c_num: int = 6           # number of cilia
    c_space: int = 48        # cilium base spacing [lattice units]
    re: float = 1.0          # Reynolds number
    t_num: float = 1.0       # beat-period mantissa
    t_pow: int = 5           # beat-period exponent: T = round(t_num * 10**t_pow)
    i_pow: float = 1.0       # number of beat periods to simulate
    p_num: int = 100         # number of output samples
    sharc: bool = False      # cluster flag (device selection in the reference)
    bigdata: bool = False    # write full-field snapshots

    # Fixed in the reference; overridable for unit tests / new experiments.
    length: int = 96         # cilium length [lattice units] (main.cu:279)
    ydim: int = 192          # channel height (main.cu:271)

    # New-framework options (no reference counterpart).
    # "float32" (production), "bfloat16" (fast), "float64" (high-precision
    # opt-in: real f64 on CPU, XLA's f32x2 double-single emulation on TPU).
    dtype: str = "float32"
    flux_column_offset: int = 5  # flux measured at x = XDIM - 5 (ImmersedBoundary.cu:259)
    # "raw": state.f holds the distributions f_i (like the reference).
    # "deviatoric": state.f holds f_i - w_i (well-balanced storage), spending
    # the f32 mantissa on the physical deviation instead of the constant
    # equilibrium part — cuts the f32 velocity-noise floor ~100x.
    # "auto": deviatoric for float32, raw for float64.
    storage: str = "auto"

    @property
    def storage_resolved(self) -> str:
        if self.storage == "auto":
            return ("deviatoric" if self.dtype in ("float32", "bfloat16")
                    else "raw")
        return self.storage

    # ---- derived quantities -------------------------------------------------

    @property
    def xdim(self) -> int:
        return self.c_num * self.c_space

    @property
    def T(self) -> int:
        # nearbyint rounds half to even, but T_num*10**T_pow is never a .5 case
        # in practice; round() matches.
        return int(round(self.t_num * 10 ** self.t_pow))

    @property
    def iterations(self) -> int:
        return int(self.T * self.i_pow)

    @property
    def interval(self) -> int:
        return self.iterations // self.p_num

    @property
    def size(self) -> int:
        return self.xdim * self.ydim

    @property
    def dx(self) -> float:
        return 1.0 / self.length

    @property
    def dt(self) -> float:
        return 1.0 / self.T

    @property
    def speed(self) -> float:
        return 0.8 * 1000.0 / self.T

    @property
    def tau(self) -> float:
        return (self.speed * self.length) / (self.re * CS_PARAM * CS_PARAM) + 0.5

    @property
    def tau2(self) -> float:
        return 1.0 / (12.0 * (self.tau - 0.5)) + 0.5

    @property
    def mach(self) -> float:
        return self.speed / CS_PARAM

    @property
    def p_step(self) -> int:
        return self.T * self.c_fraction // self.c_num

    @property
    def ns(self) -> int:
        """Number of Lagrangian boundary points (main.cu:442)."""
        return self.length * self.c_num

    @property
    def t_scale(self) -> float:
        """Milliseconds per lattice time step (main.cu:316)."""
        return 1000.0 * self.dt * T_0

    @property
    def x_scale(self) -> float:
        """Microns per lattice unit (main.cu:317)."""
        return 1000000.0 * self.dx * L_0

    @property
    def s_scale(self) -> float:
        """mm/s per lattice velocity unit (main.cu:318)."""
        return self.x_scale / self.t_scale

    @property
    def flux_x(self) -> int:
        return self.xdim - self.flux_column_offset

    @property
    def force_band(self) -> int:
        """Rows of the IB force band.  Every Lagrangian point lies below
        y ~ length*1.02 + 2.5 (beat envelope + base shift + delta support),
        so the Eulerian force field is identically zero above this band;
        the single-chip state stores only the band (8-row aligned)."""
        return min(self.ydim, -(-(self.length + 32) // 8) * 8)

    # ---- validation ---------------------------------------------------------

    def validate(self) -> None:
        """Domain guard from the reference (main.cu:303-308) plus flag
        checks (a typoed storage mode must not silently run raw-f32 with
        its ~100x higher velocity-noise floor)."""
        if self.xdim < 2 * self.length:
            raise ValueError(
                f"not enough cilia in simulation! Cilia spacing of {self.c_space} "
                f"requires at least {-(-2 * self.length // self.c_space)} cilia"
            )
        if self.storage not in ("auto", "raw", "deviatoric"):
            raise ValueError(
                f"unknown storage mode {self.storage!r} "
                f"(auto | raw | deviatoric)")

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_argv(cls, argv: list[str], **overrides) -> "SimConfig":
        """Parse the reference's 10 positional arguments (main.cu:284-296)."""
        if len(argv) < 10:
            raise SystemExit(
                f"Too few arguments! {len(argv)} entered of 10 required."
            )
        cfg = cls(
            c_fraction=int(argv[0]),
            c_num=int(argv[1]),
            c_space=int(argv[2]),
            re=float(argv[3]),
            t_num=float(argv[4]),
            t_pow=int(argv[5]),
            i_pow=float(argv[6]),
            p_num=int(argv[7]),
            sharc=bool(int(argv[8])),
            bigdata=bool(int(argv[9])),
            **overrides,
        )
        cfg.validate()
        return cfg
