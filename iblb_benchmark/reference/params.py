"""The derived quantities of a configuration, from the ten positionals of
the upstream CUDA_IBLB_11 host driver (main.cu:267-336) and its fixed
constants.  A configuration file's ``sim`` object names them."""

from __future__ import annotations

from dataclasses import dataclass

CS_PARAM = 0.577       # the host driver's speed of sound (main.cu:27)


@dataclass(frozen=True)
class Params:
    c_fraction: int
    c_num: int
    c_space: int
    re: float
    t_num: float
    t_pow: int
    i_pow: float
    p_num: int
    length: int
    ydim: int
    flux_column_offset: int

    @classmethod
    def from_sim(cls, sim: dict) -> "Params":
        return cls(**{k: sim[k] for k in cls.__dataclass_fields__})

    @property
    def xdim(self) -> int:
        return self.c_num * self.c_space

    @property
    def T(self) -> int:
        return int(round(self.t_num * 10 ** self.t_pow))

    @property
    def iterations(self) -> int:
        return int(self.T * self.i_pow)

    @property
    def interval(self) -> int:
        return self.iterations // self.p_num

    @property
    def cells(self) -> int:
        return self.xdim * self.ydim

    @property
    def tau(self) -> float:
        speed = 0.8 * 1000.0 / self.T
        return speed * self.length / (self.re * CS_PARAM * CS_PARAM) + 0.5

    @property
    def tau2(self) -> float:
        return 1.0 / (12.0 * (self.tau - 0.5)) + 0.5

    @property
    def p_step(self) -> int:
        return self.T * self.c_fraction // self.c_num

    @property
    def flux_x(self) -> int:
        return self.xdim - self.flux_column_offset

    @property
    def points(self) -> int:
        return self.c_num * self.length

    @property
    def band(self) -> int:
        """Rows that can hold IB force: every point lies below about
        1.02 length + 2.5, rounded up to 8 rows (the rows a kernel of the
        IB band reads and writes)."""
        return min(self.ydim, -(-(self.length + 32) // 8) * 8)
