"""Wall-clock timing and throughput accounting (the port's own copy of
cuda_iblb_11_tpu/utils/timing.py).

Replaces the reference's portable ``seconds()`` (seconds.cpp:33-102) with
time.perf_counter, and adds the MLUPS (million lattice-site updates per
second) counter the reference never had — its nominal run derives to
~0.62 MLUPS (SURVEY.md §6)."""

from __future__ import annotations

import time
from dataclasses import dataclass, field


def seconds() -> float:
    return time.perf_counter()


@dataclass
class ThroughputMeter:
    cells: int
    steps: int = 0
    elapsed: float = 0.0
    _t0: float | None = field(default=None, repr=False)

    def start(self):
        self._t0 = seconds()

    def stop(self, steps: int):
        if self._t0 is None:
            raise RuntimeError("ThroughputMeter.stop() without start()")
        self.elapsed += seconds() - self._t0
        self._t0 = None
        self.steps += steps

    @property
    def mlups(self) -> float:
        if self.elapsed == 0:
            return 0.0
        return self.cells * self.steps / self.elapsed / 1e6

    @property
    def steps_per_s(self) -> float:
        return self.steps / self.elapsed if self.elapsed else 0.0


def predict_completion(start_epoch: float, first_interval_s: float,
                       intervals_total: int) -> float:
    """Completion-time prediction from the first interval's wall time
    (main.cu:1007-1022)."""
    return start_epoch + first_interval_s * intervals_total
