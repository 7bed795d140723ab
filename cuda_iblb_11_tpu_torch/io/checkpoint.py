"""npz checkpoint/resume in the JAX package's format
(cuda_iblb_11_tpu/io/checkpoint.py:28-78): arrays f, force, lasts, q, it
plus the SimConfig as JSON, so a checkpoint written by either package
resumes in the other.  A bf16 state's f is stored as its 2-byte bits
(|V2, core/state.py), the bytes JAX's save writes for its bf16 f, so the
port resumes from JAX's bf16 checkpoints (JAX's own load refuses them:
ROADMAP Queue 3).  The sharded orbax format waits for the multi-device
slice (ROADMAP Queue 1 item 12)."""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from cuda_iblb_11_tpu_torch.core.config import SimConfig
from cuda_iblb_11_tpu_torch.core.state import (
    FlowState, state_from_numpy, state_to_numpy,
)

# Fields that determine state compatibility; run-length and output knobs
# (i_pow, p_num, bigdata, sharc) may differ between save and resume.
_STATE_FIELDS = ("c_fraction", "c_num", "c_space", "re", "t_num", "t_pow",
                 "length", "ydim", "dtype", "storage")


def save(path: str, state: FlowState, cfg: SimConfig) -> None:
    """Atomic save: a temp file in the same directory, then os.replace, so
    a crash mid-save never destroys the previous good checkpoint."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez_compressed(fh, **state_to_numpy(state),
                            config=json.dumps(dataclasses.asdict(cfg)))
    os.replace(tmp, path)


def _check_compat(saved_cfg: SimConfig, cfg: SimConfig | None) -> None:
    if cfg is None:
        return
    bad = [f for f in _STATE_FIELDS
           if getattr(cfg, f) != getattr(saved_cfg, f)]
    if bad:
        raise ValueError(
            f"checkpoint incompatible in fields {bad}:\n"
            f" saved: {saved_cfg}\n asked: {cfg}")


def load(path: str, cfg: SimConfig | None = None,
         device="cpu") -> tuple[FlowState, SimConfig]:
    with np.load(path, allow_pickle=False) as z:
        saved_cfg = SimConfig(**json.loads(str(z["config"])))
        _check_compat(saved_cfg, cfg)
        state = state_from_numpy(z["f"], z["force"], z["lasts"], z["q"],
                                 z["it"], device=device)
    return state, saved_cfg
