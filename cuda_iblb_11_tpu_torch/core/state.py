"""Flow state tensors, and the crossing to and from numpy.

Same planar layout as the JAX package (cuda_iblb_11_tpu/core/state.py):

    f      [9, Y, X]        distribution functions (storage dtype)
    force  [2, BAND, X]     IB force band (zero above cfg.force_band)
    lasts  [c_num, nodes, 2] previous-step cilium node positions
    q      []               cumulative flux (never reset, main.cu:393)
    it     int              step counter

Auxiliary tensors (force, lasts, q) stay at f32 or wider under bf16 storage.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cuda_iblb_11_tpu_torch.core.config import SimConfig
from cuda_iblb_11_tpu_torch.core.lattice import Q as NQ, RHO_0, W

_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
}


def torch_dtype(dtype) -> torch.dtype:
    """torch dtype from a SimConfig dtype string (or a torch dtype)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"unknown dtype {dtype!r} "
                         f"({' | '.join(_DTYPES)})") from None


def dtype_name(dtype: torch.dtype) -> str:
    """'float32' for torch.float32 — the JAX package's spelling."""
    return str(dtype).replace("torch.", "")


def aux_dtype(dtype: torch.dtype) -> torch.dtype:
    """Force / boundary / flux precision: the storage dtype, at least f32."""
    return torch.promote_types(dtype, torch.float32)


class FlowState(NamedTuple):
    f: torch.Tensor      # [9, Y, X]
    force: torch.Tensor  # [2, BAND, X]
    lasts: torch.Tensor  # [c_num, nodes, 2]
    q: torch.Tensor      # [] cumulative flux
    it: int              # step counter


def initial_state(cfg: SimConfig, dtype=None, device="cpu") -> FlowState:
    """Cold start rho=1, u=0, force=0 (main.cu:636-654,722-754): f = w_i in
    raw storage, exactly zero in deviatoric storage (f holds f_i - w_i)."""
    dtype = torch_dtype(dtype or cfg.dtype)
    y, x = cfg.ydim, cfg.xdim
    if cfg.storage_resolved == "deviatoric":
        f = torch.zeros((NQ, y, x), dtype=dtype, device=device)
    else:
        w = torch.tensor(RHO_0 * W, dtype=dtype, device=device)
        f = w[:, None, None].expand(NQ, y, x).contiguous()
    aux = aux_dtype(dtype)
    force = torch.zeros((2, cfg.force_band, x), dtype=aux, device=device)
    lasts = torch.zeros((cfg.c_num, cfg.length, 2), dtype=aux, device=device)
    q = torch.zeros((), dtype=aux, device=device)
    return FlowState(f=f, force=force, lasts=lasts, q=q, it=0)


def _from_numpy(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype.kind not in "fiu":
        # a JAX bf16 array arrives as ml_dtypes bfloat16 (or void in npz)
        raise NotImplementedError(
            f"{a.dtype} state from numpy waits for bf16 storage (ROADMAP "
            "Queue 1 item 2)")
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def state_from_numpy(f, force, lasts, q, it, device="cpu") -> FlowState:
    """Port state from numpy arrays — a JAX FlowState field by field
    (``state_from_numpy(*map(np.asarray, jax_state), device=...)``) or an
    npz checkpoint's arrays."""
    return FlowState(
        f=_from_numpy(np.asarray(f), device),
        force=_from_numpy(np.asarray(force), device),
        lasts=_from_numpy(np.asarray(lasts), device),
        q=_from_numpy(np.asarray(q), device),
        it=int(np.asarray(it)),
    )


def state_to_numpy(state: FlowState) -> dict:
    """numpy arrays with the JAX FlowState's fields, shapes and dtypes
    (``it`` as a 0-d int32 array)."""
    out = {}
    for name in ("f", "force", "lasts", "q"):
        t = getattr(state, name).detach()
        if t.dtype == torch.bfloat16:
            raise NotImplementedError(
                "bf16 state to numpy waits for bf16 storage (ROADMAP "
                "Queue 1 item 2)")
        out[name] = t.cpu().numpy()
    out["it"] = np.asarray(state.it, np.int32)
    return out
