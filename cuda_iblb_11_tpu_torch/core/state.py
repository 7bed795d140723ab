"""Flow state tensors, and the crossing to and from numpy.

Same planar layout as the JAX package (cuda_iblb_11_tpu/core/state.py):

    f      [9, Y, X]        distribution functions (storage dtype)
    force  [2, BAND, X]     IB force band (zero above cfg.force_band)
    lasts  [c_num, nodes, 2] previous-step cilium node positions
    q      []               cumulative flux (never reset, main.cu:393)
    it     int              step counter

Auxiliary tensors (force, lasts, q) stay at f32 or wider under bf16 storage.

bf16 crosses to and from numpy as its 2-byte bits: numpy has no bfloat16
of its own, so a JAX bf16 array reaches numpy as an ml_dtypes bfloat16 and
an npz stores it as void (|V2).  Both are read by their bits, without
ml_dtypes, and a bf16 tensor leaves as a |V2 array of the same bits.
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


_BF16_BITS = np.dtype("V2")   # how a bf16 array leaves for numpy


def _from_numpy(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype.kind == "V" and a.dtype.itemsize == 2 and not a.dtype.fields:
        # bf16: an ml_dtypes bfloat16 array, or |V2 from an npz
        bits = np.array(a).view(np.uint16)      # a writable copy
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    if a.dtype.kind not in "fiu":
        raise ValueError(f"state arrays are float, int or bf16 bits; got "
                         f"{a.dtype}")
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
    (``it`` as a 0-d int32 array); a bf16 tensor as a |V2 array of its
    bits, what an npz of JAX's bf16 state holds."""
    out = {}
    for name in ("f", "force", "lasts", "q"):
        t = getattr(state, name).detach().cpu()
        if t.dtype == torch.bfloat16:
            out[name] = t.view(torch.int16).numpy().view(_BF16_BITS)
        else:
            out[name] = t.numpy()
    out["it"] = np.asarray(state.it, np.int32)
    return out
