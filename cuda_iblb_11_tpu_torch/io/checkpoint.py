"""Checkpoint/resume: the JAX package's two formats
(cuda_iblb_11_tpu/io/checkpoint.py).

npz (``save``/``load``, JAX :28-78): arrays f, force, lasts, q, it plus
the SimConfig as JSON, so a checkpoint written by either package resumes
in the other.  A bf16 state's f is stored as its 2-byte bits (|V2,
core/state.py), the bytes JAX's save writes for its bf16 f, so the port
resumes from JAX's bf16 checkpoints (JAX's own load refuses them: ROADMAP
Queue 3).

A sharded directory (``save_dir``/``load_dir``), the counterpart of JAX's
orbax format (``save_orbax``/``load_orbax``, JAX :81-191) in
``torch.distributed.checkpoint`` (DCP) layout: every rank writes only its
own blocks, one key per block (``f/{iy}_{ix}`` a shard of f,
``force/{ix}`` an x-column's band force; ``lasts``, ``q`` and ``it``
replicated, written once), and rank 0 adds a sidecar, ``iblb.json``, with
the SimConfig and the saved mesh.  The save is crash-safe as JAX's is: it
is written to ``path.tmp`` and rank 0 swaps it in with renames, fenced by
barriers.  The restore goes onto a target sim's layout: each rank reads
only the saved blocks that overlap its own shards, so no host holds the
grid; without a sim it returns the whole FlowState.  bf16 f keeps its
bits.  orbax's directory (tensorstore) cannot be read without orbax, nor
DCP's by JAX: npz is the format the two packages share, and load_dir
refuses a directory that is not DCP's with that message.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import warnings

import numpy as np
import torch

from cuda_iblb_11_tpu_torch.core.config import SimConfig
from cuda_iblb_11_tpu_torch.core.state import (
    FlowState, state_from_numpy, state_to_numpy,
)

# Fields that determine state compatibility; run-length and output knobs
# (i_pow, p_num, bigdata, sharc) may differ between save and resume.
_STATE_FIELDS = ("c_fraction", "c_num", "c_space", "re", "t_num", "t_pow",
                 "length", "ydim", "dtype", "storage")

SIDECAR = "iblb.json"          # the directory format's config and mesh


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


# ---- the sharded directory format -----------------------------------------

def _dcp(fn, state_dict, path, comm):
    """dcp.save or dcp.load of state_dict at path: coordinated over the
    process group under one, in this process alone otherwise."""
    import torch.distributed.checkpoint as dcp

    with warnings.catch_warnings():
        # no_dist announces itself; that is the intent here
        warnings.simplefilter("ignore", UserWarning)
        getattr(dcp, fn)(state_dict, checkpoint_id=path,
                         no_dist=comm is None)


def _blocks(state, sim):
    """(mesh [n_y, n_x], {key: tensor} of this rank's blocks) of a
    MeshState on `sim`'s mesh, or of a single-device FlowState (sim None:
    the (1, 1) mesh)."""
    if sim is None:
        return [1, 1], {"f/0_0": state.f, "force/0": state.force}
    out = {}
    for k, (iy, ix) in enumerate(sim.shards):
        if state.f[k] is not None:
            out[f"f/{iy}_{ix}"] = state.f[k]
    for ix, force in enumerate(state.force):
        if force is not None:
            out[f"force/{ix}"] = force
    return [sim.n_y, sim.n_x], out


def save_dir(path: str, state, cfg: SimConfig, sim=None) -> None:
    """Write `state` as a sharded directory at `path` (module docstring):
    a FlowState of one device (sim None), or a MeshState of `sim`, each
    rank its own blocks.  Under a process group (sim's mesh.comm) every
    rank calls it."""
    comm = None if sim is None else sim.mesh.comm
    root = comm is None or comm.rank == 0
    path = os.path.abspath(path)
    tmp, old = path + ".tmp", path + ".old"
    if root:
        shutil.rmtree(tmp, ignore_errors=True)
    if comm is not None:
        comm.barrier()
    mesh, blocks = _blocks(state, sim)
    blocks.update(lasts=state.lasts, q=state.q,
                  it=torch.tensor(int(state.it), dtype=torch.int64))
    _dcp("save", blocks, tmp, comm)
    if root:
        with open(os.path.join(tmp, SIDECAR), "w") as fh:
            json.dump({"config": dataclasses.asdict(cfg), "mesh": mesh}, fh)
        # the swap: the previous checkpoint is removed only once the new
        # one is whole and in place
        shutil.rmtree(old, ignore_errors=True)
        if os.path.exists(path):
            os.rename(path, old)
        os.rename(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
    if comm is not None:
        comm.barrier()


def _read_dir_meta(path: str):
    """(saved SimConfig, saved mesh (n_y, n_x), DCP metadata) of a
    directory checkpoint; refuses a directory that is not the port's."""
    if not (os.path.isfile(os.path.join(path, ".metadata"))
            and os.path.isfile(os.path.join(path, SIDECAR))):
        raise ValueError(
            f"{path} is not a torch.distributed.checkpoint directory of "
            f"this package (a JAX orbax checkpoint?): the two packages' "
            f"directory formats cannot read each other; npz is the format "
            f"both read (--checkpoint-format npz)")
    import torch.distributed.checkpoint as dcp

    with open(os.path.join(path, SIDECAR)) as fh:
        side = json.load(fh)
    meta = dcp.FileSystemReader(path).read_metadata()
    return SimConfig(**side["config"]), tuple(side["mesh"]), meta


def _spans(a0: int, n: int, size: int, count: int) -> range:
    """The saved blocks (`count` of `size` along an axis) that overlap
    [a0, a0 + n)."""
    return range(a0 // size, min(-(-(a0 + n) // size), count))


def _paste(got, keys_at, y0, rows, x0, cols, syl, sxl):
    """The global window [y0, y0 + rows) x [x0, x0 + cols) from the saved
    blocks keys_at {(by, bx): key}, each [*, syl, sxl] at (by syl, bx
    sxl)."""
    first = got[next(iter(keys_at.values()))]
    out = torch.empty((first.shape[0], rows, cols), dtype=first.dtype)
    for (by, bx), key in keys_at.items():
        a0, a1 = max(y0, by * syl), min(y0 + rows, (by + 1) * syl)
        b0, b1 = max(x0, bx * sxl), min(x0 + cols, (bx + 1) * sxl)
        if a0 < a1 and b0 < b1:
            out[:, a0 - y0:a1 - y0, b0 - x0:b1 - x0] = got[key][
                :, a0 - by * syl:a1 - by * syl, b0 - bx * sxl:b1 - bx * sxl]
    return out


def load_dir(path: str, cfg: SimConfig | None = None, sim=None,
             device="cpu"):
    """(state, saved SimConfig) of a directory checkpoint.  With `sim` (a
    ShardedPallasSim or ShardedTemporalSim, any mesh) the state is a
    MeshState on its layout: each rank reads only the saved blocks that
    overlap its own shards and x-columns (a collective under a process
    group).  Without, the whole FlowState on `device`."""
    path = os.path.abspath(path)
    saved_cfg, (sy, sx), meta = _read_dir_meta(path)
    _check_compat(saved_cfg, cfg)
    Y, X, band = saved_cfg.ydim, saved_cfg.xdim, saved_cfg.force_band
    syl, sxl = Y // sy, X // sx
    if sim is None:
        windows = {"whole": (0, Y, 0, X)}
        col_windows = {"whole": (0, X)}
    else:
        yl, xl, mine = sim.yl, sim.xl, sim.mesh.mine
        windows = {k: (iy * yl, yl, ix * xl, xl)
                   for k, (iy, ix) in enumerate(sim.shards) if mine(k)}
        col_windows = {ix: (ix * xl, xl) for ix in range(sim.n_x)
                       if mine(ix)}
    f_keys = {w: {(by, bx): f"f/{by}_{bx}"
                  for by in _spans(y0, rows, syl, sy)
                  for bx in _spans(x0, cols, sxl, sx)}
              for w, (y0, rows, x0, cols) in windows.items()}
    force_keys = {w: {(0, bx): f"force/{bx}"
                      for bx in _spans(x0, cols, sxl, sx)}
                  for w, (x0, cols) in col_windows.items()}
    keys = {k for ks in [*f_keys.values(), *force_keys.values()]
            for k in ks.values()} | {"lasts", "q", "it"}
    got = {}
    for k in sorted(keys):
        m = meta.state_dict_metadata[k]
        got[k] = torch.empty(tuple(m.size), dtype=m.properties.dtype)
    _dcp("load", got, path, None if sim is None else sim.mesh.comm)

    def f_at(w):
        return _paste(got, f_keys[w], *windows[w], syl, sxl)

    def force_at(w):
        x0, cols = col_windows[w]
        ks = force_keys[w]
        height = got[next(iter(ks.values()))].shape[1]
        return _paste(got, ks, 0, band, x0, cols, height, sxl)

    it = int(got["it"])
    if sim is None:
        return FlowState(f=f_at("whole").to(device),
                         force=force_at("whole").to(device),
                         lasts=got["lasts"].to(device),
                         q=got["q"].to(device), it=it), saved_cfg

    from cuda_iblb_11_tpu_torch.parallel.sharded import MeshState, _copy_to

    devs = sim.mesh.devices
    f = [_copy_to(f_at(k), devs[k], sim.dtype) if k in windows else None
         for k in range(len(sim.shards))]
    force = [_copy_to(force_at(ix), devs[ix], sim.aux_dtype)
             if ix in col_windows else None for ix in range(sim.n_x)]
    return MeshState(f=f, force=force,
                     lasts=_copy_to(got["lasts"], sim.device, sim.aux_dtype),
                     q=_copy_to(got["q"], sim.device, sim.aux_dtype),
                     it=it), saved_cfg
