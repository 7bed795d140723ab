"""No host value copied to the device inside the model step, on the CPU.

A tensor built from a Python value on a CUDA device is a copy from
pageable host memory, which waits for all the work queued on the stream:
inside ``MucociliarySim.run_chunk`` such a copy drains the card at each
chunk and leaves it idle while the host computes the next chunk's
kinematics.  Here ``torch.tensor`` and ``torch.as_tensor`` are watched
through one chunk (after a warm chunk, so constants built once per dtype
and device are built) on the band super-step grid, the per-sub-step grid
and a single-step chunk; none may be called with a host value from the
port's ``models/`` or ``ops/``.  The scalars that replaced the two such
copies of the step (the placement's x shift and the band points' inert
anchor) are held bit for bit to the 0-d tensors they replaced.  The same
step under ``torch.cuda.set_sync_debug_mode("error")`` is a card test in
tests/test_torch_cuda.py.
"""

import sys
from collections import Counter

import pytest
import torch

from cuda_iblb_11_tpu_torch import MucociliarySim, SimConfig
from cuda_iblb_11_tpu_torch.core.state import aux_dtype
from cuda_iblb_11_tpu_torch.models.cilia import CiliaModel
from cuda_iblb_11_tpu_torch.models.mucociliary import prep_band_super_points

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

WATCHED = ("cuda_iblb_11_tpu_torch.models", "cuda_iblb_11_tpu_torch.ops")
# (grid, K, steps, band leg): the band super-step grid of
# test_torch_band_super.py (two super-steps and 8 single steps), the
# reference's channel on its per-sub-step leg, and a single-step chunk
CHUNKS = {"384x256": (dict(c_num=3, c_space=128, ydim=256), 16, 40,
                      "band_super_whole"),
          "288x192": (dict(c_num=6, c_space=48), 16, 40, "per_substep"),
          "288x192_step1": (dict(c_num=6, c_space=48), 1, 5, "single_step")}
DTYPES = {"f32": torch.float32, "f64": torch.float64,
          "bf16_aux": aux_dtype(torch.bfloat16)}


def _host_copies(monkeypatch):
    """Counter of (function, calling module) for every torch.tensor /
    torch.as_tensor called with a host value while the patch holds."""
    seen = Counter()

    def watch(fn, name):
        def watched(data, *args, **kwargs):
            if not isinstance(data, torch.Tensor):
                seen[(name, sys._getframe(1).f_globals.get("__name__"))] += 1
            return fn(data, *args, **kwargs)
        return watched

    monkeypatch.setattr(torch, "tensor", watch(torch.tensor, "tensor"))
    monkeypatch.setattr(torch, "as_tensor",
                        watch(torch.as_tensor, "as_tensor"))
    return seen


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("chunk", sorted(CHUNKS))
def test_run_chunk_copies_no_host_value(monkeypatch, chunk, dtype):
    kw, K, n, leg = CHUNKS[chunk]
    sim = MucociliarySim(SimConfig(**kw, dtype=dtype), backend="torch",
                         device="cpu", temporal=K)
    assert sim.resolved_config()["band_leg"] == leg
    warm = sim.run_chunk(sim.init_state(), n)
    with monkeypatch.context() as m:
        seen = _host_copies(m)
        out = sim.run_chunk(warm, n)
    assert out.it == warm.it + n
    assert not [k for k in seen if k[1] and k[1].startswith(WATCHED)], seen


def test_the_watch_sees_a_host_copy(monkeypatch):
    # the watch itself: a scalar tensor built in the port's models/ counts
    seen = _host_copies(monkeypatch)
    cilia = CiliaModel(SimConfig(c_num=3, c_space=128, ydim=256))
    cilia.kinematics(7)
    assert seen[("as_tensor", "cuda_iblb_11_tpu_torch.models.cilia")] >= 1


def _sim_inputs(dtype, it0=12_345, n=32):
    """The 384 x 256 grid's kinematics of n steps from it0, placed and
    anchored in dtype, with every x moved by up to a cilium spacing each
    way, so the placement wraps at both edges."""
    cfg = SimConfig(c_num=3, c_space=128, ydim=256)
    cilia = CiliaModel(cfg, dtype=dtype)
    pos, vel = cilia.kinematics(torch.arange(it0, it0 + n))
    g = torch.Generator().manual_seed(3)
    moved = pos.clone()
    moved[..., 0] += (torch.rand(pos.shape[:-1], generator=g,
                                 dtype=pos.dtype) - 0.5) * 2 * cfg.c_space
    return cfg, cilia, pos, moved, vel


def _former_place_and_mask(cilia, pos, vel):
    """place_and_mask with its x shift added as a 0-d tensor, as before."""
    cfg = cilia.cfg
    pos, vel = pos.to(cilia.dtype), vel.to(cilia.dtype)
    xdim = float(cfg.xdim)
    x = torch.tensor(cilia.shift_x, dtype=cilia.dtype) + pos[..., 0]
    x = torch.where(x < 0, x + xdim, torch.where(x > xdim, x - xdim, x))
    y = pos[..., 1] + 1.0
    s = torch.stack([x, y], dim=-1)
    eps = torch.ones(x.shape, dtype=torch.int32)
    for r in range(1, cilia.r_max):
        xo, yo = torch.roll(x, r, dims=-2), torch.roll(y, r, dims=-2)
        close = ((xo[..., None, :] - x[..., :, None]).abs() < 1.0) & \
                ((yo[..., None, :] - y[..., :, None]).abs() < 1.0)
        eps = torch.where(close.any(-1), torch.zeros_like(eps), eps)
    ns = cfg.c_num * cfg.length
    lead = pos.shape[:-3]
    return (s.reshape(lead + (ns, 2)), vel.reshape(lead + (ns, 2)),
            eps.reshape(lead + (ns,)))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_place_and_mask_equals_the_tensor_shift(dtype):
    _, cilia, pos, moved, vel = _sim_inputs(DTYPES[dtype])
    for p in (pos, moved):
        got = cilia.place_and_mask(p, vel)
        want = _former_place_and_mask(cilia, p, vel)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    s = cilia.place_and_mask(moved, vel)[0]
    assert 0 <= float(s[..., 0].min()) and float(s[..., 0].max()) <= 384


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_band_points_equal_the_tensor_anchor(dtype):
    cfg, cilia, pos, _, vel = _sim_inputs(DTYPES[dtype])
    _, u_s, eps = cilia.place_and_mask(pos, vel)
    anchor, frac = cilia.anchored_nodes(pos)
    K, halo, n_super = 16, 8, 2
    got = prep_band_super_points(cfg, K, halo, cilia.dtype, u_s, eps, anchor,
                                 frac, n_super)
    # the former x anchors: the inert value as an int32 0-d tensor
    n, c, ln = n_super * K, cfg.c_num, cfg.length
    ax = anchor[..., 0].reshape(n, c, ln)
    blk = ax.new_full((n, c, 128), 0)
    blk[:, :, :ln] = ax
    wstart = (torch.arange(c, dtype=torch.int32) * cfg.c_space
              - halo)[None, :, None]
    node = torch.arange(128)[None, None, :]
    axl = torch.where(node < ln, blk - wstart,
                      torch.tensor(-20000, dtype=torch.int32))
    want = axl.reshape((n_super, K) + tuple(axl.shape[1:]))
    assert got[2].dtype == torch.int32
    assert torch.equal(got[2], want)
    assert int((got[2] == -20000).sum()) == n * c * (128 - ln)
