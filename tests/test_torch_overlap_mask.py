"""The cilia's overlap mask (ops/overlap_mask.py) on the CPU: the plain
version, taken in blocks of steps, is the whole-batch eager mask bit for
bit; the wrapper takes it for CPU tensors and refuses what the kernel does
not take; the model's backend picks the wrapper, and records the mask's
span only where cilia overlap; over a beat's phases the model's mask is
the benchmark's plain reference's.  The kernel itself is held to the
plain version on the card (tests/test_torch_cuda.py)."""

import pytest
import torch

from cuda_iblb_11_tpu_torch import SimConfig
from cuda_iblb_11_tpu_torch.models.cilia import CiliaModel
from cuda_iblb_11_tpu_torch.ops import overlap_mask as om
from cuda_iblb_11_tpu_torch.utils import spans

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

# cilia half their length apart (r_max 4), and 64 apart (r_max 0)
HALF = dict(c_num=8, c_space=8, length=16, ydim=96)
APART = dict(c_num=4, c_space=64, length=16, ydim=96)


def _placed(kw, dtype, its):
    """(x, y [n, c, nodes]) placed as place_and_mask places them, with
    every x moved by up to a spacing each way, so that many nodes meet."""
    cilia = CiliaModel(SimConfig(**kw), dtype=dtype)
    pos, _ = cilia.kinematics(its)
    g = torch.Generator().manual_seed(5)
    pos[..., 0] += (torch.rand(pos.shape[:-1], generator=g,
                               dtype=pos.dtype) - 0.5) * 2 * kw["c_space"]
    pos = pos.to(dtype)
    return pos[..., 0] + cilia.shift_x, pos[..., 1] + 1.0, cilia


def _eager(x, y, r_max):
    """The whole-batch mask as models/cilia.py computed it before."""
    eps = torch.ones(x.shape, dtype=torch.int32)
    for r in range(1, r_max):
        xo, yo = torch.roll(x, r, dims=-2), torch.roll(y, r, dims=-2)
        close = ((xo[..., None, :] - x[..., :, None]).abs() < 1.0) & \
                ((yo[..., None, :] - y[..., :, None]).abs() < 1.0)
        eps = torch.where(close.any(-1), torch.zeros_like(eps), eps)
    return eps


@pytest.mark.parametrize("block", [1, 3, 1 << 24])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_mask_in_blocks_is_the_eager_mask(monkeypatch, dtype, block):
    x, y, cilia = _placed(HALF, dtype, torch.arange(100, 117))
    want = _eager(x, y, cilia.r_max)
    assert (want == 0).sum() > 100
    monkeypatch.setattr(om, "MASK_BLOCK", block * 8 * 16 * 16)
    for lead in ((17,), (1, 17), ()):
        xs, ys = x.reshape(lead + x.shape[-2:]) if lead else x[5], \
            y.reshape(lead + y.shape[-2:]) if lead else y[5]
        got = om.overlap_mask_reference(xs, ys, cilia.r_max)
        ref = want.reshape(got.shape) if lead else want[5]
        assert got.dtype == torch.int32 and torch.equal(got, ref)
        assert torch.equal(om.overlap_mask(xs, ys, cilia.r_max), ref)


@pytest.mark.parametrize("r_max", [0, 1])
def test_no_neighbour_masks_nothing(r_max):
    x, y, _ = _placed(HALF, torch.float32, torch.arange(4))
    eps = om.overlap_mask(x, y, r_max)
    assert eps.dtype == torch.int32 and bool((eps == 1).all())


def test_more_neighbours_than_cilia_wrap_onto_themselves():
    # r_max - 1 >= c_num: cilium m's own nodes are among its neighbours,
    # as torch.roll wraps them, so every node is off
    x, y, _ = _placed(dict(HALF, c_num=2), torch.float32, torch.arange(3))
    assert torch.equal(om.overlap_mask(x, y, 4), _eager(x, y, 4))
    assert bool((om.overlap_mask(x, y, 4) == 0).all())


def test_wrapper_refuses_another_device():
    x = torch.zeros((2, 3, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        om.overlap_mask(x, x, 4)


def test_model_picks_the_wrapper_by_backend():
    cfg = SimConfig(**HALF)
    assert CiliaModel(cfg)._mask is om.overlap_mask_reference
    assert CiliaModel(cfg, backend="cuda")._mask is om.overlap_mask
    with pytest.raises(ValueError, match="unknown backend"):
        CiliaModel(cfg, backend="auto")


@pytest.mark.parametrize("kw,spanned", [(HALF, True), (APART, False)])
def test_the_mask_span_where_cilia_overlap(kw, spanned):
    # one iblb.overlap_mask span a batch, n its steps, and none where
    # r_max <= 1 (no mask is computed there)
    cilia = CiliaModel(SimConfig(**kw), backend="cuda")
    spans.start()
    try:
        cilia.place_and_mask(*cilia.kinematics(torch.arange(7)))
        cilia.place_and_mask(*cilia.kinematics(3))
    finally:
        spans.stop()
    got = [(r.name, r.n) for r in spans.records()]
    assert got == ([("iblb.overlap_mask", 7), ("iblb.overlap_mask", 1)]
                   if spanned else [])


@pytest.mark.parametrize("c_fraction", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mask_is_the_reference_mask_over_a_beat(dtype, c_fraction):
    """Three neighbours a node over a beat's phases: the model's plain
    mask is the benchmark reference's (iblb_benchmark/reference), it
    switches nodes off, and cilium 0, whose neighbours are the last three
    cilia, loses nodes too."""
    from iblb_benchmark.reference.kinematics import Beat
    from iblb_benchmark.reference.params import Params

    sim = dict(HALF, c_fraction=c_fraction, re=1.0, t_num=1.0, t_pow=5,
               i_pow=1.0, p_num=100, flux_column_offset=5)
    p = Params(**sim)
    its = torch.arange(0, p.T, 97)
    cilia = CiliaModel(SimConfig(**sim), dtype=dtype)
    assert cilia.r_max == 4
    _, _, eps = cilia.place_and_mask(*cilia.kinematics(its))
    _, _, eps_r = Beat(p, "cpu").placed(its, dtype)
    assert torch.equal(eps_r, eps.to(torch.float64))
    off = (eps == 0).reshape(len(its), p.c_num, p.length)
    assert off.sum() > 1000
    assert off[:, 0].sum() > 100
