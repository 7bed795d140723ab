"""The K-step driver's geometry (ops/ghost_temporal.kstep_geometry), which
the B4/B7 wrapper passes to csrc/ghost_temporal.cu: on the CPU, for the
shapes the main paths give it and for ragged ones, the passes add up to K
at depth <= 8, the strips and segments tile every column and row exactly
once, the threads and shared memory stay within what the kernel and an
H100 allow, the redundancy counts what the CUDA blocks collide, and B7's
blocks refuse K above their ghost pad.
"""

import pytest
import torch

from cuda_iblb_11_tpu_torch.ops.ghost_temporal import (
    MAX_THREADS, SMEM_BLOCK, kstep_geometry,
)

DTYPES = [torch.float32, torch.float64]
# (yl, pad, width): B4's bulk at 288 x 192 and 2048^2 and 8192^2, B7's
# 2048^2 and 8192^2 (2, 2) shards (x-extended by 128 a side), and ragged
# blocks no strip width divides
BLOCKS = [(64, 0, 288), (1920, 0, 2048), (8064, 0, 8192), (1024, 16, 1280),
          (4096, 16, 4352), (64, 16, 96 + 256), (128, 0, 150), (17, 0, 5),
          (16, 16, 33)]


def _cover(ranges, n):
    """Each index of [0, n) lies in exactly one range."""
    hits = [0] * n
    for lo, hi in ranges:
        assert 0 <= lo < hi <= n
        for i in range(lo, hi):
            hits[i] += 1
    return hits == [1] * n


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K", [1, 2, 5, 8, 13, 16])
@pytest.mark.parametrize("yl,pad,width", BLOCKS)
def test_kstep_geometry_tiles_the_block(yl, pad, width, K, dtype):
    geo = kstep_geometry(yl, pad, width, K, dtype)
    rows = yl + 2 * pad
    assert (geo.rows, geo.width, geo.K) == (rows, width, K)
    depths = [p.kp for p in geo.passes]
    assert sum(depths) == K and max(depths) <= 8
    assert geo.hbm_passes == -(-K // 8) == len(depths)
    assert max(depths) - min(depths) <= 1
    for p in geo.passes:
        assert p.wt >= 1 and p.wc == p.wt + 2 * p.kp
        assert _cover(p.strips(width), width)
        assert _cover(p.segments(rows), rows)
        assert p.threads % 32 == 0 and p.threads <= MAX_THREADS[dtype]
    assert geo.redundancy >= 1.0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K", [1, 4, 8, 16])
def test_kstep_geometry_fits_shared_memory(K, dtype):
    es = torch.empty((), dtype=dtype).element_size()
    for yl, pad, width in BLOCKS:
        for p in kstep_geometry(yl, pad, width, K, dtype).passes:
            # the mbarriers (four a level and the stores, 8 bytes each,
            # rounded up to 16), four ring rows per level and four stage
            # rows of wc cells
            bars = -(-(p.kp + 1) * 4 * 8 // 16) * 16
            assert p.smem_bytes == bars + (4 * p.kp + 4) * 9 * p.wc * es
            assert p.smem_bytes <= SMEM_BLOCK == 232_448


def test_kstep_geometry_of_the_main_paths():
    # B4 at 2048^2, K = 16: two passes of 8, strips of 101 (f32) and 73
    # (f64) columns; the redundancy the kernel header states (segments of
    # 320 (f32) and 214 (f64) rows, ly + 3 kp row iterations rounded up to
    # the ring's period of 4: 344 and 240)
    f32 = kstep_geometry(1920, 0, 2048, 16, torch.float32)
    f64 = kstep_geometry(1920, 0, 2048, 16, torch.float64)
    assert [(p.kp, p.wc, p.threads, p.smem_bytes) for p in f32.passes] == \
        [(8, 117, 1024, 151_920)] * 2
    # f64 fills the block's shared memory: its 288 bytes of mbarriers
    # still leave Wc at 89
    assert [(p.kp, p.wc, p.threads, p.smem_bytes) for p in f64.passes] == \
        [(8, 89, 768, 230_976)] * 2
    assert round(f32.redundancy, 3) == 1.213
    assert round(f64.redundancy, 3) == 1.301
    # at most one wave short of filling 132 SMs
    p = f32.passes[0]
    assert p.n_strips * p.n_seg <= 132


@pytest.mark.parametrize("K,yl", [(17, 64), (4, 8)])
def test_kstep_geometry_refuses_b7_beyond_its_ghost_pad(K, yl):
    # B7: K <= pad (garbage stays in the ghost rows) and yl >= pad
    with pytest.raises(ValueError, match="ghost pad|yl >= 16"):
        kstep_geometry(yl, 16, 352, K, torch.float32)
    kstep_geometry(64, 0, 352, 17, torch.float32)   # B4 has no pad


def test_kstep_geometry_refuses_other_dtypes_and_empty_blocks():
    # bf16 storage computes in f32: its rings, stage ring and scratch hold
    # f32, so its geometry is the f32 one; a dtype without a kernel raises
    assert kstep_geometry(1920, 0, 2048, 16, torch.bfloat16) == \
        kstep_geometry(1920, 0, 2048, 16, torch.float32)
    assert kstep_geometry(64, 0, 288, 4, torch.bfloat16).passes[0].threads \
        <= MAX_THREADS[torch.float32]
    with pytest.raises(NotImplementedError):
        kstep_geometry(64, 0, 288, 4, torch.float16)
    with pytest.raises(ValueError):
        kstep_geometry(64, 0, 288, 0, torch.float32)
    with pytest.raises(ValueError):
        kstep_geometry(0, 0, 288, 4, torch.float32)
