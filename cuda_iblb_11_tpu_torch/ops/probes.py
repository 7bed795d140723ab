"""The probe kernels P1-P3 (csrc/probes.cu): the port of the Pallas kernels
of scripts/probe_bw.py and scripts/probe_vpu.py, with which the card
measures its own ceilings.

    P2  probe_copy       out = x or x * 1.0000001 over float4 vectors,
                         optionally in place (probe_bw.py:67, :72)
    P3  probe_ring_copy  the copy through a ring of depth on-chip stages fed
                         by asynchronous bulk copies (probe_bw.py:86, :117)
    P1  probe_chain      R dependent fma / add / mul links on each element
                         (probe_vpu.py:55, :59; bodies :95-116)

Each wrapper launches its kernel for a float32 CUDA tensor (or raises) and
counts the launch; for a CPU tensor it runs the plain torch version beside
it.  The plain versions are the same arithmetic in eager torch and agree
with the kernels bit for bit: the copy and the scale round as the kernels
do, and the fma link is formed in float64, where v * a + b is exact for
0.5 <= |v| < 32 (a 48-bit product plus a term whose lowest bit lies no
lower than the product's), then rounded once to float32, as fmaf rounds.
A multiply and an add in float32 would round twice, and that chain drifts
from fmaf's steadily, about 2e-8 relative per link.
"""

from __future__ import annotations

import time

import torch

from cuda_iblb_11_tpu_torch.ops import _kernels

SCALE = 1.0000001      # the scale probe's factor, as the TPU probe's
CHAIN_A, CHAIN_B = 1.0000001, 1e-7
# the link's constants as the kernel holds them (float32), exactly in f64
_A32 = float(torch.tensor(CHAIN_A, dtype=torch.float32))
_B32 = float(torch.tensor(CHAIN_B, dtype=torch.float32))
CHAIN_OPS = ("fma", "add", "mul")
FLOPS_PER_LINK = {"fma": 2, "add": 1, "mul": 1}


def require_card(what: str) -> torch.device:
    """The card a probe measures; raises where none is visible (a probe
    never measures the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} measures the card: no CUDA device is "
                           "visible (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def device_ms(fn, reps):
    """Mean device ms per call of fn over `reps` calls, from CUDA events.
    A spin kernel ahead of the start event keeps the card busy while the
    host enqueues the calls, so a call whose wrapper takes longer on the
    host than its kernel on the card is timed by its kernel."""
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(1 << 20)
    end.record()
    end.synchronize()
    cycles_per_s = (1 << 20) / (start.elapsed_time(end) / 1e3)
    torch.cuda._sleep(int(cycles_per_s * (1.5 * host_s * reps + 2e-3)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _check_f32(name, t, device=None):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} dtype {t.dtype} != torch.float32 (the "
                         "probes are float32 only)")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, not {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _out(x, out):
    if out is None:
        return torch.empty_like(x)
    if out.shape != x.shape:
        raise ValueError(f"out shape {tuple(out.shape)} != {tuple(x.shape)}")
    _check_f32("out", out, x.device)
    return out


# --- P2 --------------------------------------------------------------------

def probe_copy_reference(x, scale=False, out=None):
    """Plain version of P2: out = x (or x * SCALE); in place when out is
    x."""
    y = x * SCALE if scale else x.clone()
    return y if out is None else out.copy_(y)


def probe_copy(x, scale=False, out=None, threads=256, blocks=None):
    """P2 on a float32 CUDA tensor whose size is a multiple of 4 elements:
    ``threads`` per block and ``blocks`` blocks (default one float4 per
    thread) stride over the vectors.  ``out`` may be x itself (the in-place
    form) but no other tensor that overlaps it."""
    if x.device.type == "cpu":
        return probe_copy_reference(x, scale, out)
    _check_f32("x", x)
    out = _out(x, out)
    if out.data_ptr() != x.data_ptr():
        _kernels.check_disjoint("out", out, "x", x)
    if x.numel() % 4:
        raise ValueError(f"probe_copy takes whole float4 vectors, got "
                         f"{x.numel()} elements")
    if threads not in (64, 128, 256, 512, 1024):
        raise ValueError(f"threads per block {threads} not in 64..1024")
    n_vec = x.numel() // 4
    if blocks is None:
        blocks = -(-n_vec // threads)
    _kernels.launch("iblb_probe_copy", torch.float32, x.device, x.data_ptr(),
                    out.data_ptr(), n_vec, int(bool(scale)), threads,
                    int(blocks))
    probe_copy.launches += 1
    return out


probe_copy.launches = 0


# --- P3 --------------------------------------------------------------------

def probe_ring_copy_reference(x, tile_bytes=32768, depth=2, out=None):
    """Plain version of P3: the copy itself."""
    return x.clone() if out is None else out.copy_(x)


def probe_ring_copy(x, tile_bytes=32768, depth=2, out=None):
    """P3 on a float32 CUDA tensor of whole tiles of ``tile_bytes`` (a
    multiple of 16), through a ring of ``depth`` (2 or 3) stages; ``out``
    must not overlap x."""
    if x.device.type == "cpu":
        return probe_ring_copy_reference(x, tile_bytes, depth, out)
    _check_f32("x", x)
    out = _out(x, out)
    _kernels.check_disjoint("out", out, "x", x)
    if depth not in (2, 3):
        raise ValueError(f"ring depth {depth} not in (2, 3)")
    if tile_bytes % 16 or not 16 <= tile_bytes * depth <= 225 * 1024:
        raise ValueError(f"tile of {tile_bytes} B: a multiple of 16 whose "
                         f"{depth} stages fit one block's shared memory")
    nbytes = x.numel() * 4
    if nbytes % tile_bytes:
        raise ValueError(f"{nbytes} B is not a whole number of "
                         f"{tile_bytes} B tiles")
    _kernels.launch("iblb_probe_ring_copy", torch.float32, x.device,
                    x.data_ptr(), out.data_ptr(), nbytes // tile_bytes,
                    tile_bytes, depth)
    probe_ring_copy.launches += 1
    return out


probe_ring_copy.launches = 0


# --- P1 --------------------------------------------------------------------

def probe_chain_reference(x, reps, op="fma"):
    """Plain version of P1: the same chain as a Python loop of torch ops
    (the fma link in float64, rounded once; see the module docstring)."""
    v = x.clone()
    for _ in range(reps):
        if op == "fma":
            v = (v.double() * _A32 + _B32).to(x.dtype)
        elif op == "add":
            v = v + CHAIN_B
        else:
            v = v * CHAIN_A
    return v


def probe_chain(x, reps, op="fma", out=None):
    """P1 on a float32 CUDA tensor: ``reps`` dependent links of ``op``
    ("fma", "add" or "mul") on every element, one thread each, 256 threads
    per block."""
    if op not in CHAIN_OPS:
        raise ValueError(f"unknown chain op {op!r} ({', '.join(CHAIN_OPS)})")
    if reps < 0:
        raise ValueError(f"chain length {reps} < 0")
    if x.device.type == "cpu":
        y = probe_chain_reference(x, reps, op)
        return y if out is None else out.copy_(y)
    _check_f32("x", x)
    out = _out(x, out)
    _kernels.check_disjoint("out", out, "x", x)
    _kernels.launch("iblb_probe_chain", torch.float32, x.device,
                    x.data_ptr(), out.data_ptr(), x.numel(), int(reps),
                    CHAIN_OPS.index(op))
    probe_chain.launches += 1
    return out


probe_chain.launches = 0
