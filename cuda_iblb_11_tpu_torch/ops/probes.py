"""The probe kernels P1-P3 (csrc/probes.cu): the port of the Pallas kernels
of scripts/probe_bw.py and scripts/probe_vpu.py, with which the card
measures its own ceilings.

    P2  probe_copy       out = x or x * 1.0000001 over float4 vectors,
                         optionally in place (probe_bw.py:67, :72)
    P3  probe_ring_copy  the copy through a ring of depth on-chip stages fed
                         by asynchronous bulk copies (probe_bw.py:86, :117)
    P1  probe_chain      R dependent fma / add / mul links on each element
                         (probe_vpu.py:55, :59; bodies :95-116)

and ``launch_floor_ms``, the device time of one launch of a kernel that
does nothing, in a stream of back-to-back launches: the floor under a
kernel as small as B0 (no TPU kernel; an instrument).  Beside them the
helpers the probe and validation modules share: ``require_card``,
``card_line`` (the card's name and power limit, which every record
carries), ``sm_clock_hz`` (the SM clock under a load), ``device_ms``,
``l2_bytes`` (the card's L2 size, the budget of the budgeted band legs),
the records' plumbing: ``run_header`` (where a record was made) and
``write_record`` (one entry merged into a record under
build/validation/), and ``beat_loop``, the one chunked beat loop of the
validation routes (validate_flux.py, sweep_metachrony.py).

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

import contextlib
import datetime
import json
import os
import statistics
import subprocess
import time

import torch

from cuda_iblb_11_tpu_torch.ops import _kernels

SCALE = 1.0000001      # the scale probe's factor, as the TPU probe's
RING_RUN = 4           # tiles each P3 block streams (the fastest run in
                       # probe_bw.py's sweep; longer runs leave a tail)
CHAIN_A, CHAIN_B = 1.0000001, 1e-7
# the link's constants as the kernel holds them (float32), exactly in f64
_A32 = float(torch.tensor(CHAIN_A, dtype=torch.float32))
_B32 = float(torch.tensor(CHAIN_B, dtype=torch.float32))
CHAIN_OPS = ("fma", "add", "mul")
FLOPS_PER_LINK = {"fma": 2, "add": 1, "mul": 1}
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# where the validation and measurement modules write their records
VALIDATION_DIR = os.path.join(os.path.dirname(_kernels.BUILD_DIR),
                              "validation")


def require_card(what: str) -> torch.device:
    """The card a probe measures; raises where none is visible (a probe
    never measures the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} measures the card: no CUDA device is "
                           "visible (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (the
    first card's line); raises where nvidia-smi fails."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sm_clock_hz(fn, seconds=2.0) -> float:
    """The SM clock while ``fn`` runs back to back on the card: the median
    of nvidia-smi's clocks.sm, sampled every 100 ms; raises where
    nvidia-smi gives no sample."""
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out = smi.communicate(timeout=60)[0]
    samples = [float(v) for v in out.split()]
    if not samples:
        raise RuntimeError("nvidia-smi gave no clocks.sm sample")
    return statistics.median(samples) * 1e6


def run_header(device) -> dict:
    """What every record carries about where it ran: the card's name and
    power limit as nvidia-smi gives them (None on the CPU), torch and CUDA
    versions, the date."""
    device = torch.device(device)
    return {
        "card": card_line() if device.type == "cuda" else None,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "date": datetime.date.today().isoformat(),
    }


def write_record(path, key, entry) -> None:
    """Merge ``entry`` under ``key`` into the JSON object at ``path``
    (created if missing)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    data = {}
    with contextlib.suppress(FileNotFoundError):
        with open(path) as fh:
            data = json.load(fh)
    data[key] = entry
    with open(path, "w") as fh:
        json.dump(data, fh, indent=1)


def beat_loop(sim, chunks, report=None):
    """Run ``sim`` from its initial state over consecutive chunks of
    steps.  After each chunk: the iteration, Q in lattice units and
    whether f is finite, passed to ``report`` if given.  Returns (state,
    samples, seconds of the chunks, launches of B2, B4 and B5 in them: the
    kernels the routes check).  The launch counters are read, never reset;
    the kernel library is built or loaded before the first chunk's clock
    starts."""
    from cuda_iblb_11_tpu_torch.ops.band_super import band_super
    from cuda_iblb_11_tpu_torch.ops.fused_step import fused_substep
    from cuda_iblb_11_tpu_torch.ops.temporal_bulk import temporal_bulk

    counted = {"B2 fused_step": fused_substep,
               "B4 temporal_bulk": temporal_bulk,
               "B5 band_super": band_super}
    if sim.backend == "cuda":
        _kernels.load()
    state = sim.init_state()
    samples, launches, seconds = [], dict.fromkeys(counted, 0), 0.0
    for n in chunks:
        before = {k: w.launches for k, w in counted.items()}
        t0 = time.perf_counter()
        state = sim.run_chunk(state, n)
        q = float(state.q)                  # waits for the chunk
        seconds += time.perf_counter() - t0
        for k, w in counted.items():
            launches[k] += w.launches - before[k]
        sample = {"it": int(state.it), "q": q,
                  "finite": bool(torch.isfinite(state.f).all())}
        samples.append(sample)
        if report is not None:
            report(sample)
    return state, samples, seconds, launches


def l2_bytes(device) -> int:
    """The card's L2 size: the footprint budget that builds the band
    super-step's x-tiled leg and a mesh's per-sub-step leg where it splits
    the band (the simulations plan no budget: ops/temporal.py)."""
    return torch.cuda.get_device_properties(device).L2_cache_size


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

def probe_ring_copy_reference(x, tile_bytes=32768, depth=2, out=None,
                              run=RING_RUN):
    """Plain version of P3: the copy itself."""
    return x.clone() if out is None else out.copy_(x)


def probe_ring_copy(x, tile_bytes=32768, depth=2, out=None, run=RING_RUN):
    """P3 on a float32 CUDA tensor of whole tiles of ``tile_bytes`` (a
    multiple of 16), through a ring of ``depth`` (2 or 3) stages, loaded
    and stored by the TMA, ``run`` consecutive tiles a block; ``out`` must
    not overlap x."""
    if x.device.type == "cpu":
        return probe_ring_copy_reference(x, tile_bytes, depth, out, run)
    _check_f32("x", x)
    out = _out(x, out)
    _kernels.check_disjoint("out", out, "x", x)
    if depth not in (2, 3):
        raise ValueError(f"ring depth {depth} not in (2, 3)")
    if not 1 <= run < 1 << 20:
        raise ValueError(f"run of {run} tiles a block not in 1..2^20")
    if tile_bytes % 16 or not 16 <= tile_bytes * depth <= 225 * 1024:
        raise ValueError(f"tile of {tile_bytes} B: a multiple of 16 whose "
                         f"{depth} stages fit one block's shared memory")
    nbytes = x.numel() * 4
    if nbytes % tile_bytes:
        raise ValueError(f"{nbytes} B is not a whole number of "
                         f"{tile_bytes} B tiles")
    _kernels.launch("iblb_probe_ring_copy", torch.float32, x.device,
                    x.data_ptr(), out.data_ptr(), nbytes // tile_bytes,
                    tile_bytes, depth, int(run))
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


# --- the launch floor ------------------------------------------------------

def launch_floor_ms(count=500, device=None):
    """Mean device ms per launch of an empty kernel (one block of one
    warp): ``count`` back-to-back launches issued from C, timed as one
    call by device_ms (``count`` stays below the launches the card queues
    behind the timer's spin kernel, so the card, not the host, sets the
    pace)."""
    dev = torch.device(device) if device is not None else require_card(
        "launch_floor_ms")

    def call():
        _kernels.launch("iblb_probe_empty", torch.float32, dev, int(count))

    return device_ms(call, 1) / count
