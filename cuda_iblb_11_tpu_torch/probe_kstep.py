"""What holds the K-step driver (B4 and B7, csrc/ghost_temporal.cu) above
its bound, on B4 at 2048^2, K = 16 (chip_smoke.py's timed case: f32
deviatoric; and f64 raw).

    python -m cuda_iblb_11_tpu_torch.probe_kstep [--reps N] [--json PATH]
        [--against DIR]

1. The kernel as built, timed (ops/probes.device_ms: CUDA events after a
   spin kernel) at pass depths 8 (the driver's), 4 and 16, f32 and f64.
2. The same sources built with collide_cell a copy of its input
   (ops/_kernels.VARIANTS["identity_collide"]), at the same depths in
   f32: the time of everything but the collide's arithmetic (for this
   kernel, the identity-collide A/B of scripts/probe_vpu.py:168-219).
3. Residency, at depth 8 in f32: the driver's CUDA blocks (1,024
   threads, one per SM) against blocks of at most 512 threads (narrower
   strips, two per SM: the same 32 warps in two blocks), and each again
   from the build whose blocks ask for 120 KiB of shared memory
   (VARIANTS["one_block_per_sm"]), so that one block runs per SM.  If the
   512-thread blocks take about twice as long one per SM as two per SM,
   an SM does two blocks' rows in the time of one: the row iteration
   waits on latency, not on instruction issue.  If about as long, the
   SM's issue slots are full.
4. The kernel's registers (ptxas) and its SASS instruction mix
   (cuobjdump), float and double, its mbarrier instructions (SYNCS: arrive
   and try-wait) per role's row step, and the blocks per SM that the
   registers, threads and shared memory allow.
5. torch.profiler's device time of one call, by kernel.
6. The issue slots per collided cell: the SM clock under load
   (ops/probes.sm_clock_hz, while the call runs back to back) times the
   slots an H100 SM issues per cycle (4 schedulers x 32 lanes) times the
   SMs and the time of a call, over the cells it collides (the redundancy
   times K x rows x width), at depth 8 in f32, for the kernel and its
   collide-as-copy build: the most instructions a collided cell can cost,
   and how many of them lie outside the collide (the copy's share of the
   kernel's).
7. With --against DIR (another checkout, e.g. `git archive` of the
   parent unpacked under build/): its kernels built and its
   ops/ghost_temporal.py driving them, B4 (2048^2 f32 and f64, 8192^2
   f32) and B7 (shard (0, 0) of 2048^2 and 8192^2 on (2, 2), f32 and
   f64) held bit for bit against this build's and timed in turns (other,
   this, this, other).
Output: build/probe_kstep.json by default.  Where no card is visible it
raises.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

import torch

from cuda_iblb_11_tpu_torch import SimConfig
from cuda_iblb_11_tpu_torch.ops import _kernels, probes
from cuda_iblb_11_tpu_torch.ops import ghost_temporal as gt
from cuda_iblb_11_tpu_torch.ops import reference as ref
from cuda_iblb_11_tpu_torch.ops.temporal_bulk import temporal_bulk

DEFAULT_JSON = os.path.join(os.path.dirname(_kernels.BUILD_DIR),
                            "probe_kstep.json")
K = 16
DEPTHS = (8, 4, 16)
# threads per CUDA block at most, at depth 8 in f32: the driver's, and
# half (narrower strips, two blocks per SM)
THREAD_CAPS = (1024, 512)
# an H100 SM: registers, warps, thread instructions issued per cycle (4
# schedulers, one warp instruction of 32 lanes each)
REGS_SM = 65_536
WARPS_SM = 64
SLOTS_SM = 4 * 32
# the K-step kernel's float and double instantiations (T = Sin = Sout) in
# a mangled name
KERNEL_NAME = re.compile(r"kstep_kernelI([fd])\1\1E")
# cilia of the benchmark's grids (c_space 128), by height
C_NUM = {2048: 16, 8192: 64}
PAD, XPAD = 16, 128    # a (2, 2) shard's ghost rows and columns a side


def _near_equilibrium(shape, storage, dtype, seed=0):
    """f [9, *shape] near equilibrium, seeded, on the card."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    rho = 1.0 + 0.02 * torch.randn(shape, generator=g, device=dev,
                                   dtype=torch.float64)
    u = 0.01 * torch.randn((2,) + tuple(shape), generator=g, device=dev,
                           dtype=torch.float64)
    return ref.equilibrium(rho, u, storage).to(dtype).contiguous()


def bulk_call(dtype, storage, ydim=2048, launch=None):
    """B4's call on the ydim^2 grid with seeded inputs near equilibrium,
    through temporal_bulk, or through ``launch`` (a launch_k_steps) with
    B4's flags; and its block (rows, pad, width)."""
    cfg = SimConfig(c_num=C_NUM[ydim], c_space=128, ydim=ydim)
    band = cfg.force_band
    f = _near_equilibrium((cfg.ydim, cfg.xdim), storage, dtype)
    bh = f[None, :, band - 1].repeat(K, 1, 1).contiguous()
    out = torch.empty_like(f[:, band:])
    walls = ref.REFERENCE_WALLS

    def call():
        if launch is None:
            return temporal_bulk(f[:, band:], bh, cfg, walls, "trt_split",
                                 storage, out=out)
        return launch((1, 1, 0, cfg.flux_x, 1), f[:, band:], None, None,
                      bh, cfg, walls, "trt_split", storage, out,
                      "temporal_bulk")

    return call, (cfg.ydim - band, 0, cfg.xdim)


def shard_call(dtype, storage, ydim, launch):
    """B7's call on shard (0, 0) of the ydim^2 grid on the (2, 2) mesh: its
    ydim / 2 rows with 16 ghost rows a side, x-extended by 128 columns a
    side, the seam in it and the flux column its own."""
    cfg = SimConfig(c_num=C_NUM[ydim], c_space=128, ydim=ydim)
    band, yl, xl = cfg.force_band, ydim // 2, cfg.xdim // 2
    f = _near_equilibrium((yl + 2 * PAD, xl + 2 * XPAD), storage, dtype, 1)
    bh = f[None, :, PAD + band - 1].repeat(K, 1, 1).contiguous()
    out = torch.empty_like(f)
    flags = (1, 0, PAD + band, XPAD + cfg.flux_x % xl, 1)

    def call():
        return launch(flags, f[:, PAD:PAD + yl], f[:, :PAD],
                      f[:, PAD + yl:], bh, cfg, ref.REFERENCE_WALLS,
                      "trt_split", storage, out, "ghost_temporal")

    return call


def time_geometry(call, block, reps, dtype, kb, threads=None) -> dict:
    """ms per call with kb levels per pass and at most ``threads`` per
    CUDA block (the driver's cap unless given), with the geometry."""
    saved = gt.KB, gt.MAX_THREADS[dtype]
    try:
        gt.KB = kb
        gt.MAX_THREADS[dtype] = threads or saved[1]
        gt._geometry.cache_clear()
        geo = gt.kstep_geometry(*block, K, dtype,
                                gt._sm_count(torch.device("cuda")))
        call()
        ms = probes.device_ms(call, reps)
    finally:
        gt.KB, gt.MAX_THREADS[dtype] = saved
        gt._geometry.cache_clear()
    p = geo.passes[0]
    return dict(ms=ms, hbm_passes=geo.hbm_passes,
                redundancy=geo.redundancy, wc=p.wc, threads=p.threads,
                smem_bytes=p.smem_bytes, blocks=p.n_strips * p.n_seg,
                collided_cells=collided_cells(geo),
                ps_per_collided_cell=ms * 1e9 / collided_cells(geo))


def collided_cells(geo) -> float:
    """Cells a call collides: the redundancy times K x rows x width."""
    return geo.redundancy * geo.K * geo.rows * geo.width


def issue_slots_per_cell(ms, clock_hz, n_sm, cells) -> float:
    """Thread instructions the SMs could issue in ms at clock_hz, per
    collided cell: an upper bound on the instructions a cell costs."""
    return ms * 1e-3 * clock_hz * n_sm * SLOTS_SM / cells


def time_depths(call, block, reps, dtype=torch.float32) -> dict:
    """ms per call at each pass depth, with the geometry of each."""
    return {kb: time_geometry(call, block, reps, dtype, kb)
            for kb in DEPTHS}


def blocks_per_sm(threads, smem, registers) -> int:
    """CUDA blocks an H100 SM holds at once: by warps, by registers
    (allocated 256 a warp at a time), by shared memory (1 KiB of it kept
    per block)."""
    warps = -(-threads // 32)
    regs_warp = -(-registers * 32 // 256) * 256
    return min(WARPS_SM // warps, REGS_SM // (regs_warp * warps),
               gt.SMEM_SM // (smem + 1024), 32)


def residency(call, block, reps, libs, registers) -> dict:
    """The A/B of the docstring's item 3, f32 at depth 8."""
    rows = {}
    for cap in THREAD_CAPS:
        for name in ("kernel", "one_block_per_sm"):
            with _kernels.using(libs[name]):
                row = time_geometry(call, block, reps, torch.float32, 8,
                                    cap)
            smem = row["smem_bytes"]
            if name != "kernel":
                smem = max(smem, _kernels.ONE_BLOCK_SMEM)
            per_sm = blocks_per_sm(row["threads"], smem, registers)
            row.update(blocks_per_sm=per_sm,
                       warps_per_sm=per_sm * -(-row["threads"] // 32))
            rows[f"{cap}_threads_{name}"] = row
        rows[f"{cap}_threads_slowdown_at_one_block_per_sm"] = (
            rows[f"{cap}_threads_one_block_per_sm"]["ms"]
            / rows[f"{cap}_threads_kernel"]["ms"])
    return rows


def sync_per_step(ops) -> dict:
    """The mbarrier instructions (SYNCS) of a kernel's SASS opcodes, in all
    and, for the arrivals and try-waits (each try-wait's retry included;
    not the set-up's inits, SYNCS.EXCH), per row step: each of the three
    roles' row loops is unrolled into RING steps."""
    syncs = collections.Counter(o for o in ops if o.startswith("SYNCS"))
    in_loop = sum(n for o, n in syncs.items() if "EXCH" not in o)
    return dict(syncs=dict(syncs), syncs_total=sum(syncs.values()),
                syncs_per_row_step=in_loop / (3 * gt.RING),
                barriers=sum(o.startswith("BAR") for o in ops))


def kernel_build_info(lib) -> dict:
    """Registers (ptxas) and the SASS instruction mix of the K-step
    kernel, for float and double."""
    info = {}
    log = lib.build_log.splitlines()
    for i, line in enumerate(log):
        m = KERNEL_NAME.search(line)
        if m and "Compiling entry" in line:
            for nxt in log[i + 1:i + 4]:
                r = re.search(r"Used (\d+) registers", nxt)
                if r:
                    info.setdefault(m.group(1), {})["registers"] = int(
                        r.group(1))
    tool = shutil.which("cuobjdump") or os.path.join(_kernels.CUDA_ROOT,
                                                     "bin", "cuobjdump")
    if not os.path.exists(tool):
        return info
    text = subprocess.run([tool, "-sass", lib.path], capture_output=True,
                          text=True, timeout=300).stdout
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        m = KERNEL_NAME.search(block.split("\n", 1)[0])
        if m:
            full = re.findall(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                block)
            mix = collections.Counter(o.split(".")[0] for o in full)
            info.setdefault(m.group(1), {}).update(
                sass_instructions=len(full),
                sass_mix=dict(mix.most_common(16)),
                **sync_per_step(full))
    return info


def profile_call(call) -> dict:
    """Device ms per call by kernel name (torch.profiler, 3 calls)."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            call()
        torch.cuda.synchronize()
    rows = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0.0)
        if t:
            rows[ev.key[:80]] = t / 1e3 / 3
    return rows


def other_driver(root: str):
    """(library, launch_k_steps) of the checkout at root: its kernels
    (probe_band_super.other_library) and its ops/ghost_temporal.py, which
    computes its own geometry and launches from whichever library
    _kernels.using makes current."""
    from cuda_iblb_11_tpu_torch.probe_band_super import other_library

    path = os.path.join(os.path.abspath(root), "cuda_iblb_11_tpu_torch",
                        "ops", "ghost_temporal.py")
    spec = importlib.util.spec_from_file_location("other_ghost_temporal",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod   # its dataclasses look their module up
    spec.loader.exec_module(mod)
    return other_library(root), mod.launch_k_steps


def against_other(root: str, reps: int) -> dict:
    """Item 7 of the docstring."""
    other_lib, other_launch = other_driver(root)
    this_lib = _kernels.load()
    cases = [("B4", dt, st, n) for n, dt, st in (
        (2048, torch.float32, "deviatoric"), (2048, torch.float64, "raw"),
        (8192, torch.float32, "deviatoric"))]
    cases += [("B7", dt, st, n) for n in (2048, 8192)
              for dt, st in ((torch.float32, "deviatoric"),
                             (torch.float64, "raw"))]
    rec = {}
    for kernel, dtype, storage, ydim in cases:
        calls = {}
        for name, launch in (("this", gt.launch_k_steps),
                             ("other", other_launch)):
            calls[name] = (bulk_call(dtype, storage, ydim, launch)[0]
                           if kernel == "B4" else
                           shard_call(dtype, storage, ydim, launch))
        libs = {"this": this_lib, "other": other_lib}
        outs = {}
        for name in ("this", "other"):
            with _kernels.using(libs[name]):
                outs[name] = [t.clone() for t in calls[name]()]
        torch.cuda.synchronize()
        same = all(torch.equal(a, b)
                   for a, b in zip(outs["this"], outs["other"]))
        del outs
        times = []
        for name in ("other", "this", "this", "other"):
            with _kernels.using(libs[name]):
                times.append(probes.device_ms(calls[name], reps))
        label = (f"{kernel} {ydim}^2{' (2, 2) shard' * (kernel == 'B7')} "
                 f"{str(dtype).split('.')[1]}")
        rec[label] = dict(bit_identical=same, ms=(times[1] + times[2]) / 2,
                          ms_other=(times[0] + times[3]) / 2,
                          ms_runs=times[1:3], ms_other_runs=[times[0],
                                                             times[3]])
        print(f"{label}: bit-identical {same}; this {times[1]:.4f}, "
              f"{times[2]:.4f} ms; other {times[0]:.4f}, {times[3]:.4f} "
              f"ms", flush=True)
        del calls
        torch.cuda.empty_cache()
    return rec


def measure(reps: int = 20, against: str | None = None) -> dict:
    probes.require_card("probe_kstep")
    call64, block = bulk_call(torch.float64, "raw")
    f64 = time_depths(call64, block, reps, torch.float64)
    del call64
    call, block = bulk_call(torch.float32, "deviatoric")
    lib = _kernels.load()
    rec = {"card": probes.card_line(), "device": torch.cuda.get_device_name(0),
           "case": "B4 2048^2, K = 16, f32 deviatoric (f64: raw)",
           "kernel": time_depths(call, block, reps), "kernel_f64": f64,
           "build": kernel_build_info(lib),
           "profile_ms_per_call": profile_call(call)}
    libs = {"kernel": lib, "identity_collide":
            _kernels.load("identity_collide"),
            "one_block_per_sm": _kernels.load("one_block_per_sm")}
    with _kernels.using(libs["identity_collide"]):
        rec["collide_as_copy"] = time_depths(call, block, reps)
    for kb in DEPTHS:
        rec["kernel"][kb]["share_without_collide"] = (
            rec["collide_as_copy"][kb]["ms"] / rec["kernel"][kb]["ms"])
    clock = probes.sm_clock_hz(call)
    n_sm = gt._sm_count(torch.device("cuda"))
    rec["sm_clock_mhz"] = clock / 1e6
    rec["issue_slots_per_collided_cell"] = {
        name: issue_slots_per_cell(rec[name][8]["ms"], clock, n_sm,
                                   rec[name][8]["collided_cells"])
        for name in ("kernel", "collide_as_copy")}
    rec["residency"] = residency(call, block, reps, libs,
                                 rec["build"]["f"]["registers"])
    if against:
        rec["against"] = against_other(against, reps)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20,
                    help="calls per timing")
    ap.add_argument("--json", default=DEFAULT_JSON, help="output record")
    ap.add_argument("--against", default=None,
                    help="a checkout of another commit to hold B4 and B7 "
                         "against")
    args = ap.parse_args(argv)
    rec = measure(args.reps, args.against)
    for kb, row in rec["kernel"].items():
        print(f"depth {kb}: {row['ms']:.4f} ms per call "
              f"({row['hbm_passes']} passes, redundancy "
              f"{row['redundancy']:.3f}); collide as a copy "
              f"{rec['collide_as_copy'][kb]['ms']:.4f} ms "
              f"({row['share_without_collide']:.0%}); f64 "
              f"{rec['kernel_f64'][kb]['ms']:.4f} ms "
              f"({rec['kernel_f64'][kb]['hbm_passes']} passes)")
    slots = rec["issue_slots_per_collided_cell"]
    print(f"issue slots per collided cell (depth 8, f32, SM clock "
          f"{rec['sm_clock_mhz']:.0f} MHz): {slots['kernel']:.1f}; with "
          f"the collide a copy {slots['collide_as_copy']:.1f} "
          f"({slots['collide_as_copy'] / slots['kernel']:.0%})")
    for t, b in rec["build"].items():
        print(f"kstep_kernel<{'float' if t == 'f' else 'double'}>: "
              f"{b.get('registers')} registers, "
              f"{b.get('sass_instructions')} SASS instructions, "
              f"{b.get('syncs_total')} SYNCS ({b.get('syncs')}; "
              f"{b.get('syncs_per_row_step', 0):.2f} a role's row step), "
              f"{b.get('barriers')} BAR, {b.get('sass_mix')}")
    for name, row in rec["residency"].items():
        if isinstance(row, float):
            print(f"residency: {name}: {row:.3f}")
        else:
            print(f"residency: {name}: {row['ms']:.4f} ms per call, Wc "
                  f"{row['wc']}, {row['threads']} threads, "
                  f"{row['blocks']} blocks, {row['blocks_per_sm']} per SM "
                  f"({row['warps_per_sm']} warps), redundancy "
                  f"{row['redundancy']:.3f}, "
                  f"{row['ps_per_collided_cell']:.3f} ps per collided cell")
    for name, ms in rec["profile_ms_per_call"].items():
        print(f"profile: {name}: {ms:.4f} ms per call")
    print(f"card: {rec['card']}")
    os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
    with open(args.json, "w") as fh:
        json.dump(rec, fh, indent=1)
    print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
