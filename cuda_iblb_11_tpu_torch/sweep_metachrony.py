"""The metachrony sweep, the reference's primary experiment — the port of
scripts/sweep_metachrony.py.

    python -m cuda_iblb_11_tpu_torch.sweep_metachrony [--out PATH]
        [--device cuda|cpu]

Net flux per beat period against c_fraction, the number of metachronal
wavelengths across the cilia array (phase lag p_step = T c_fraction /
c_num between neighbours), at 2048 x 2048 with 16 cilia: c_fraction 1, 2,
3, 4, 6, 8, 12, 16, each over one beat (T = 100,000 steps) run as 10
chunks of T / 10.  Every point runs at temporal K = 16 on the whole band
super-step, one B5 and one B4 launch per 16 steps on the card, in f32 (the
JAX sweep) and in f64 (raw storage).  Each chunk is a multiple of K, so
that no step of a beat leaves that path (a remainder would run single
steps, B2 and the torch IB: another path than the one recorded).
run_point raises, rather than record another path, where the plan is not
the whole band super-step at K, a chunk is not a multiple of K, or on the
cuda backend a beat's launches are not steps / K of B5 and of B4 and none
of B2.

Per point and dtype: Q per beat (lattice units), p_step, finiteness (the
JAX record's keys), Q after each chunk, the beat's seconds and MLUPS, the
launches and the resolved configuration.  Per point: the f32-vs-f64
relative flux difference, and each dtype's relative distance to the JAX
package's TPU record validation/metachrony.json (read as a file; reported,
not gated); per dtype the c_fraction of the largest Q beside JAX's.

sweep() and run_point() take the knobs the tests cut (points, dtypes,
steps, chunks, temporal, backend, device, and SimConfig fields such as
c_num, c_space, ydim), listed under the record's ``reduced``; main()
passes its keyword arguments to sweep().  The record merges into
build/validation/metachrony.json unless --out (--json) says.
The runs are on the card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from cuda_iblb_11_tpu_torch.core.config import SimConfig
from cuda_iblb_11_tpu_torch.models.mucociliary import (
    MucociliarySim, resolve_device,
)
from cuda_iblb_11_tpu_torch.ops.probes import (
    REPO, VALIDATION_DIR, beat_loop, run_header, write_record,
)

DEFAULT_JSON = os.path.join(VALIDATION_DIR, "metachrony.json")
JAX_RECORD = os.path.join(REPO, "validation", "metachrony.json")
POINTS = (1, 2, 3, 4, 6, 8, 12, 16)
SIZE = dict(c_num=16, c_space=128, ydim=2048)
DTYPES = ("float32", "float64")
K = 16
CHUNKS = 10
LEG = "band_super_whole"
COUNTED = ("B5 band_super", "B4 temporal_bulk", "B2 fused_step")


def expected_launches(steps: int, temporal: int) -> dict:
    """COUNTED's launches of a beat of ``steps`` on the cuda backend."""
    if temporal == 1:
        return {"B5 band_super": 0, "B4 temporal_bulk": 0,
                "B2 fused_step": steps}
    return {"B5 band_super": steps // temporal,
            "B4 temporal_bulk": steps // temporal, "B2 fused_step": 0}


def run_point(c_fraction, dtype="float32", device="cuda", backend="auto",
              steps=None, chunks=CHUNKS, temporal=K, **size) -> dict:
    """One beat (``steps``, T by default) at c_fraction in ``chunks``
    equal chunks; ``size`` replaces SimConfig fields of SIZE."""
    device = resolve_device(device)
    cfg = SimConfig(c_fraction=c_fraction, dtype=dtype, **{**SIZE, **size})
    steps = cfg.T if steps is None else steps
    chunk = steps // chunks
    # scripts/sweep_metachrony.py:54-55
    if chunk * chunks != steps or chunk % temporal:
        raise ValueError(f"{steps} steps in {chunks} chunks: each chunk must "
                         f"be a whole multiple of K = {temporal}")
    sim = MucociliarySim(cfg, backend=backend, device=device,
                         temporal=temporal)
    rc = sim.resolved_config()
    if temporal > 1 and (rc["band_leg"], rc["temporal"]) != (LEG, temporal):
        raise RuntimeError(f"c_fraction {c_fraction} {dtype}: the plan is "
                           f"{rc['band_leg']} at K = {rc['temporal']}, not "
                           f"{LEG} at K = {temporal}")
    st, samples, seconds, launches = beat_loop(sim, [chunk] * chunks)
    want = expected_launches(steps, temporal)
    if sim.backend == "cuda" and launches != want:
        raise RuntimeError(f"c_fraction {c_fraction} {dtype}: launches "
                           f"{launches}, expected {want}")
    return dict(q_per_beat=float(st.q), p_step=cfg.p_step,
                finite=all(s["finite"] for s in samples),
                q_chunks=[s["q"] for s in samples], steps=steps, chunk=chunk,
                seconds=seconds, ms_per_step=seconds * 1e3 / steps,
                mlups=cfg.size * steps / seconds / 1e6, launches=launches,
                sim=rc)


def load_jax(path=JAX_RECORD) -> dict:
    """The JAX sweep's Q per beat by c_fraction."""
    with open(path) as fh:
        return {int(cf): p["q_per_beat"] for cf, p in json.load(fh).items()}


def sweep(points=POINTS, dtypes=DTYPES, device="cuda", backend="auto",
          steps=None, chunks=CHUNKS, temporal=K, jax_record=JAX_RECORD,
          **size) -> dict:
    """The record entry of the sweep (module doc)."""
    device = resolve_device(device)
    cfg = SimConfig(**{**SIZE, **size})
    steps = cfg.T if steps is None else steps
    jax = load_jax(jax_record)
    runs = {}
    t0 = time.perf_counter()
    for dt in dtypes:
        runs[dt] = {}
        for cf in points:
            p = run_point(cf, dt, device, backend, steps, chunks, temporal,
                          **size)
            runs[dt][str(cf)] = p
            print(f"{dt} c_fraction={cf:2d}  p_step={p['p_step']:6d}  "
                  f"Q(one beat)={p['q_per_beat']:.5g}  finite={p['finite']}"
                  f"  {p['seconds']:.1f} s  {p['mlups']:.1f} MLUPS",
                  flush=True)
    qs = {dt: {cf: runs[dt][str(cf)]["q_per_beat"] for cf in points}
          for dt in dtypes}
    entry = dict(
        run_header(device), grid=[cfg.ydim, cfg.xdim], c_num=cfg.c_num,
        c_space=cfg.c_space, T=cfg.T, steps=steps, chunks=chunks,
        temporal=temporal, points=list(points), runs=runs,
        wall_s=time.perf_counter() - t0,
        jax_record=os.path.relpath(jax_record, REPO),
        jax_distance={dt: {str(cf): (q - jax[cf]) / jax[cf]
                           for cf, q in qs[dt].items()} for dt in dtypes},
        argmax_c_fraction={dt: max(qs[dt], key=qs[dt].get)
                           for dt in dtypes},
        jax_argmax_c_fraction=max(jax, key=jax.get),
        reduced=[f"{k}={v} instead of {SIZE.get(k, 'the default')}"
                 for k, v in size.items()]
        + ([f"{steps} steps of the beat's {cfg.T}"] if steps != cfg.T
           else [])
        + ([f"points {list(points)}"] if tuple(points) != POINTS else [])
        + ([f"dtypes {list(dtypes)}"] if tuple(dtypes) != DTYPES else [])
        + ([f"temporal {temporal}"] if temporal != K else []))
    if {"float32", "float64"} <= set(dtypes):
        entry["f32_vs_f64"] = {
            str(cf): abs(qs["float32"][cf] - q64) / abs(q64)
            for cf, q64 in qs["float64"].items()}
        print(f"f32 vs f64, largest: {max(entry['f32_vs_f64'].values()):.3e}"
              f"; argmax {entry['argmax_c_fraction']} (JAX "
              f"{entry['jax_argmax_c_fraction']})", flush=True)
    return entry


def main(argv=None, **knobs) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", "--json", dest="json", default=DEFAULT_JSON,
                    help="output record")
    ap.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    args = ap.parse_args(argv)
    write_record(args.json, "sweep", sweep(device=args.device, **knobs))
    print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
