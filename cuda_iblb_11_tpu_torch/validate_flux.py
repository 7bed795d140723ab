"""Golden-flux validation at the reference's channel — the port of
scripts/validate_flux.py.

    python -m cuda_iblb_11_tpu_torch.validate_flux [--steps N]
        [--samples S] [--dtype float32|float64] [--backend auto|cuda|torch]
        [--device cuda|cpu] [--json PATH]

One beat period (100,000 steps by default) at the JAX script's
configuration, SimConfig(c_num=6, c_space=48): 288 x 192 with 6 cilia, at
the model's default temporal=1 (one B2 launch a step on the card), sampled
every steps // samples steps.  The --dtype run's curve goes to stdout as
the JAX script prints it (``# t_ms<TAB>Q_scaled``, Q times x_scale), and
where the reference's Data/Nominals/flux_nom.dat is in the checkout (as
validation/flux_nom.dat; not yet committed), compare_nominal holds the
curve against it (shape correlation, final Q, monotone fraction, on
stderr).  The JAX script's ``jnp`` and ``pallas`` backends are the
port's ``torch`` and ``cuda`` (``auto``: cuda on a CUDA device).

As a validation route it runs the f64 leg (raw storage: B2 in f64) beside
an f32 one and records:
  - f32 against f64: every sample's Q and the final Q, relative;
  - each leg's first 2,000 steps against validation/flux_early_f64_c6.dat,
    the JAX package's f64 CPU oracle every 100 steps, in lattice units
    (the printed curve is scaled; the comparison is not);
  - the f32 curve against validation/flux_trt_split_c6.dat, the JAX
    package's f32 beat on a TPU: shape correlation, largest normalized
    deviation, final-Q ratio (reported, not gated).

Both legs run through ops/probes.beat_loop, the chunked beat loop that
sweep_metachrony.py runs too.  The record merges into
build/validation/validate_flux.json unless --json says, with every leg's
resolved_config().  The runs are on the card unless --device cpu is
given; without a card the cuda device raises.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from cuda_iblb_11_tpu_torch.core.config import SimConfig
from cuda_iblb_11_tpu_torch.models.mucociliary import (
    MucociliarySim, resolve_device,
)
from cuda_iblb_11_tpu_torch.ops.probes import (
    REPO, VALIDATION_DIR, beat_loop, run_header, write_record,
)

DEFAULT_JSON = os.path.join(VALIDATION_DIR, "validate_flux.json")
CONFIG = dict(c_num=6, c_space=48)            # scripts/validate_flux.py:48
STEPS, SAMPLES = 100_000, 100
EARLY = os.path.join(REPO, "validation", "flux_early_f64_c6.dat")
TPU_CURVE = os.path.join(REPO, "validation", "flux_trt_split_c6.dat")
# the reference's Data/Nominals/flux_nom.dat, where the checkout would hold
# it (it does not yet: the comparison then prints nothing)
NOMINAL = os.path.join(REPO, "validation", "flux_nom.dat")


def load_nominal(path=NOMINAL):
    """The reference's flux_nom.dat ([101, 2]: t_ms, Q x_scale), or None
    where it is absent."""
    if not os.path.exists(path):
        return None
    return np.loadtxt(path)


def load_curve(path):
    """A two-column curve file ('#' lines are comments) as an array."""
    return np.loadtxt(path, ndmin=2)


def _on_grid(ts, qs, ref_ts, ref_qs, n=80):
    """Both curves on n common times to the earlier end, each normalized
    by its largest magnitude (scripts/validate_flux.py:76-81)."""
    t_max = min(ts[-1], ref_ts[-1])
    grid = np.linspace(0, t_max, n)
    ours = np.interp(grid, ts, qs)
    theirs = np.interp(grid, ref_ts, ref_qs)
    return (ours / (np.abs(ours).max() or 1.0),
            theirs / (np.abs(theirs).max() or 1.0), ours[-1], theirs[-1])


def compare_nominal(ts, qs, nom):
    """The JAX script's comparison (:74-87) of a curve (t_ms, Q scaled)
    with the nominal one: shape correlation, final Q beside the nominal's,
    and the fraction of rising samples, printed to stderr as the script
    prints them.  None where there is no nominal or 10 samples or fewer."""
    ts, qs = np.asarray(ts, float), np.asarray(qs, float)
    if nom is None or len(qs) <= 10:
        return None
    ours_n, theirs_n, _, _ = _on_grid(ts, qs, nom[:, 0], nom[:, 1])
    out = {"shape_correlation": float(np.corrcoef(ours_n, theirs_n)[0, 1]),
           "final_q": float(qs[-1]), "final_q_nominal": float(nom[-1, 1]),
           "monotone_fraction": float(np.mean(np.diff(qs) > 0))}
    print(f"# shape correlation vs flux_nom: "
          f"{out['shape_correlation']:.4f}", file=sys.stderr)
    print(f"# final Q: ours={qs[-1]:.2f}  nominal={nom[-1,1]:.2f}",
          file=sys.stderr)
    print(f"# monotone fraction ours: {out['monotone_fraction']:.3f}",
          file=sys.stderr)
    return out


def compare_curve(ts, qs, ref):
    """A curve (t_ms, Q scaled) against another on their common times:
    the normalized shapes' correlation and largest deviation, and the
    ratio of the two Q at the earlier end."""
    ours_n, theirs_n, ours, theirs = _on_grid(
        np.asarray(ts, float), np.asarray(qs, float), ref[:, 0], ref[:, 1])
    return {"shape_correlation": float(np.corrcoef(ours_n, theirs_n)[0, 1]),
            "max_normalized_deviation": float(np.abs(ours_n
                                                     - theirs_n).max()),
            "t_ms": float(min(ts[-1], ref[-1, 0])),
            "q_ratio": float(ours / theirs)}


def against_early(samples, early):
    """Each sample at an iteration of the early golden (it, Q lattice)
    against it, relative (it = 0, where Q is 0, left out)."""
    gold = {int(i): q for i, q in early if i > 0}
    rows = [{"it": s["it"], "q": s["q"], "golden": gold[s["it"]],
             "rel": abs(s["q"] - gold[s["it"]]) / abs(gold[s["it"]])}
            for s in samples if s["it"] in gold]
    return {"golden": os.path.relpath(EARLY, REPO), "rows": rows,
            "max_rel": max((r["rel"] for r in rows), default=None)}


def run_leg(dtype="float32", steps=STEPS, samples=SAMPLES, device="cuda",
            backend="auto") -> dict:
    """One beat at CONFIG in ``dtype``: sampled every steps // samples
    steps and at every iteration of the early golden it reaches."""
    device = resolve_device(device)
    cfg = SimConfig(dtype=dtype, **CONFIG)
    sim = MucociliarySim(cfg, backend=backend, device=device)
    interval = max(1, steps // samples)
    curve_its = [interval * (k + 1) for k in range(samples)]
    early = load_curve(EARLY)
    stops = sorted(set(curve_its) | {int(i) for i in early[:, 0]
                                     if 0 < i <= curve_its[-1]})
    chunks = np.diff([0] + stops).tolist()

    def progress(s):
        if s["it"] in curve_its[9::10]:
            print(f"[{dtype}] it={s['it']} t={s['it'] * cfg.t_scale:.2f}ms "
                  f"Q={s['q'] * cfg.x_scale:.4f}", file=sys.stderr,
                  flush=True)

    st, rows, seconds, launches = beat_loop(sim, chunks, report=progress)
    by_it = {r["it"]: r for r in rows}
    n = curve_its[-1]
    return dict(
        dtype=dtype, steps=n, interval=interval, samples=samples,
        grid=[cfg.ydim, cfg.xdim], x_scale=cfg.x_scale, t_scale=cfg.t_scale,
        curve=[[0.0, 0.0]] + [[it * cfg.t_scale, by_it[it]["q"]
                               * cfg.x_scale] for it in curve_its],
        q=[by_it[it]["q"] for it in curve_its], final_q=float(st.q),
        finite=all(r["finite"] for r in rows), seconds=seconds,
        ms_per_step=seconds * 1e3 / n, mlups=cfg.size * n / seconds / 1e6,
        launches=launches, early=against_early(rows, early),
        sim=sim.resolved_config())


def f32_vs_f64(leg32, leg64) -> dict:
    """Each sample's Q of the f32 leg against the f64 leg's, relative."""
    rel = [abs(a - b) / abs(b) for a, b in zip(leg32["q"], leg64["q"])]
    return {"rel": rel, "max_rel": max(rel),
            "final_rel": abs(leg32["final_q"] - leg64["final_q"])
            / abs(leg64["final_q"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--samples", type=int, default=SAMPLES)
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "cuda", "torch"])
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "float64"])
    ap.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    ap.add_argument("--json", default=DEFAULT_JSON, help="output record")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    interval = max(1, args.steps // args.samples)
    if interval * args.samples != args.steps:
        print(f"note: running {interval * args.samples} steps "
              f"({args.samples} x {interval}; --steps {args.steps} is not "
              f"divisible by --samples)", file=sys.stderr)
    run = dict(steps=args.steps, samples=args.samples, device=device,
               backend=args.backend)
    legs = {args.dtype: run_leg(args.dtype, **run)}
    ts, qs = np.array(legs[args.dtype]["curve"]).T
    print("# t_ms\tQ_scaled")
    for t, q in zip(ts, qs):
        print(f"{t:.6g}\t{q:.6g}")
    sys.stdout.flush()
    entry = dict(run_header(device), config=CONFIG,
                 nominal=compare_nominal(ts, qs, load_nominal()))
    if args.dtype != "float64":
        legs["float64"] = run_leg("float64", **run)
        entry["f32_vs_f64"] = f32_vs_f64(legs[args.dtype], legs["float64"])
        entry["tpu_curve"] = dict(
            compare_curve(ts, qs, load_curve(TPU_CURVE)),
            curve=os.path.relpath(TPU_CURVE, REPO))
        cmp = entry["f32_vs_f64"]
        print(f"# f32 vs f64: final Q rel {cmp['final_rel']:.3e}, largest "
              f"sample rel {cmp['max_rel']:.3e}", file=sys.stderr)
    for dt, leg in legs.items():
        print(f"# [{dt}] early vs {leg['early']['golden']}: largest rel "
              f"{leg['early']['max_rel']}; {leg['ms_per_step']:.4f} ms/step",
              file=sys.stderr)
    entry.update(legs=legs, reduced=[] if interval * args.samples == STEPS
                 and args.samples == SAMPLES else [
                     f"{interval * args.samples} steps in {args.samples} "
                     f"samples instead of {STEPS} in {SAMPLES}"])
    write_record(args.json, "reference_channel", entry)
    print(f"wrote {args.json}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
