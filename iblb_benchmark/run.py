"""Run one cell of the benchmark once:

    python3 -m iblb_benchmark.run --workload <name> --seed <n>
        --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result (JSON: correct, attempted, failed, metrics, device, with --trace 1
breakdown, then run and, last, checks); the last lines of standard error
are the compared numbers beside their limits.  Exits non-zero, printing no
result, without enough CUDA devices for the cell, without the program in
this checkout, with JAX or the JAX package loaded once the window has
closed, or with --trace 1 where a per-layer metric of the cell reads
nothing.
"""

import time

T_START = time.perf_counter()   # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PROGRAM = "cuda_iblb_11_tpu_torch"


def _fail(code: int, msg: str) -> int:
    print(f"iblb_benchmark: {msg}", file=sys.stderr)
    return code


def _fmt(v):
    return f"{v:.6g}" if isinstance(v, float) else str(v)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), required=True)
    args = ap.parse_args(argv)

    # every build and kernel cache of the run stays inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, os.path.join(ROOT, "build",
                                                "iblb_benchmark", sub))

    # set-up's parts: seconds from the start to each mark
    marks = [("python", time.perf_counter() - T_START)]
    import torch

    marks.append(("torch", time.perf_counter() - T_START))
    from iblb_benchmark import harness
    from iblb_benchmark.card import card_line

    cell = harness.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        return _fail(3, "torch.cuda.is_available() is False")
    if torch.cuda.device_count() < cell.chips:
        return _fail(3, f"{torch.cuda.device_count()} CUDA device(s); the "
                        f"cell needs {cell.chips}")
    marks.append(("device_count", time.perf_counter() - T_START))
    try:
        program = __import__(PROGRAM)
    except ImportError as e:
        return _fail(4, f"the program is not in this checkout: {e}")
    if not os.path.abspath(program.__file__).startswith(ROOT + os.sep):
        return _fail(4, f"{PROGRAM} comes from {program.__file__}, not "
                        f"from this checkout {ROOT}")

    try:
        marks.append(("program", time.perf_counter() - T_START))
        result = harness.run(cell, args.seed, args.seconds,
                             bool(args.trace), t_start=T_START, marks=marks)
    except harness.MissingMetric as e:
        return _fail(6, str(e))
    banned = harness.banned_modules()
    if banned:
        return _fail(5, f"loaded in this process: {', '.join(banned)}")
    result["device"]["card"] = card_line()

    run = result["run"]
    print(f"iblb_benchmark: {cell.name} seed {args.seed} from step "
          f"{run['first_step']}: {run['intervals']} intervals of "
          f"{run['interval']} steps in {run['window_s']:.3f} s; "
          f"{run['resolved']['band_leg']} K={run['resolved']['temporal']} "
          f"{run['resolved']['dtype']}; card {result['device']['card']}",
          file=sys.stderr)
    for which in ("first", "last"):
        print(f"iblb_benchmark: {which} interval "
              + ", ".join(f"{k} {_fmt(v)}" for k, v in run[which].items()),
              file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {_fmt(c['value'])} limit {_fmt(c['limit'])}",
              file=sys.stderr)
    sys.stderr.flush()
    order = ("correct", "attempted", "failed", "metrics", "device",
             "breakdown", "run", "checks")
    print(json.dumps({k: result[k] for k in order if k in result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
