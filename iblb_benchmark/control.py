"""The readings that a cell's check limits are set from, in one process:

    python3 -m iblb_benchmark.control --workload <name> --seeds 1,2,...
        --control-seeds 1,2,3 [--seconds S] [--json PATH]

The program as the cell runs it, on each of ``--seeds`` (the lower
readings: the largest of each compared number), then the control on each of
``--control-seeds`` (the upper readings: the smallest): the same run with
the program's lower-precision path switched on, the dtype the cell's file
names (bfloat16 storage for a float32 cell, float32 for a float64 one).
Each run is a short window (``--seconds``, default 1: a few intervals)
at the cell's own size, checked as a benchmark run is.  The benchmark's
own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from iblb_benchmark import check, harness


def readings(cell, seeds, seconds, dtype=None, **kw):
    """[{seed, u_rel, q_rel, first, last}] of one run per seed."""
    out = []
    for seed in seeds:
        r = harness.run(cell, seed, seconds, False, dtype=dtype, **kw)
        run = r["run"]
        row = {"seed": seed, "dtype": run["resolved"]["dtype"],
               "intervals": run["intervals"],
               **{k: max(run["first"][k], run["last"][k])
                  for k in check.NUMBERS},
               "first": run["first"], "last": run["last"]}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    cell = harness.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    cseeds = [int(s) for s in args.control_seeds.split(",")]
    sound = readings(cell, seeds, args.seconds)
    ctl = readings(cell, cseeds, args.seconds,
                   dtype=cell.spec["control"]["dtype"])
    summary = {"workload": cell.name,
               "control_dtype": cell.spec["control"]["dtype"],
               "lower": {k: max(r[k] for r in sound) for k in check.NUMBERS},
               "upper": {k: min(r[k] for r in ctl) for k in check.NUMBERS},
               "limits": cell.spec["limits"]}
    print(json.dumps(summary), flush=True)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump({"summary": summary, "sound": sound, "control": ctl},
                      fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
