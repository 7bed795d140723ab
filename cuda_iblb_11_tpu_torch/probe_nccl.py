"""Does NCCL take two ranks on one card?  The question behind the transport
rule of parallel/dist.py (nccl only where every rank has a card of its
own; ranks that share a card go over gloo, staged through host memory).

    python -m cuda_iblb_11_tpu_torch.probe_nccl [--json PATH]

Starts two ranks on card 0 of this host, each of which joins an NCCL group
directly (not through dist.init_from_env's rule) and runs one all_reduce
and one ring send/recv of a small tensor.  Each rank reports what
happened: the values, or the error NCCL raised.  A rank still running
after TIMEOUT_S seconds is killed and reported as hung.  Prints one JSON
line (the card, torch and NCCL versions, each rank's outcome) and merges
it into PATH (default build/probe_nccl.json).  Raises where no card is
visible.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 2
TIMEOUT_S = 120.0


def _rank_main():
    """One rank: join NCCL on card 0, all_reduce, ring send/recv."""
    import datetime

    import torch
    import torch.distributed as tdist

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    out = {"rank": rank}
    try:
        torch.cuda.set_device(0)
        tdist.init_process_group(
            "nccl", init_method=f"tcp://127.0.0.1:{os.environ['MASTER_PORT']}",
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=60))
        x = torch.full((4,), float(rank + 1), device="cuda")
        tdist.all_reduce(x)
        out["all_reduce"] = x.tolist()
        y = torch.empty(4, device="cuda")
        ops = [tdist.P2POp(tdist.isend, x * (rank + 1), (rank + 1) % world),
               tdist.P2POp(tdist.irecv, y, (rank - 1) % world)]
        for req in tdist.batch_isend_irecv(ops):
            req.wait()
        torch.cuda.synchronize()
        out["recv"] = y.tolist()
        out["outcome"] = "ok"
        tdist.destroy_process_group()
    except Exception as e:  # noqa: BLE001 — the error is the finding
        out["outcome"] = "error"
        out["error"] = f"{type(e).__name__}: {e}"[:2000]
    print(json.dumps(out), flush=True)


def probe() -> dict:
    import torch

    from cuda_iblb_11_tpu_torch.ops.probes import run_header

    if not torch.cuda.is_available():
        raise RuntimeError("probe_nccl needs a CUDA device")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE=str(RANKS),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "cuda_iblb_11_tpu_torch.probe_nccl",
         "--rank-main"], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)
        for r in range(RANKS)]
    results = []
    for r, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=max(
                1.0, TIMEOUT_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
            results.append({"rank": r, "outcome": "hung",
                            "stderr_tail": err[-1500:]})
            continue
        lines = [ln for ln in out.splitlines() if ln.startswith("{")]
        # a rank that reported keeps its own words; one that did not, the
        # end of what it wrote to stderr
        res = json.loads(lines[-1]) if lines else {
            "rank": r, "outcome": f"exited {p.returncode}",
            "stderr_tail": err[-1500:]}
        res["returncode"] = p.returncode
        results.append(res)
    nccl = ".".join(map(str, torch.cuda.nccl.version()))
    return {**run_header("cuda"), "nccl": nccl,
            "ranks_on_card_0": RANKS, "results": results,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=os.path.join(REPO, "build",
                                                    "probe_nccl.json"))
    ap.add_argument("--rank-main", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_main:
        _rank_main()
        return 0
    from cuda_iblb_11_tpu_torch.ops.probes import write_record

    rec = probe()
    write_record(args.json, "nccl_ranks_on_one_card", rec)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
