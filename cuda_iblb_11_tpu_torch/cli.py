"""Command-line interface of the torch port.

Positional arguments exactly as the reference binary (main.cu:284-296):

    c_fraction c_num c_space Re T_num T_pow I_pow P_num ShARC BigData

plus the JAX CLI's flags where this slice supports them, and --device.
``python -m cuda_iblb_11_tpu_torch.cli 1 6 48 1.0 1.0 5 0.02 4 0 0
--output X`` writes the same files as ``python -m cuda_iblb_11_tpu.cli``.
"""

from __future__ import annotations

import argparse
import sys

from cuda_iblb_11_tpu_torch.core.config import SimConfig
from cuda_iblb_11_tpu_torch.runner import run


def _temporal_arg(v: str):
    if v == "auto":
        return v
    try:
        return int(v)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--temporal takes an integer K or 'auto', got {v!r}") from None


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="iblb-torch",
        description="Immersed-boundary lattice-Boltzmann (mucociliary "
                    "pumping) simulator, PyTorch/CUDA port")
    p.add_argument("positionals", nargs="*", metavar="ARG",
                   help="c_fraction c_num c_space Re T_num T_pow I_pow "
                        "P_num ShARC BigData")
    p.add_argument("--output", default="Data/Test",
                   help="output root directory (default: Data/Test)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run; 'cuda' raises when no GPU is visible "
                        "(the run never moves to the CPU unasked)")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "cuda", "torch"],
                   help="'cuda': the hand-written kernels; 'torch': their "
                        "plain PyTorch versions; 'auto': cuda on a CUDA "
                        "device, torch on the CPU")
    p.add_argument("--forcing", default="trt_split",
                   choices=["trt_split", "reference"],
                   help="Guo forcing scheme; 'reference' replicates the CUDA "
                        "exactly but is IB-unstable at default parameters")
    p.add_argument("--dtype", default=None,
                   choices=["float32", "float64", "bfloat16"],
                   help="state precision (float64 runs the kernel in native "
                        "f64; bfloat16 stores f in bf16 and computes in "
                        "f32, deviatoric storage only)")
    p.add_argument("--temporal", type=_temporal_arg, default="auto",
                   metavar="K",
                   help="K-step temporal blocking: K > 1 advances the "
                        "force-free bulk K steps per pass; 'auto' (default) "
                        "picks the largest eligible K of 16, 8, 4, 2 on the "
                        "cuda backend (1 elsewhere) and records why in "
                        "SimLog")
    p.add_argument("--pattern", default="no_mucus",
                   choices=["no_mucus", "mucus"],
                   help="cilia beat pattern (main.cu:56-74 / :36-54)")
    p.add_argument("--ib-x-edge", default="periodic",
                   choices=["periodic", "reference"],
                   help="IB stencil at the periodic x edges; 'reference' "
                        "is the strict-parity quirk mode (the stencil IB "
                        "of the reference's unwrapped indexing)")
    p.add_argument("--mesh", default=None, metavar="Y,X",
                   help="shard the grid over a Y,X mesh spread over the "
                        "visible devices of --device (shards share a card "
                        "when there are fewer cards than shards); 'auto' "
                        "picks a factorization of the visible cards "
                        "(unsharded on one)")
    p.add_argument("--resume", default=None, help="checkpoint .npz to resume "
                   "(written by either package)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="write a checkpoint every N iterations")
    p.add_argument("--checkpoint-format", default="npz",
                   choices=["npz", "orbax"],
                   help="npz (orbax is not yet ported)")
    p.add_argument("--ydim", type=int, default=None,
                   help="override the channel height (default 192)")
    p.add_argument("--snapshot-format", default="dat",
                   choices=["dat", "npz"],
                   help="BigData snapshots: reference text or binary npz")
    p.add_argument("--overlap", default="auto",
                   choices=["auto", "on", "off"],
                   help="write interval snapshots on a worker thread under "
                        "the next chunk ('on') or inline ('off'); 'auto' is "
                        "on except text snapshots on <=2-core hosts")
    p.add_argument("--no-overlap", dest="overlap", action="store_const",
                   const="off", help="alias for --overlap off")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--profile-dir", default=None,
                   help="capture a torch.profiler trace of the first "
                        "interval (a Chrome trace, trace.json, in the "
                        "directory)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        cfg = SimConfig.from_argv(args.positionals)
    except (SystemExit, ValueError) as e:
        print(e, file=sys.stderr)
        return 1
    if args.dtype:
        cfg = cfg.replace(dtype=args.dtype)
    if args.ydim is not None:
        cfg = cfg.replace(ydim=args.ydim)
    try:
        run(cfg, output_root=args.output, backend=args.backend,
            forcing=args.forcing, resume_from=args.resume,
            checkpoint_every=args.checkpoint_every, quiet=args.quiet,
            profile_dir=args.profile_dir, temporal=args.temporal,
            mesh=args.mesh, ib_x_edge=args.ib_x_edge,
            checkpoint_format=args.checkpoint_format, pattern=args.pattern,
            snapshot_format=args.snapshot_format, overlap=args.overlap,
            device=args.device)
    except NotImplementedError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
