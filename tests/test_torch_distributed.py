"""The mesh across processes (--distributed) on the CPU: gloo ranks
spawned from this file (``python tests/test_torch_distributed.py --worker
CASES DIR`` under torchrun's environment, MASTER_ADDR 127.0.0.1, a free
port, one thread each) against the port's one-process mesh, bit for bit,
and in f64 against the JAX package's jnp oracle at the tolerances of
tests/test_torch_sharded.py (f rtol 1e-13 / atol 1e-15, force rtol 1e-10,
q rtol 1e-12).

Two ranks run, in one spawn, every mesh leg:
  ShardedPallasSim on (2, 2) (rank 0 holds the top row of shards and both
  x-columns, rank 1 the bottom row); ShardedTemporalSim K = 2 on (2, 1)
  (band_super_whole), on (1, 2) (band_super_xsharded: each rank one
  x-column) and on (2, 2) with the quirk IB (per_substep_tiled), f64; the
  x-sharded leg on (2, 2) in bf16; a directory checkpoint written by both
  ranks after 4 steps and resumed by both.
Four ranks run the x-sharded leg on (2, 2) in f64 (one shard each: ranks
2 and 3 hold no x-column).  Odd step counts end in a per-step remainder.
Every rank's cilia kinematics are bit-equal (each rank computes its own).
The CLI under two ranks writes the one-process run's Flux bytes and final
npz state, only rank 0 writes, and its directory checkpoint resumes under
two ranks to the uninterrupted run's Flux bytes.

A spawned rank that fails ends its peers at once, and every rank's
collectives time out (120 s) where a peer is lost.
"""

import functools
import hashlib
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from cuda_iblb_11_tpu_torch import SimConfig  # noqa: E402
from cuda_iblb_11_tpu_torch.io import checkpoint as ckpt  # noqa: E402
from cuda_iblb_11_tpu_torch.parallel import (  # noqa: E402
    ShardedPallasSim, ShardedTemporalSim, make_mesh,
)

import _torch_threads  # noqa: E402,F401  (one torch thread per xdist worker)

F64 = dict(dtype="float64", storage="raw")
BF16 = dict(dtype="bfloat16", storage="deviatoric")
CFG2 = dict(c_num=3, c_space=128, ydim=288)     # 384 columns
WIDE = dict(c_num=16, c_space=128, ydim=192)    # 2,048 columns: B8

# name: (config, precision, mesh, K, steps, ib_x_edge, band leg)
CASES = {
    "per_step_2x2": (CFG2, F64, (2, 2), 1, 5, "periodic",
                     "sharded_per_step"),
    "whole_2x1": (CFG2, F64, (2, 1), 2, 7, "periodic", "band_super_whole"),
    "xsharded_1x2": (WIDE, F64, (1, 2), 2, 3, "periodic",
                     "band_super_xsharded"),
    "quirk_tiled_2x2": (CFG2, F64, (2, 2), 2, 5, "reference",
                        "per_substep_tiled"),
    "bf16_xsharded_2x2": (WIDE, BF16, (2, 2), 2, 3, "periodic",
                          "band_super_xsharded"),
    "xsharded_2x2": (WIDE, F64, (2, 2), 2, 3, "periodic",
                     "band_super_xsharded"),
}
TWO = ("per_step_2x2", "whole_2x1", "xsharded_1x2", "quirk_tiled_2x2",
       "bf16_xsharded_2x2")
FOUR = ("xsharded_2x2",)
CKPT = "whole_2x1"          # the case the directory checkpoint rides on
CKPT_AT = 4

ARGS = ["1", "4", "48", "1.0", "1.0", "5", "0.0005", "2", "0", "0"]
HALF = ARGS[:6] + ["0.00025", "1"] + ARGS[8:]   # 25 steps, one interval
CLI = ["--device", "cpu", "--quiet", "--mesh", "2,1", "--temporal", "4"]
FLUX = "Flux/1_4_48_1_1x5-flux.dat"
RAW = "Raw/4/1"


def _sim(name, comm=None):
    kw, prec, mesh, K, _, ib_x_edge, leg = CASES[name]
    cfg = SimConfig(**kw, **prec)
    m = make_mesh(*mesh, devices=["cpu"], comm=comm)
    sim = (ShardedPallasSim(cfg, m, ib_x_edge=ib_x_edge) if K == 1 else
           ShardedTemporalSim(cfg, m, temporal=K, ib_x_edge=ib_x_edge))
    assert sim.resolved_config()["band_leg"] == leg
    return cfg, sim


def _kinematics_hash(sim, n):
    h = hashlib.sha256()
    for t in sim.step_kinematics(0, n):
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


# --- the spawned ranks -----------------------------------------------------

def _worker_sims(comm, names, out):
    for name in names:
        cfg, sim = _sim(name, comm)
        n = CASES[name][4]
        st = sim.run_chunk(sim.init_state(), n)
        whole = sim.gather_state(st)
        info = {"kinematics": _kinematics_hash(sim, n),
                "own": [k for k in range(len(sim.shards))
                        if sim.mesh.mine(k)],
                "distributed": sim.resolved_config()["distributed"]}
        if name == CKPT:
            # 4 steps, the directory checkpoint, its restore, 4 more
            path = os.path.join(out, "ckpt_dir")
            a = sim.run_chunk(sim.init_state(), CKPT_AT)
            ckpt.save_dir(path, a, cfg, sim)
            r, _ = ckpt.load_dir(path, cfg, sim=sim)
            resumed = sim.gather_state(sim.run_chunk(r, n - CKPT_AT))
            saved = sim.gather_state(a)
            if comm.rank == 0:
                ckpt.save(os.path.join(out, "resumed.npz"), resumed, cfg)
                ckpt.save(os.path.join(out, "saved.npz"), saved, cfg)
        if comm.rank == 0:
            ckpt.save(os.path.join(out, f"{name}.npz"), whole, cfg)
        else:
            assert whole is None
        with open(os.path.join(out, f"{name}.rank{comm.rank}.json"),
                  "w") as fh:
            json.dump(info, fh)


def _worker_cli(comm, out):
    from cuda_iblb_11_tpu_torch.cli import main

    # (a) each rank its own output root: rank 0's must hold every file,
    # rank 1's none
    a = os.path.join(out, f"a{comm.rank}")
    assert main(ARGS + CLI + ["--distributed", "--output", a,
                              "--checkpoint-every", "50"]) == 0
    # (b) a shared root: half the run with a directory checkpoint, then
    # the whole run resumed from it
    b = os.path.join(out, "b")
    assert main(HALF + CLI + ["--distributed", "--output", b,
                              "--checkpoint-every", "25",
                              "--checkpoint-format", "orbax"]) == 0
    assert main(ARGS + CLI + ["--distributed", "--output", b, "--resume",
                              os.path.join(b, RAW, "checkpoint_orbax")]) == 0


# the card's case (tests/test_torch_cuda.py): a mesh at this size, f32
CARD = dict(c_num=6, c_space=48, ydim=256)
CARD_RUNS = {"per_step_2x2": ((2, 2), 1, 3), "temporal_2x1": ((2, 1), 4, 10)}


def card_values(world):
    """Seeded values of every dtype the transport carries, two slots a
    rank, made alike on every rank: (value, owner rank) of each slot."""
    g = torch.Generator().manual_seed(7)
    n = 2 * world
    shapes = [(9, 5, 7), (), (3, 4), (2, 1, 6)] * world
    dtypes = [torch.float32, torch.float64, torch.bfloat16, torch.float32]
    vals = [torch.randn(shapes[k], generator=g,
                        dtype=torch.float64).to(dtypes[k % 4])
            for k in range(n)]
    return [(v, k * world // n) for k, v in enumerate(vals)]


def card_mesh(comm, name, device="cuda"):
    from cuda_iblb_11_tpu_torch.parallel import make_mesh as mk

    mesh, K, _ = CARD_RUNS[name]
    cfg = SimConfig(**CARD, dtype="float32")
    m = mk(*mesh, devices=[device], comm=comm)
    return cfg, (ShardedPallasSim(cfg, m) if K == 1
                 else ShardedTemporalSim(cfg, m, temporal=K))


def _worker_card(comm, out):
    """On the card: every slot's value moved one slot on (a ring shift,
    across ranks and within one), and the ordered sum of the float32
    values, against the same on one rank's copies; then each CARD_RUNS
    mesh, its gathered state saved by rank 0."""
    parts = card_values(comm.world)
    n = len(parts)
    dev = comm.device
    got = comm.move("ring", [(v.to(dev) if src == comm.rank else None, src,
                              parts[(k + 1) % n][1], dev)
                             for k, (v, src) in enumerate(parts)], {})
    for k, (v, _) in enumerate(parts):
        if parts[(k + 1) % n][1] == comm.rank:
            assert got[k].device == dev and got[k].dtype == v.dtype
            assert torch.equal(got[k].cpu(), v), k
    f32 = [(v.to(dev) if src == comm.rank else None, src)
           for v, src in parts if v.dtype == torch.float32
           and v.shape == (9, 5, 7)]
    total = comm.all_sum_ordered("sum", f32, {})
    want = [v.to(dev) for v, src in parts if v.dtype == torch.float32
            and v.shape == (9, 5, 7)]
    local = want[0]
    for v in want[1:]:
        local = local + v
    assert torch.equal(total, local)
    for name in CARD_RUNS:
        cfg, sim = card_mesh(comm, name)
        whole = sim.gather_state(sim.run_chunk(sim.init_state(),
                                               CARD_RUNS[name][2]))
        if comm.rank == 0:
            ckpt.save(os.path.join(out, f"card_{name}.npz"), whole, cfg)
    launches = _card_cli(comm, out)
    with open(os.path.join(out, f"card.rank{comm.rank}.json"), "w") as fh:
        json.dump({"transport": comm.name, "device": str(dev),
                   "launches": launches}, fh)


# the CLI on the card under the ranks: 2048^2 with 16 cilia, 256 steps in
# intervals of 128, on each leg of the mesh and in bf16; the quirk at the
# reference channel, 192 steps.  Each run writes its final state as an npz
# checkpoint.  name: (argv, band leg)
CARD_ARGV = ["1", "16", "128", "1.0", "1.0", "5", "0.00256", "2", "0", "0",
             "--ydim", "2048"]
CARD_HALF = CARD_ARGV[:6] + ["0.00128", "1"] + CARD_ARGV[8:]   # 128 steps
CARD_CLI = {
    "f32_auto_2x2": (CARD_ARGV + ["--mesh", "2,2", "--checkpoint-every",
                                  "256"], "band_super_xsharded"),
    "f32_auto_2x1": (CARD_ARGV + ["--mesh", "2,1", "--checkpoint-every",
                                  "256"], "band_super_whole"),
    "f32_temporal_1_2x2": (CARD_ARGV + ["--mesh", "2,2", "--temporal", "1",
                                        "--checkpoint-every", "256"],
                           "sharded_per_step"),
    "bf16_auto_2x2": (CARD_ARGV + ["--mesh", "2,2", "--dtype", "bfloat16",
                                   "--checkpoint-every", "256"],
                      "band_super_xsharded"),
    "quirk_auto_2x1": (["1", "6", "48", "1.0", "1.0", "5", "0.00192", "2",
                        "0", "0", "--mesh", "2,1", "--ib-x-edge", "reference",
                        "--checkpoint-every", "192"], "per_substep_tiled"),
}


def card_cli(world):
    """The CARD_CLI runs of `world` ranks: every run on two, one on one."""
    return list(CARD_CLI) if world > 1 else ["f32_auto_2x2"]


def _card_cli(comm, out):
    """This rank's CARD_CLI runs with --distributed, each into
    out/cli_<name>, and on two ranks the directory checkpoint written half
    way and resumed, into out/cli_ckpt; returns this rank's launches by
    run and kernel ID."""
    from test_torch_cuda import counted_with_masks

    from cuda_iblb_11_tpu_torch.cli import main

    launches = {}
    for name in card_cli(comm.world):
        rc, launches[name] = counted_with_masks(main, CARD_CLI[name][0] + [
            "--distributed", "--quiet", "--output",
            os.path.join(out, f"cli_{name}")])
        assert rc == 0, name
    if comm.world > 1:
        ck = os.path.join(out, "cli_ckpt")
        assert main(CARD_HALF + [
            "--mesh", "2,2", "--distributed", "--quiet", "--output", ck,
            "--checkpoint-every", "128", "--checkpoint-format", "orbax"]) == 0
        assert main(CARD_ARGV + [
            "--mesh", "2,2", "--distributed", "--quiet", "--output", ck,
            "--resume", os.path.join(ck, "Raw", "16", "1",
                                     "checkpoint_orbax"),
            "--checkpoint-every", "128"]) == 0
    return launches


def _worker(cases, out):
    torch.set_num_threads(1)
    from cuda_iblb_11_tpu_torch.parallel import dist

    comm = dist.init_from_env("cuda" if cases == "card" else "cpu")
    if cases == "cli":
        _worker_cli(comm, out)
    elif cases == "card":
        _worker_card(comm, out)
    else:
        _worker_sims(comm, cases.split(","), out)
    dist.shutdown()


# --- the parent ------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(world, cases, out):
    """Start `world` ranks of this file's worker on `cases`."""
    os.makedirs(out, exist_ok=True)
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(world),
               OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    procs = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 cases, out], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                stdout=log, stderr=subprocess.STDOUT, cwd=REPO))
    return out, procs


def _stop(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait(timeout=30)


def _wait(job, timeout=300):
    """The job's output directory once every rank exited 0; a rank that
    fails (or the time limit) ends the others and fails the test."""
    out, procs = job
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        _stop(procs)
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(out, f"rank{r}.log")) as fh:
                tail = fh.read()[-4000:]
            pytest.fail(f"rank {r} of {len(procs)} exited {p.returncode}:"
                        f"\n{tail}")
    return out


class _one_thread:
    """torch on one thread, as every spawned rank runs: the CPU matmuls
    split their sums by the thread count, so a comparison bit for bit
    holds the thread count equal."""

    def __enter__(self):
        self.n = torch.get_num_threads()
        torch.set_num_threads(1)

    def __exit__(self, *exc):
        torch.set_num_threads(self.n)


@functools.lru_cache(maxsize=None)
def _single(name):
    """The port's one-process mesh run of a case."""
    _, sim = _sim(name)
    n = CASES[name][4]
    with _one_thread():
        st = sim.gather_state(sim.run_chunk(sim.init_state(), n))
    return st, _kinematics_hash(sim, n)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Every spawn at once (two ranks on TWO, four on FOUR, two on the
    CLI), and the one-process runs they are held to while they run."""
    base = str(tmp_path_factory.mktemp("dist"))
    started = {"two": _start(2, ",".join(TWO), os.path.join(base, "two")),
               "four": _start(4, ",".join(FOUR), os.path.join(base, "four")),
               "cli": _start(2, "cli", os.path.join(base, "cli"))}
    try:
        for name in TWO + FOUR:
            _single(name)
        from cuda_iblb_11_tpu_torch.cli import main

        with _one_thread():
            assert main(ARGS + CLI + ["--output", os.path.join(base, "one"),
                                      "--checkpoint-every", "50"]) == 0
        yield started, os.path.join(base, "one")
    finally:
        for _, procs in started.values():
            _stop(procs)


@pytest.fixture(scope="module")
def two(jobs):
    return _wait(jobs[0]["two"])


@pytest.fixture(scope="module")
def four(jobs):
    return _wait(jobs[0]["four"])


@pytest.fixture(scope="module")
def cli_runs(jobs):
    return _wait(jobs[0]["cli"]), jobs[1]


@functools.lru_cache(maxsize=None)
def _oracle(name):
    from cuda_iblb_11_tpu.core.config import SimConfig as JaxConfig
    from cuda_iblb_11_tpu.models.mucociliary import MucociliarySim as JaxSim

    kw, prec, _, _, n, ib_x_edge, _ = CASES[name]
    sim = JaxSim(JaxConfig(**kw, **prec), backend="jnp", ib_x_edge=ib_x_edge)
    st = sim.run_chunk(sim.init_state(), n)
    return np.asarray(st.f), np.asarray(st.force), float(st.q)


def _equal(a, b):
    assert a.it == b.it
    for name in ("f", "force", "lasts", "q"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and torch.equal(x, y), name


def _check(out, name, world):
    st, _ = ckpt.load(os.path.join(out, f"{name}.npz"))
    single, kin = _single(name)
    _equal(st, single)
    infos = []
    for r in range(world):
        with open(os.path.join(out, f"{name}.rank{r}.json")) as fh:
            infos.append(json.load(fh))
    assert [i["kinematics"] for i in infos] == [kin] * world
    n_y, n_x = CASES[name][2]
    assert [k for i in infos for k in i["own"]] == list(range(n_y * n_x))
    assert infos[0]["distributed"] == {"world": world, "rank": 0,
                                       "transport": "gloo"}
    if CASES[name][1] is F64:
        f, force, q = _oracle(name)
        np.testing.assert_allclose(st.f.numpy(), f, rtol=1e-13, atol=1e-15)
        np.testing.assert_allclose(
            st.force.numpy(), force[:, :st.force.shape[1]], rtol=1e-10,
            atol=1e-15 if "xsharded" in name else 1e-18)
        np.testing.assert_allclose(float(st.q), q, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("name", TWO)
def test_two_ranks_equal_one_process(two, name):
    _check(two, name, 2)


@pytest.mark.parametrize("name", FOUR)
def test_four_ranks_equal_one_process(four, name):
    _check(four, name, 4)


def test_two_rank_directory_checkpoint_resumes_bit_for_bit(two):
    resumed, _ = ckpt.load(os.path.join(two, "resumed.npz"))
    _equal(resumed, _single(CKPT)[0])
    # the directory both ranks wrote, read in one process: the saved state
    saved, _ = ckpt.load(os.path.join(two, "saved.npz"))
    path = os.path.join(two, "ckpt_dir")
    whole, _ = ckpt.load_dir(path)
    _equal(whole, saved)
    for mesh in ((1, 2), (2, 2)):
        cfg, _ = _sim(CKPT)
        sim = ShardedTemporalSim(cfg, make_mesh(*mesh, devices=["cpu"]),
                                 temporal=2)
        back, _ = ckpt.load_dir(path, cfg, sim=sim)
        _equal(sim.gather_state(back), saved)


def test_cli_two_ranks_write_the_one_process_files(cli_runs):
    out, one = cli_runs
    a0, a1 = os.path.join(out, "a0"), os.path.join(out, "a1")
    with open(os.path.join(one, FLUX), "rb") as fh:
        want = fh.read()
    with open(os.path.join(a0, FLUX), "rb") as fh:
        assert fh.read() == want
    assert not os.path.exists(a1)          # rank 1 wrote nothing
    got, _ = ckpt.load(os.path.join(a0, RAW, "checkpoint.npz"))
    ref, _ = ckpt.load(os.path.join(one, RAW, "checkpoint.npz"))
    _equal(got, ref)
    log = open(os.path.join(a0, RAW, "SimLog.txt")).read()
    assert "Mesh: 2,1 over 2 rank(s), gloo" in log
    assert "Distributed: 2 rank(s), transport gloo; rank 0 writes" in log
    assert "Kernel path: per_substep_tiled" in log
    # apart from the lines that name the ranks and the run's own clock
    # (the date first), the one-process SimLog
    skip = ("Mesh", "Distributed", "Completion", "Total runtime",
            "End-to-end")
    lines = [[ln for ln in open(os.path.join(d, RAW, "SimLog.txt"))
              if not ln.startswith(skip)][1:] for d in (a0, one)]
    assert lines[0] == lines[1]


def test_cli_two_ranks_resume_their_directory_checkpoint(cli_runs):
    out, one = cli_runs
    b = os.path.join(out, "b")
    with open(os.path.join(one, FLUX), "rb") as fh:
        want = fh.read()
    with open(os.path.join(b, FLUX), "rb") as fh:
        assert fh.read() == want
    assert sorted(os.listdir(os.path.join(b, RAW, "checkpoint_orbax"))) == [
        ".metadata", "__0_0.distcp", "__1_0.distcp", "iblb.json"]
    assert "Resumed from checkpoint at iteration 25" in open(
        os.path.join(b, RAW, "SimLog.txt")).read()


def test_transport_rule():
    from cuda_iblb_11_tpu_torch.parallel.dist import choose_transport

    assert choose_transport([("h", None)] * 2) == ("gloo", False)
    assert choose_transport([("h", 0), ("h", 1)]) == ("nccl", False)
    assert choose_transport([("h", 0), ("g", 0)]) == ("nccl", False)
    assert choose_transport([("h", 0), ("h", 0)]) == ("gloo", True)
    assert choose_transport([("h", 0), ("h", 1), ("h", 0)]) == ("gloo", True)
    assert choose_transport([("h", 0)]) == ("nccl", False)
    with pytest.raises(ValueError, match="mix the CPU and the card"):
        choose_transport([("h", 0), ("h", None)])


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2], sys.argv[3])
