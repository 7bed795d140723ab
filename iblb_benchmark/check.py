"""The comparison that decides ``correct``.

An interval the program ran is followed again by the plain reference
(reference/lbm.py) in float64 from the same state, and two numbers are
taken at its end:

    u_rel   || u_program - u_reference || / || u_reference ||, u the
            half-force-corrected velocity of the whole grid
    q_rel   | dq_program - dq_reference | / sum |flux samples|, dq the
            interval's flux (the cumulative flux's change); the sum of the
            reference's per-step samples' magnitudes is the scale, since an
            interval's net flux can pass through zero over the beat

A run checks two intervals: the first, from the state the benchmark made
(the warm-up), and the window's last, from the program's own state; each
number is the worse of the two.  The cell's file gives the limit of each
number it compares: a number whose control reading does not stand clear
of the program's (PERF.md gives both) is printed, not compared.
"""

from __future__ import annotations

import math

import torch

from iblb_benchmark.reference.lbm import W, Reference, velocity

NUMBERS = ("u_rel", "q_rel")


def raw64(f, storage: str):
    """The program's f as raw float64 distributions."""
    f = f.to(torch.float64)
    if storage == "deviatoric":
        f = f + torch.tensor(W, dtype=torch.float64,
                             device=f.device)[:, None, None]
    return f


def full_force(force, ydim: int):
    """The program's force band as a float64 force on the whole grid."""
    force = force.to(torch.float64)
    pad = force.new_zeros((2, ydim - force.shape[1], force.shape[2]))
    return torch.cat([force, pad], dim=1)


def interval_numbers(ref: Reference, before, after, storage: str) -> dict:
    """u_rel and q_rel of the steps from state ``before`` to ``after``
    (each a FlowState of the program), with the program's flux at the end,
    its change over the steps and the reference's scale of it."""
    ydim = ref.p.ydim
    n = after.it - before.it
    if n <= 0:
        return {k: math.inf for k in NUMBERS}
    f, force, samples = ref.run(raw64(before.f, storage),
                                full_force(before.force, ydim), before.it, n)
    u_ref = velocity(f, force)
    del f, force
    u_prog = velocity(raw64(after.f, storage), full_force(after.force, ydim))
    u_rel = float(torch.linalg.vector_norm(u_prog - u_ref)
                  / torch.linalg.vector_norm(u_ref))
    dq_prog = float(after.q.to(torch.float64)) \
        - float(before.q.to(torch.float64))
    scale = float(samples.abs().sum())
    q_rel = abs(dq_prog - float(samples.sum())) / scale
    return {"u_rel": u_rel, "q_rel": q_rel, "q": float(after.q),
            "dq": dq_prog, "dq_scale": scale}


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers the cell's
    limits name: each at or under its limit; a number that is not finite
    fails."""
    out, ok = {}, True
    for name in (n for n in NUMBERS if n in limits):
        v, lim = values[name], limits[name]
        passed = math.isfinite(v) and v <= lim
        ok = ok and passed
        out[name] = {"value": v if math.isfinite(v) else str(v),
                     "limit": lim}
    return ok, out
