"""What a run starts from, made from its seed.

The seed picks the beat phase: the first step is a whole number of output
intervals into the beat, it0 = interval x (seed mod intervals a beat), so
every seed runs the same intervals of the same length, each cut at the
boundaries the runner writes its flux rows on.  The flow starts at rest
(rho 1, u 0, no force) at that phase: the harness makes it in the
program's storage (harness.start_state), the reference reads it back.
"""

def first_step(seed: int, p) -> int:
    """The iteration a run with ``seed`` starts at."""
    return p.interval * (int(seed) % (p.iterations // p.interval))
