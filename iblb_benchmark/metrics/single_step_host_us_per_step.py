"""Host time per step in the single-step remainder: iblb.steps_single less
its iblb.kinematics, over the device profile's intervals
(program_spans.py), in us per step of those intervals."""

from iblb_benchmark import program_spans

program_spans.begin()


def read(w):
    return program_spans.us_per_step(w, ("iblb.steps_single",),
                                     minus=("iblb.kinematics",))
