"""Host time per step in the cilia kinematics: the spans iblb.kinematics
and iblb.band_points of the device profile's intervals
(program_spans.py), in us per step of those intervals."""

from iblb_benchmark import program_spans

program_spans.begin()


def read(w):
    return program_spans.us_per_step(
        w, ("iblb.kinematics", "iblb.band_points"))
