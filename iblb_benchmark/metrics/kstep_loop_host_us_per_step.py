"""Host time per step in the K-step loop, its B4/B5 wrapper calls
included: iblb.steps_temporal less its iblb.kinematics and
iblb.band_points, over the device profile's intervals
(program_spans.py), in us per step of those intervals."""

from iblb_benchmark import program_spans

program_spans.begin()


def read(w):
    return program_spans.us_per_step(
        w, ("iblb.steps_temporal",),
        minus=("iblb.kinematics", "iblb.band_points"))
