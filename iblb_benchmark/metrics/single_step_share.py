"""The share of the device profile's steps run single-step: the steps of
iblb.steps_single over those of iblb.run_chunk (program_spans.py)."""

from iblb_benchmark import program_spans

program_spans.begin()


def read(w):
    return program_spans.step_share(w, "iblb.steps_single")
