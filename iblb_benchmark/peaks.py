"""The table of peaks: a card's published rates, by the name
``torch.cuda.get_device_name()`` gives.  A card not in the table has no
roofline here, and the roofline metrics are left out of its runs."""

from __future__ import annotations

# NVIDIA H100 SXM data sheet (dense, at the 700 W limit): HBM bytes/s, and
# operations/s outside the tensor cores by compute dtype.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_s": 3.35e12,
        "flop_s": {"float32": 67e12, "float64": 34e12},
    },
}

# the compute dtype of each storage dtype of f (bf16 storage computes in
# float32)
COMPUTE = {"bfloat16": "float32", "float32": "float32", "float64": "float64"}


def peaks_of(kind: str) -> dict | None:
    return PEAKS.get(kind)


def bound_seconds(peaks: dict, nbytes: float, nflop: float,
                  dtype: str) -> float:
    """The least time the card could take: the larger of the bytes over
    its memory rate and the operations over its rate in the compute
    dtype."""
    return max(nbytes / peaks["hbm_bytes_s"],
               nflop / peaks["flop_s"][COMPUTE[dtype]])
