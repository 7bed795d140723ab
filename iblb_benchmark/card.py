"""Where a run ran: the card's name and power limit (``nvidia-smi``), as
``cuda_iblb_11_tpu_torch/ops/probes.card_line`` reads them."""

from __future__ import annotations

import subprocess


def card_line() -> str | None:
    """``name, power.limit`` of the first card, or None where nvidia-smi
    gives nothing."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else None
