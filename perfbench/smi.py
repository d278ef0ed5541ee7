"""nvidia-smi's reading of the card beside the window: a frozen copy of
the sampling of rectified_spaattn_tpu_torch/kernels/int8_probe.py:119-124
(``_card_clocks``), with the power limit and temperature added."""

from __future__ import annotations

import subprocess

QUERY = "name,clocks.sm,power.draw,power.limit,temperature.gpu"


def reading() -> str:
    """One line per card: name, SM clock, power draw, power limit,
    temperature; "not read" where nvidia-smi gives nothing."""
    try:
        proc = subprocess.run(["nvidia-smi", f"--query-gpu={QUERY}",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return "; ".join(proc.stdout.strip().splitlines()) or "not read"
