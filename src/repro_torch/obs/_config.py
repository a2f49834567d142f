"""Global observability switch (module-level so every hot-path check is a
single attribute read — see the overhead budget in DESIGN.md 1j).

``REPRO_OBS`` in the environment ("0"/"false"/"off" disables) sets the
initial state; ``repro_torch.obs.configure(enabled=...)`` flips it at runtime —
what ``benchmarks/bench_obs.py`` uses to measure the obs-on vs obs-off
wall-clock overhead.
"""

from __future__ import annotations

import os

ENABLED: bool = os.environ.get("REPRO_OBS", "1").lower() not in (
    "0", "false", "off", "no")


def set_enabled(enabled: bool) -> bool:
    global ENABLED
    ENABLED = bool(enabled)
    return ENABLED
