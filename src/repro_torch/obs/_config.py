"""Global observability switch (module-level so every hot-path check is a
single attribute read — see the overhead budget in DESIGN.md 1j).

``REPRO_OBS`` in the environment sets the initial state: "0" / "false" /
"off" / "no" disables every publish site; "device" also turns on device
timing, so that spans opened on a CUDA device record CUDA events without a
profiler (``repro_torch.obs.trace``); anything else (the default, "1")
enables the host-side instruments.  ``repro_torch.obs.configure(enabled=...,
device=...)`` flips both at runtime, for instance to measure the cost of
the instruments on and off around one workload.
"""

from __future__ import annotations

import os

_MODE = os.environ.get("REPRO_OBS", "1").lower()
ENABLED: bool = _MODE not in ("0", "false", "off", "no")
DEVICE: bool = _MODE == "device"


def set_enabled(enabled: bool) -> bool:
    global ENABLED
    ENABLED = bool(enabled)
    return ENABLED


def set_device(device: bool) -> bool:
    global DEVICE
    DEVICE = bool(device)
    return DEVICE
