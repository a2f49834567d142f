"""Reading the profiler's trace of a traced block of requests.

``torch.profiler`` records the device's operations (kernels, copies,
memsets) beside the host's operations on one clock.  From them:

* ``busy_s``: the time in which some device operation ran (the union of
  their intervals; annotations laid on the device's timeline, such as the
  profiler's steps, are not operations);
* ``device_s``: each device operation's total time, by name;
* ``idle_s``: each gap between device operations, named by the innermost
  host operation running at its middle (``host`` where none is), summed
  by name: what the host was doing while the device waited.
"""

from __future__ import annotations

import re

import numpy as np

__all__ = ["read_events", "top"]

_STEP = re.compile(r"^ProfilerStep#?\d*\*?$")
NAME_WIDTH = 160


def _span(e) -> tuple:
    return e.time_range.start * 1e-6, e.time_range.end * 1e-6


def read_events(events) -> dict:
    """``{"busy_s", "device_s", "idle_s"}`` of a profiler's events."""
    from torch.autograd import DeviceType
    # annotations (the profiler's steps, a collective's record_function)
    # are laid on the device's timeline too: they are not operations
    dev = sorted((_span(e) + (e.name,) for e in events
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)
                  and not _STEP.match(e.name)), key=lambda t: t[0])
    host = [(_span(e), e.name) for e in events
            if e.device_type == DeviceType.CPU and not _STEP.match(e.name)]
    device_s: dict = {}
    for a, b, name in dev:
        device_s[name] = device_s.get(name, 0.0) + (b - a)
    busy = 0.0
    gaps = []
    end = None
    for a, b, _name in dev:
        if end is None or a > end:
            if end is not None:
                gaps.append((end, a))
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    idle_s: dict = {}
    if gaps and host:
        hs = np.array([s for (s, _e), _n in host])
        he = np.array([e for (_s, e), _n in host])
        names = [n for _t, n in host]
        for a, b in gaps:
            mid = 0.5 * (a + b)
            inside = np.flatnonzero((hs <= mid) & (he >= mid))
            name = (names[inside[np.argmin(he[inside] - hs[inside])]]
                    if inside.size else "host")
            idle_s[name] = idle_s.get(name, 0.0) + (b - a)
    elif gaps:
        idle_s["host"] = sum(b - a for a, b in gaps)
    return {"busy_s": busy, "device_s": device_s, "idle_s": idle_s}


def top(by_name: dict, n: int = 10) -> list:
    """The ``n`` largest ``[name, seconds]`` pairs, names cut to
    ``NAME_WIDTH`` characters (a kernel's template name runs to
    hundreds)."""
    items = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:NAME_WIDTH], float(s)] for name, s in items]
