"""Structured JSONL event log for plan-lifecycle events (DESIGN.md 1j).

The streaming planners, the caches, and the executors make consequential
decisions that used to happen silently: a gap-drift re-plan fires, a soft
repack migrates bins, a background re-plan swaps in, a jit/plan/block cache
evicts an entry, a fused dispatch falls back to the bucketed path, a comm
reconciliation drifts out of tolerance.  Each of those now emits one event:
a plain dict with ``seq`` (monotonic), ``ts`` (epoch seconds), ``kind``,
and the emitter's fields — held in a bounded ring and, when a sink is
configured (``configure_sink(path)`` or ``REPRO_OBS_EVENTS=path``),
appended to a JSONL file one object per line.

Events are facts, not metrics: the registry answers "how many / how fast",
the event log answers "what happened and why" (a reconciler anomaly event
carries the offending ratios; a drift-replan event carries the trigger
gaps).  ``launch/obs_report.py`` tails this ring.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Optional

from . import _config

__all__ = ["EventLog", "EVENTS", "emit"]


class EventLog:
    """Bounded in-memory event ring with an optional JSONL file sink."""

    def __init__(self, capacity: int = 4096,
                 sink: Optional[str] = None):
        self._ring: deque = deque(maxlen=capacity)
        self._seq = 0
        self._lock = threading.Lock()
        self._sink_path = sink or os.environ.get("REPRO_OBS_EVENTS") or None
        self._sink_file = None

    def configure_sink(self, path: Optional[str]) -> None:
        """Append future events to ``path`` as JSONL (None disables)."""
        with self._lock:
            if self._sink_file is not None:
                self._sink_file.close()
                self._sink_file = None
            self._sink_path = path

    def emit(self, kind: str, **fields) -> Optional[dict]:
        """Record one event; returns the event dict (None when obs is
        disabled).  Non-JSON field values are stringified at sink time,
        never dropped."""
        if not _config.ENABLED:
            return None
        with self._lock:
            self._seq += 1
            ev = {"seq": self._seq, "ts": time.time(), "kind": str(kind)}
            ev.update(fields)
            self._ring.append(ev)
            if self._sink_path is not None:
                if self._sink_file is None:
                    self._sink_file = open(self._sink_path, "a")
                self._sink_file.write(
                    json.dumps(ev, default=str, sort_keys=True) + "\n")
                self._sink_file.flush()
        return ev

    def events(self, kind: Optional[str] = None, last: int = 0) -> list:
        """Snapshot of the ring (oldest first); filter by ``kind`` and/or
        keep only the ``last`` N."""
        with self._lock:
            evs = list(self._ring)
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        return evs[-last:] if last else evs

    def counts(self) -> dict:
        """Event counts by kind (for report summaries)."""
        out: dict = {}
        for e in self.events():
            out[e["kind"]] = out.get(e["kind"], 0) + 1
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


#: process-global event log; ``emit(...)`` below is its bound method.
EVENTS = EventLog()
emit = EVENTS.emit
