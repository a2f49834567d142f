"""Span tracer: nested context-manager spans + Chrome-trace export
(DESIGN.md 1j).

``span("plan")`` / ``span("execute", executor="fused")`` wrap the phases of
a request — plan -> compile -> gather/kernel -> assemble — with parent
nesting tracked per thread, so a ``PairwiseService.similarity`` call
produces a small tree: the request span at the root, the planner and
executor phases under it, jit-cache compiles under those.  Completed spans
land in a bounded ring buffer (serving loops never grow memory);
``chrome_trace()`` renders them in the Chrome trace-event format, so
``export_chrome_trace("trace.json")`` loads directly in ``chrome://tracing``
or https://ui.perfetto.dev.

This is the port's copy of ``repro.obs.trace`` without the profiler
annotation hook: spans stay host-side (stdlib only).

Overhead: a span is two ``perf_counter`` calls, a dataclass, and a deque
append; disabled (``repro_torch.obs.configure(enabled=False)``) it is a single
flag test yielding a shared no-op.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Optional

from . import _config

__all__ = ["Span", "Tracer", "TRACER", "span"]


@dataclasses.dataclass
class Span:
    """One completed (or in-flight) span; times from ``perf_counter``."""

    name: str
    span_id: int
    parent_id: Optional[int]
    tid: int
    start: float                 # perf_counter seconds
    duration: float = 0.0        # seconds; 0 while in flight
    attrs: dict = dataclasses.field(default_factory=dict)


class Tracer:
    """Ring-buffered span collector with per-thread parent nesting."""

    def __init__(self, capacity: int = 4096):
        self._spans: deque = deque(maxlen=capacity)
        self._ids = itertools.count(1)
        self._local = threading.local()

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @contextmanager
    def span(self, name: str, **attrs):
        """Context manager: time a phase, nest under the thread's current
        span, record into the ring.  Yields the live :class:`Span` (attach
        late attributes via ``s.attrs[...] = ...``); yields None when
        observability is disabled."""
        if not _config.ENABLED:
            yield None
            return
        stack = self._stack()
        s = Span(name=str(name), span_id=next(self._ids),
                 parent_id=stack[-1].span_id if stack else None,
                 tid=threading.get_ident(), start=time.perf_counter(),
                 attrs=dict(attrs))
        stack.append(s)
        try:
            yield s
        finally:
            s.duration = time.perf_counter() - s.start
            stack.pop()
            self._spans.append(s)

    # ------------------------------------------------------------- queries
    def spans(self) -> list:
        """Snapshot of the completed-span ring (oldest first)."""
        return list(self._spans)

    def clear(self) -> None:
        self._spans.clear()

    def chrome_trace(self) -> dict:
        """The ring as a Chrome trace-event JSON object (``ph: "X"``
        complete events, microsecond timestamps) — loadable in
        ``chrome://tracing`` / Perfetto."""
        pid = os.getpid()
        events = []
        for s in self._spans:
            args = {k: _jsonable(v) for k, v in s.attrs.items()}
            if s.parent_id is not None:
                args["parent"] = s.parent_id
            args["span_id"] = s.span_id
            events.append({
                "name": s.name, "cat": "repro", "ph": "X",
                "ts": s.start * 1e6, "dur": s.duration * 1e6,
                "pid": pid, "tid": s.tid, "args": args,
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str) -> str:
        """Write :meth:`chrome_trace` to ``path``; returns the path."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


#: process-global tracer; ``span(...)`` below is its bound method.
TRACER = Tracer()
span = TRACER.span
