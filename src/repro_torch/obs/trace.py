"""Span tracer: nested context-manager spans, per-name totals, the
profiler hook, device timing and Chrome-trace export (DESIGN.md 1j).

``span("plan")`` / ``span("execute", executor="fused")`` wrap the phases of
a request — plan -> compile -> gather/kernel -> assemble — with parent
nesting tracked per thread, so a ``PairwiseService.similarity`` call
produces a small tree: the request span at the root, the planner and
executor phases under it, jit-cache compiles under those.  Every span
carries the id of its root span (``root_id``: one id per request).
Completed spans land in a bounded ring buffer (serving loops never grow
memory); beside it the tracer keeps, per span name, the count, host seconds
and self host seconds (the duration less what child spans cover:
``totals()``), so what the ring has turned over is still counted.
``chrome_trace()`` renders the ring in the Chrome trace-event format, so
``export_chrome_trace("trace.json")`` loads directly in ``chrome://tracing``
or https://ui.perfetto.dev.

**The profiler hook.**  While a ``torch.profiler`` records, every span also
enters the profiler range ``repro.<name>`` (``record_function``'s, through
torch's C++ range where it has one: see ``_annotation``), so the program's
phases stand on the profiler's host timeline, on its clock, around the
kernels they launch (the reference's ``jax.profiler`` annotation, made to
follow the profiler).  torch is never imported here: a profiler can only
record once the program has loaded it.

**Device timing.**  A span opened with ``device=`` a CUDA device records a
timing ``torch.cuda.Event`` on that device's current stream at its entry
and its exit, while the profiler records or when device timing is on
(``REPRO_OBS=device`` / ``repro_torch.obs.configure(device=True)``).
Nothing synchronizes: the events are resolved when the span is read
(``Span.device_ms``, ``device_interval_ms`` between two spans' events),
never on the request path.

Overhead: a span is two ``perf_counter`` calls, a slotted dataclass, a
deque append and a totals update, plus one test of the profiler's state;
disabled (``repro_torch.obs.configure(enabled=False)``) it is a single
flag test yielding None.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import sys
import threading
import time
from collections import deque
from typing import Any, Optional

from . import _config

__all__ = ["Span", "Tracer", "TRACER", "span", "device_interval_ms"]


@dataclasses.dataclass(slots=True)
class Span:
    """One completed (or in-flight) span; host times from ``perf_counter``,
    device times from the CUDA events of a device-timed span."""

    name: str
    span_id: int
    parent_id: Optional[int]
    root_id: int                 # the root span's id (its own at the root)
    tid: int
    start: float                 # perf_counter seconds
    duration: float = 0.0        # seconds; 0 while in flight
    self_s: float = 0.0          # duration less what child spans cover
    attrs: dict = dataclasses.field(default_factory=dict)
    device_start: Any = None     # torch.cuda.Event at entry, when timed
    device_end: Any = None       # torch.cuda.Event at exit, when timed

    @property
    def device_ms(self) -> Optional[float]:
        """Device milliseconds from entry to exit; None where the span was
        not device-timed or the device has not reached its exit yet."""
        return device_interval_ms(self.device_start, self.device_end)


def device_interval_ms(start, end) -> Optional[float]:
    """Device milliseconds from event ``start`` to event ``end`` (two
    spans' ``device_start`` / ``device_end``); None where either is missing
    or the device has not reached it yet.  Never waits."""
    if start is None or end is None or not (start.query() and end.query()):
        return None
    return start.elapsed_time(end)


_profiler_enabled = None     # torch's test of the profiler, once loaded


def _profiling() -> bool:
    """Whether a torch profiler records now (never without torch loaded)."""
    global _profiler_enabled
    if _profiler_enabled is None:
        torch = sys.modules.get("torch")
        if torch is None:
            return False
        _profiler_enabled = torch._C._autograd._profiler_enabled
    return _profiler_enabled()


_record_function = None      # the profiler's range, once resolved


def _annotation(name: str):
    """Enter the profiler range ``repro.<name>``: torch's C++ range where
    this torch has it (a few us under the profiler, where
    ``torch.profiler.record_function`` takes several times that, on the
    request's critical path), else ``record_function``."""
    global _record_function
    if _record_function is None:
        import torch
        _record_function = getattr(torch._C._profiler,
                                   "_RecordFunctionFast", None)
        if _record_function is None:
            from torch.profiler import record_function
            _record_function = record_function
    ann = _record_function("repro." + name)
    ann.__enter__()
    return ann


def _event(device):
    """A timing event recorded on ``device``'s current stream."""
    import torch
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


class Tracer:
    """Ring-buffered span collector with per-thread parent nesting and
    per-name totals."""

    def __init__(self, capacity: int = 4096):
        self._spans: deque = deque(maxlen=capacity)
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._totals: dict = {}      # name -> [count, host_s, self_s]
        self._lock = threading.Lock()

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, device=None, **attrs) -> "_Scope":
        """Context manager: time a phase, nest under the thread's current
        span, record into the ring and the totals.  ``device`` (a
        ``torch.device``) asks for device timing where it is a CUDA device
        (see the module docstring).  ``with`` gives the live
        :class:`Span` (attach late attributes via ``s.attrs[...] = ...``),
        or None when observability is disabled."""
        return _Scope(self, name, device, attrs)

    def _close(self, s: Span, parent: Optional[Span]) -> None:
        s.duration = time.perf_counter() - s.start
        s.self_s += s.duration
        if parent is not None:
            parent.self_s -= s.duration
        self._spans.append(s)
        with self._lock:
            t = self._totals.get(s.name)
            if t is None:
                t = self._totals[s.name] = [0, 0.0, 0.0]
            t[0] += 1
            t[1] += s.duration
            t[2] += s.self_s

    # ------------------------------------------------------------- queries
    def spans(self) -> list:
        """Snapshot of the completed-span ring (oldest first)."""
        return list(self._spans)

    def totals(self) -> dict:
        """``{name: {"count", "host_s", "self_s"}}`` over every span
        completed since the last ``clear()``, the ring's turned-over ones
        included."""
        with self._lock:
            return {n: {"count": c, "host_s": h, "self_s": sf}
                    for n, (c, h, sf) in self._totals.items()}

    def clear(self) -> None:
        self._spans.clear()
        with self._lock:
            self._totals.clear()

    def requests(self, root: str, last: Optional[int] = None) -> list:
        """The device-timed requests in the ring: ``(root span, its
        descendants in start order)`` for each span named ``root`` that
        carries device events, oldest first; only the last ``last``."""
        spans = self.spans()
        kids: dict = {}
        for s in spans:
            kids.setdefault(s.parent_id, []).append(s)
        roots = [s for s in spans
                 if s.name == root and s.device_start is not None]
        if last is not None:
            roots = roots[len(roots) - min(last, len(roots)):]
        out = []
        for r in roots:
            members, todo = [], [r.span_id]
            while todo:
                for c in kids.get(todo.pop(), ()):
                    members.append(c)
                    todo.append(c.span_id)
            members.sort(key=lambda s: s.start)
            out.append((r, members))
        return out

    def device_ms(self, root: str, name: str,
                  last: Optional[int] = None) -> Optional[float]:
        """Mean over the last ``last`` device-timed ``root`` requests of the
        device milliseconds of their spans named ``name``, summed within
        each request; None where no request holds a resolved one."""
        per = []
        for _r, members in self.requests(root, last):
            ms = [s.device_ms for s in members if s.name == name]
            if ms and None not in ms:
                per.append(sum(ms))
        return sum(per) / len(per) if per else None

    def chrome_trace(self) -> dict:
        """The ring as a Chrome trace-event JSON object (``ph: "X"``
        complete events, microsecond timestamps; a device-timed span's
        ``device_ms`` in its args) — loadable in ``chrome://tracing`` /
        Perfetto."""
        pid = os.getpid()
        events = []
        for s in self._spans:
            args = {k: _jsonable(v) for k, v in s.attrs.items()}
            if s.parent_id is not None:
                args["parent"] = s.parent_id
            args["span_id"] = s.span_id
            args["root"] = s.root_id
            ms = s.device_ms
            if ms is not None:
                args["device_ms"] = ms
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


class _Scope:
    """One ``with tracer.span(...)`` block (a class rather than a
    generator: the request path opens a dozen a request)."""

    __slots__ = ("tracer", "name", "device", "attrs", "span", "parent",
                 "ann")

    def __init__(self, tracer: Tracer, name, device, attrs: dict):
        self.tracer, self.name, self.device = tracer, name, device
        self.attrs = attrs

    def __enter__(self) -> Optional[Span]:
        self.span = None
        if not _config.ENABLED:
            return None
        stack = self.tracer._stack()
        parent = self.parent = stack[-1] if stack else None
        sid = next(self.tracer._ids)
        s = self.span = Span(
            name=str(self.name), span_id=sid,
            parent_id=parent.span_id if parent else None,
            root_id=parent.root_id if parent else sid,
            tid=threading.get_ident(), start=time.perf_counter(),
            attrs=self.attrs)
        stack.append(s)
        profiling = _profiling()
        # the events enclose the profiler's range, so that the device
        # interval holds all the host time the span holds
        if (self.device is not None and (profiling or _config.DEVICE)
                and getattr(self.device, "type", None) == "cuda"):
            s.device_start = _event(self.device)
        self.ann = _annotation(s.name) if profiling else None
        return s

    def __exit__(self, *exc) -> bool:
        s = self.span
        if s is None:
            return False
        if self.ann is not None:
            self.ann.__exit__(None, None, None)
        if s.device_start is not None:
            s.device_end = _event(self.device)
        self.tracer._stack().pop()
        self.tracer._close(s, self.parent)
        return False


#: process-global tracer; ``span(...)`` below is its bound method.
TRACER = Tracer()
span = TRACER.span
