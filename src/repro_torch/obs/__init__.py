"""Unified observability layer: metrics, spans, events, comm ledger.

The port's own copy of ``repro.obs`` (same series names, so dashboards
read both packages alike).  Zero-dependency (stdlib-only) telemetry
substrate — see DESIGN.md section 1j.  Four process-global instruments:

* :data:`REGISTRY` — labeled counters/gauges/histograms
  (:mod:`repro_torch.obs.metrics`);
* :data:`TRACER` / :func:`span` — nested spans with per-name totals, the
  ``torch.profiler`` hook, CUDA-event device timing and Chrome-trace
  export (:mod:`repro_torch.obs.trace`);
* :data:`EVENTS` / :func:`emit` — structured plan-lifecycle event log
  (:mod:`repro_torch.obs.events`);
* :data:`LEDGER` — the comm reconciler: measured vs predicted vs
  lower-bound shuffle traffic (:mod:`repro_torch.obs.ledger`).

``configure(enabled=False)`` (or ``REPRO_OBS=0`` in the environment) turns
every publish site into a single flag test; ``configure(device=True)`` (or
``REPRO_OBS=device``) times device spans without a profiler;
``reset_all()`` zeroes the whole layer between benchmark phases or test
cases.
"""

from __future__ import annotations

from typing import Optional

from . import _config
from .events import EVENTS, EventLog, emit
from .ledger import LEDGER, CommLedger, CommRecord
from .metrics import (
    DEFAULT_BUCKETS,
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    exponential_buckets,
)
from .trace import TRACER, Span, Tracer, device_interval_ms, span

__all__ = [
    "REGISTRY", "TRACER", "EVENTS", "LEDGER",
    "span", "emit", "device_interval_ms",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "Span", "Tracer", "EventLog", "CommLedger", "CommRecord",
    "DEFAULT_BUCKETS", "exponential_buckets",
    "configure", "enabled", "device_timing", "reset_all",
]


def configure(*, enabled: Optional[bool] = None,
              device: Optional[bool] = None) -> bool:
    """Flip the global observability switch and, with ``device``, device
    timing without a profiler; returns whether observability is on."""
    if enabled is not None:
        _config.set_enabled(enabled)
    if device is not None:
        _config.set_device(device)
    return _config.ENABLED


def enabled() -> bool:
    return _config.ENABLED


def device_timing() -> bool:
    """Whether device spans record CUDA events without a profiler."""
    return _config.DEVICE


def reset_all() -> None:
    """Zero the registry and clear spans/events/ledger (for tests and
    benchmark phase boundaries)."""
    REGISTRY.reset()
    TRACER.clear()
    EVENTS.clear()
    LEDGER.clear()
