"""Comm-ledger reconciler: measured shuffle traffic vs the schema's
prediction and the Thm-8 lower bound (DESIGN.md 1j).

The paper's objective is communication cost — input copies shipped to
capacity-q reducers — and the planner *predicts* it exactly
(``plan.comm_cost``, weighted rows) along with the theorem lower bound
(``plan.lower_bound``, ``s^2/q`` for all-pairs).  This module closes the
loop at execution time: every executor dispatch records what actually
moved —

* ``measured_slots``: the gather slots the executed program really
  materializes (valid plan slots; replica-stacked slots for the coded
  executor, the dirty sub-plan's slots for a streaming delta);
* ``gathered_bytes``: those slots times the input row size
  (``d * itemsize`` — the byte convention ``dryrun_engine`` uses);
* ``assembled_bytes`` / ``local_bytes`` / ``residual_bytes``: cross-shard
  assembly traffic (the sharded all-gather, the coded residual
  all-to-all) and the coded replica-local vs residual split —

against the plan's booked cost.  The headline ratios:

``measured_over_predicted``
    executed input copies over planned input copies.  The schema books
    ``plan_slots`` copies at weighted cost ``predicted_rows``; the per-copy
    identity makes the ratio ``measured_slots / plan_slots`` in *any*
    weight profile.  Exactly 1.0 on the dense/bucketed/fused/sharded paths
    (they execute the schema verbatim — pinned by tests), exactly ``r`` on
    the coded executor (replication is paid in shipped copies), and the
    recompute fraction on a streaming delta relative to its delta ledger.
``measured_over_lb``
    measured weighted rows over the theorem bound — the *runtime*
    optimality gap: ``optimality_gap x measured_over_predicted``.

Drift beyond tolerance (default 5% relative to the expected replication
multiplier) means execution is not shipping what the plan booked — a plan/
executor bug, not noise — and raises a ``comm_anomaly`` event plus an
anomaly counter.  How to read one: see DESIGN.md 1j.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Optional

from . import _config
from .events import EVENTS
from .metrics import REGISTRY

__all__ = ["CommRecord", "CommLedger", "LEDGER"]


@dataclasses.dataclass
class CommRecord:
    """One execution's communication reconciliation."""

    seq: int
    executor: str
    workload: str
    predicted_rows: float          # schema ledger (weighted input copies)
    lb_rows: Optional[float]       # theorem lower bound, same units
    plan_slots: int                # gather slots the plan books
    measured_slots: int            # gather slots the program executed
    d: int                         # input row feature count
    itemsize: int                  # bytes per feature element
    replication: float = 1.0       # expected copy multiplier (coded: r)
    assembled_bytes: int = 0       # cross-shard assembly traffic (cluster)
    local_bytes: int = 0           # coded: replica-local served bytes
    residual_bytes: int = 0        # coded: cross-shard residual bytes
    anomaly: bool = False
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def row_bytes(self) -> int:
        return self.d * self.itemsize

    @property
    def gathered_bytes(self) -> int:
        return self.measured_slots * self.row_bytes

    @property
    def predicted_bytes(self) -> float:
        return self.predicted_rows * self.row_bytes

    @property
    def lb_bytes(self) -> Optional[float]:
        return None if self.lb_rows is None else self.lb_rows * self.row_bytes

    @property
    def measured_over_predicted(self) -> float:
        """Executed input copies over planned input copies (see module
        docstring: equals measured/predicted weighted rows for any weight
        profile, because both sides count the same per-copy weights)."""
        if self.plan_slots <= 0:
            return 1.0 if self.measured_slots == 0 else float("inf")
        return self.measured_slots / self.plan_slots

    @property
    def measured_rows(self) -> float:
        """Measured traffic in the schema's weighted-row units."""
        return self.predicted_rows * self.measured_over_predicted

    @property
    def measured_over_lb(self) -> Optional[float]:
        if self.lb_rows is None or self.lb_rows <= 0:
            return None
        return self.measured_rows / self.lb_rows

    def summary(self) -> dict:
        return {
            "executor": self.executor, "workload": self.workload,
            "measured_over_predicted": self.measured_over_predicted,
            "measured_over_lb": self.measured_over_lb,
            "replication": self.replication,
            "gathered_bytes": self.gathered_bytes,
            "predicted_bytes": self.predicted_bytes,
            "assembled_bytes": self.assembled_bytes,
            "local_bytes": self.local_bytes,
            "residual_bytes": self.residual_bytes,
            "anomaly": self.anomaly,
        }


class CommLedger:
    """Bounded ring of :class:`CommRecord` with anomaly detection.

    ``tolerance`` is relative: a record is anomalous when its
    ``measured_over_predicted`` deviates from the *expected* multiplier
    (``replication``; 1.0 for unreplicated executors) by more than
    ``tolerance * replication``.  Anomalies emit a ``comm_anomaly`` event
    and bump the ``ledger.anomalies`` counter; every record feeds the
    ``ledger.measured_over_predicted`` histogram per (executor, workload).
    """

    def __init__(self, capacity: int = 2048, tolerance: float = 0.05):
        self._ring: deque = deque(maxlen=capacity)
        self._seq = 0
        self._lock = threading.Lock()
        self.tolerance = float(tolerance)

    def record(self, *, executor: str, workload: str,
               predicted_rows: float, lb_rows: Optional[float],
               plan_slots: int, measured_slots: int, d: int,
               itemsize: int = 4, replication: float = 1.0,
               assembled_bytes: int = 0, local_bytes: int = 0,
               residual_bytes: int = 0,
               meta: Optional[dict] = None) -> Optional[CommRecord]:
        """Reconcile one execution; returns the record (None when obs is
        disabled)."""
        if not _config.ENABLED:
            return None
        with self._lock:
            self._seq += 1
            seq = self._seq
        rec = CommRecord(
            seq=seq, executor=str(executor), workload=str(workload),
            predicted_rows=float(predicted_rows),
            lb_rows=None if lb_rows is None else float(lb_rows),
            plan_slots=int(plan_slots), measured_slots=int(measured_slots),
            d=int(d), itemsize=int(itemsize),
            replication=float(replication),
            assembled_bytes=int(assembled_bytes),
            local_bytes=int(local_bytes),
            residual_bytes=int(residual_bytes), meta=dict(meta or {}))
        ratio = rec.measured_over_predicted
        expected = max(rec.replication, 1e-12)
        if abs(ratio - expected) > self.tolerance * expected:
            rec.anomaly = True
            REGISTRY.counter("ledger.anomalies", executor=rec.executor,
                             workload=rec.workload).inc()
            EVENTS.emit("comm_anomaly", executor=rec.executor,
                        workload=rec.workload,
                        measured_over_predicted=ratio,
                        expected=expected,
                        measured_slots=rec.measured_slots,
                        plan_slots=rec.plan_slots,
                        gathered_bytes=rec.gathered_bytes)
        REGISTRY.counter("ledger.records", executor=rec.executor,
                         workload=rec.workload).inc()
        REGISTRY.counter("ledger.gathered_bytes",
                         executor=rec.executor).inc(rec.gathered_bytes)
        REGISTRY.counter("ledger.assembled_bytes",
                         executor=rec.executor).inc(rec.assembled_bytes)
        REGISTRY.histogram("ledger.measured_over_predicted",
                           executor=rec.executor,
                           workload=rec.workload).observe(ratio)
        mol = rec.measured_over_lb
        if mol is not None:
            REGISTRY.histogram("ledger.measured_over_lb",
                               executor=rec.executor,
                               workload=rec.workload).observe(mol)
        self._ring.append(rec)
        return rec

    # ------------------------------------------------------------- queries
    @property
    def seq(self) -> int:
        """Monotonic count of records ever taken (snapshot marker: compare
        two reads to find how many records a window produced)."""
        return self._seq

    def records(self, since_seq: int = 0) -> list:
        """Records with ``seq > since_seq`` still in the ring (oldest
        first)."""
        return [r for r in list(self._ring) if r.seq > since_seq]

    def last(self) -> Optional[CommRecord]:
        return self._ring[-1] if self._ring else None

    def summary(self) -> dict:
        """Aggregate per (executor, workload): record/anomaly counts, byte
        totals, min/max measured_over_predicted."""
        out: dict = {}
        for r in list(self._ring):
            key = f"{r.executor}/{r.workload}"
            agg = out.setdefault(key, {
                "records": 0, "anomalies": 0, "gathered_bytes": 0,
                "assembled_bytes": 0, "local_bytes": 0, "residual_bytes": 0,
                "measured_over_predicted_min": float("inf"),
                "measured_over_predicted_max": 0.0})
            agg["records"] += 1
            agg["anomalies"] += int(r.anomaly)
            agg["gathered_bytes"] += r.gathered_bytes
            agg["assembled_bytes"] += r.assembled_bytes
            agg["local_bytes"] += r.local_bytes
            agg["residual_bytes"] += r.residual_bytes
            ratio = r.measured_over_predicted
            agg["measured_over_predicted_min"] = min(
                agg["measured_over_predicted_min"], ratio)
            agg["measured_over_predicted_max"] = max(
                agg["measured_over_predicted_max"], ratio)
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


#: process-global ledger — what the executors reconcile into.
LEDGER = CommLedger()
