"""Small copies of the benchmark's cells for the CPU tests (the same code
paths at sizes a test run holds)."""

from __future__ import annotations

from chipbench import spec

A2A = "a2a-nytimes.refresh"


def small_spec(workload: str = A2A, *, m: int = 200, d: int = 16,
               **traffic) -> dict:
    """``workload``'s spec at ``m`` inputs of ``d`` features, its traffic's
    keys overridden by ``traffic``."""
    s = spec.cell_spec(workload)
    s["config"]["m"], s["config"]["d"] = m, d
    s["config"]["sizes"][0]["n"] = m
    s["traffic"]["trace_requests"] = 4
    s["traffic"].update(traffic)
    return s
