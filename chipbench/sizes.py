"""The deployment's table of input sizes, drawn from its profile seed.

A frozen copy of the size draw of the port's chip smoke test
(``chip_smoke.bench_profile``): the Zipf profile of
``benchmarks/bench_engine.py::run_skewed``.  A configuration lists its draws in
order; all of them come from one ``numpy.random.default_rng(profile_seed)``,
so the sizes are the same in every run whatever ``--seed`` is.
"""

from __future__ import annotations

import numpy as np

__all__ = ["draw_sizes"]


def _zipf(rng, spec: dict) -> np.ndarray:
    w = rng.zipf(spec["a"], spec["n"]).astype(np.float64) / spec["divide"]
    return np.clip(w, *spec["clip"])


_DISTS = {"zipf": _zipf}


def draw_sizes(specs: list, profile_seed: int) -> list:
    """One float64 array of sizes per entry of ``specs``, in order."""
    rng = np.random.default_rng(profile_seed)
    return [_DISTS[s["dist"]](rng, s) for s in specs]
