"""The work model of the rectangular Gram kernel, frozen.

A copy of ``repro_torch.launch.roofline``'s ``rect_bucket_work`` and
``rect_work`` (``fused_gather_gram_rect``), kept here so that a later
change to the port's copy cannot move the benchmark's rooflines; the
peaks and ``bound`` are ``chipbench.roofline``'s.  The work is counted
from the plan: what a launch must do on the shapes it is given, whatever
implements it.
"""

from __future__ import annotations

import numpy as np

__all__ = ["rect_bucket_work", "rect_work"]


def rect_bucket_work(b, d: int) -> dict:
    """One ``fused_gather_gram_rect`` launch over bucket ``b`` (``mask``
    (R, Lx), ``ymask`` (R, Ly), ``R``, ``width``, ``ywidth``): 2 d
    operations per valid (x, y) pair, idx (int32) and mask (uint8) of both
    sides read once and every (R, Lx, Ly) fp32 output entry written
    once."""
    nx = np.asarray(b.mask).sum(axis=1).astype(np.int64)
    ny = np.asarray(b.ymask).sum(axis=1).astype(np.int64)
    return {"ops": 2 * d * int((nx * ny).sum()),
            "bytes": b.R * (b.width + b.ywidth) * 5
            + b.R * b.width * b.ywidth * 4}


def rect_work(buckets, m: int, d: int, itemsize: int) -> dict:
    """The same over one request's launches, with both tables (``m`` rows
    together) read once."""
    works = [rect_bucket_work(b, d)
             for b in getattr(buckets, "buckets", buckets)]
    return {"ops": sum(w["ops"] for w in works),
            "bytes": m * d * itemsize + sum(w["bytes"] for w in works)}
