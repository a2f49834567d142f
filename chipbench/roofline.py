"""The yardstick's peaks and work models, frozen.

A copy of ``repro_torch.launch.roofline``'s data-sheet peaks and of its
work model for the fused Gram kernel, kept here so that a later change to
the port's copy cannot move the benchmark's rooflines.  The work is
counted from the plan: what a launch must do on the shapes it is given,
whatever implements it.
"""

from __future__ import annotations

import numpy as np

__all__ = ["PEAKS", "bound", "bucket_work", "work_model"]

# NVIDIA H100 SXM5 80 GB data sheet, dense rates, at 700 W: fp32 on the
# CUDA cores (the Gram kernels' path) and HBM3 bandwidth.
PEAKS = {"NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "hbm_bytes": 3.35e12}}


def bound(work: dict, peak_ops: float, hbm_bw: float) -> float:
    """Seconds: the larger of ``work``'s operations at ``peak_ops`` and its
    bytes at ``hbm_bw``."""
    return max(work["ops"] / peak_ops, work["bytes"] / hbm_bw)


def _sum(works) -> dict:
    works = list(works)
    return {k: sum(w[k] for w in works) for k in ("ops", "bytes")}


def bucket_work(b, d: int) -> dict:
    """One ``fused_gather_gram`` launch over bucket ``b`` (``mask`` (R, L),
    ``R``, ``width``): the products over valid pairs i <= j only (the
    block is symmetric), idx (int32) and mask (uint8) read once and every
    (R, L, L) fp32 output entry written once."""
    n = np.asarray(b.mask).sum(axis=1).astype(np.int64)
    return {"ops": d * int((n * (n + 1)).sum()),
            "bytes": b.R * b.width * 5 + b.R * b.width * b.width * 4}


def work_model(buckets, m: int, d: int, itemsize: int) -> dict:
    """The same over one request's launches, with the (m, d) table read
    once."""
    works = _sum(bucket_work(b, d) for b in getattr(buckets, "buckets",
                                                    buckets))
    return {"ops": works["ops"], "bytes": m * d * itemsize + works["bytes"]}
