"""gram_roofline: the Gram kernels' share of their roofline, in percent.

The least time the card could take for the Gram launches of one request
(the frozen work models of ``chipbench.roofline`` over the launches the
plan makes, at the card's data-sheet fp32 and HBM peaks), over the
profiler's device time per request of the kernels whose names hold one of
``KERNELS``."""

from chipbench.roofline import bound

KERNELS = ("fused_gather_gram",)


def read(ctx):
    tr, work, peaks = ctx["trace"], ctx["work"], ctx["peaks"]
    if tr is None or work is None or peaks is None:
        return None
    s = sum(v for name, v in tr["device_s"].items()
            if any(k in name for k in KERNELS)) / ctx["trace_requests"]
    if s <= 0:
        return None
    return 100.0 * bound(work, peaks["fp32_flops"], peaks["hbm_bytes"]) / s
