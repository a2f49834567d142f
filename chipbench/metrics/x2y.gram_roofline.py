"""x2y.gram_roofline: the rectangular Gram kernel's share of its roofline,
in percent.

The least time the card could take for one request's rect launches (the
frozen work model of ``chipbench.roofline_x2y`` over the launches the plan
makes, which the X2Y problem gives as the cell's ``work``, at the card's
data-sheet fp32 and HBM peaks) over the profiler's device time per request
of the Gram kernels: ``gram_roofline``'s reading, in a cell where the only
Gram kernel is ``fused_gather_gram_rect``."""

from chipbench import spec


def read(ctx):
    return spec.metric_reader("gram_roofline")(ctx)
