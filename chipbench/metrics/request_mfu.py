"""request_mfu: the useful work the window's requests delivered, over the
cards' fp32 peak, in percent.

Useful work is what any implementation must do, the same whatever runs
it: 2 d operations per required pair.  It is taken over all the window's
returned requests and all its seconds (a mean request time would count a
request twice where two are outstanding); the peak is the data-sheet fp32
rate of the CUDA cores times the number of cards."""


def read(ctx):
    lat, peaks = ctx["latency_s"], ctx["peaks"]
    if not lat or peaks is None:
        return None
    ops = 2 * ctx["config"]["d"] * ctx["pairs_per_request"] * len(lat)
    return 100.0 * ops / ctx["window_s"] / (peaks["fp32_flops"]
                                            * ctx["chips"])
