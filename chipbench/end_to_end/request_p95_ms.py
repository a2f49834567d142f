"""request_p95_ms: the 95th percentile (numpy's linear interpolation) of
the times of every returned request of the window, in milliseconds; each
from its call (closed loop) or arrival (open loop) until the client saw it
complete on the device."""

import math

import numpy as np


def read(ctx):
    lat = np.asarray(ctx["latency_s"], np.float64)
    return float(np.percentile(lat, 95)) * 1e3 if lat.size else math.inf
