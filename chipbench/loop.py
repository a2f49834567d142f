"""The one traffic generator: a client that offers a cell's requests as
its traffic file says, and times each.

The keys of a traffic file read here:

* ``arrival``: ``"closed"``, a request is sent as soon as fewer than
  ``in_flight`` are outstanding; or ``"open"``, requests arrive at
  ``rate_per_s`` a second with exponential gaps drawn from the run's seed
  (Poisson arrivals), each sent at its arrival or, where ``in_flight``
  are outstanding then, as soon as one has returned;
* ``in_flight``: the most requests outstanding at once (1: each request
  has returned before the next is sent).

A request's tables are drawn when it is sent, before its clock starts,
and synchronized where nothing is outstanding (with requests outstanding
the draw queues behind them on the device).  A closed request is timed
from its call, an open one from its arrival, so that a wait in the queue
counts; each ends when the client sees its result complete on the device.
No request is sent once ``seconds`` have passed (or ``count`` have been
sent); the window ends when the last outstanding one has returned.
"""

from __future__ import annotations

import collections
import random
import time
import traceback

__all__ = ["Device", "offer"]

# how long an open loop sleeps between looks at its outstanding requests
POLL_S = 2e-4


class Device:
    """How the client sees the device: ``sync`` waits for all work queued,
    ``mark`` returns a marker of the work queued so far, ``ready`` says
    whether a marker's work is done and ``wait`` waits for it.  On the CPU
    every call has returned its result, so every marker is ready."""

    def __init__(self, device):
        import torch
        self.cuda = device.type == "cuda"
        self._torch, self._device = torch, device

    def sync(self) -> None:
        if self.cuda:
            self._torch.cuda.synchronize(self._device)

    def mark(self):
        if not self.cuda:
            return None
        ev = self._torch.cuda.Event()
        ev.record()
        return ev

    def ready(self, marker) -> bool:
        return marker is None or marker.query()

    def wait(self, marker) -> None:
        if marker is not None:
            marker.synchronize()


def offer(traffic: dict, seed: int, *, draw, call, device: Device,
          retired=None, seconds: float = float("inf"),
          count: int | None = None) -> dict:
    """Offer requests ``call(draw())`` as ``traffic`` says, until
    ``seconds`` have passed or ``count`` have been sent.  ``retired(tables,
    out)`` is called as each request returns, in order.  Returns the
    window's record: ``window_start_wall``, ``window_s``, ``attempted``,
    ``failed``, ``errors`` (the first), and per returned request
    ``latency_s`` and ``dispatch_s`` (the call's host time)."""
    in_flight = int(traffic.get("in_flight", 1))
    rate = traffic["rate_per_s"] if traffic["arrival"] == "open" else None
    if in_flight < 1 or traffic["arrival"] not in ("closed", "open"):
        raise ValueError(f"traffic {traffic.get('name')!r}: arrival "
                         f"{traffic['arrival']!r}, in_flight {in_flight}")
    gaps = random.Random(seed)
    pending = collections.deque()
    latency, dispatch, errors = [], [], []
    attempted = 0
    wall0 = time.time()
    w0 = time.perf_counter()
    arrive = w0 + (gaps.expovariate(rate) if rate else 0.0)

    def retire():
        start, disp, marker, tables, out = pending.popleft()
        device.wait(marker)
        latency.append(time.perf_counter() - start)
        dispatch.append(disp)
        if retired is not None:
            retired(tables, out)

    while True:
        now = time.perf_counter()
        if (attempted and now - w0 >= seconds) or attempted == count:
            if not pending:
                break
            retire()
        elif len(pending) >= in_flight:
            retire()
        elif rate and now < arrive:
            if pending and device.ready(pending[0][2]):
                retire()
            else:
                time.sleep(min(arrive - now, POLL_S))
        else:
            tables = draw()
            if not pending:
                device.sync()
            attempted += 1
            t0 = time.perf_counter()
            start = arrive if rate else t0
            if rate:
                arrive += gaps.expovariate(rate)
            try:
                out = call(tables)
            except Exception:   # counted as failed; the run goes on
                errors.append(traceback.format_exc())
                continue
            t1 = time.perf_counter()
            pending.append((start, t1 - t0, device.mark(), tables, out))
    return {"window_start_wall": wall0,
            "window_s": time.perf_counter() - w0, "attempted": attempted,
            "failed": len(errors), "errors": errors[:1],
            "latency_s": latency, "dispatch_s": dispatch}
