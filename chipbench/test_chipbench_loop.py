"""The traffic generator on a simulated device: closed loops with one or
more requests outstanding, open loops at a rate drawn from the seed, the
window's stop, and failed requests."""

import time

import pytest

from chipbench import loop


class _Serial:
    """A device that runs queued work one request after another, each
    taking ``service_s``; a marker is the time its work is done."""

    def __init__(self, service_s):
        self.service_s, self.end, self.syncs = service_s, 0.0, 0

    def sync(self):
        self.syncs += 1
        time.sleep(max(0.0, self.end - time.perf_counter()))

    def mark(self):
        self.end = max(self.end, time.perf_counter()) + self.service_s
        return self.end

    def ready(self, marker):
        return time.perf_counter() >= marker

    def wait(self, marker):
        time.sleep(max(0.0, marker - time.perf_counter()))


def _run(traffic, dev, seed=3, **stop):
    sent, retired = [], []
    outstanding = []

    def call(tables):
        sent.append(tables)
        outstanding.append(tables)
        peak[0] = max(peak[0], len(outstanding))
        return tables

    def on_retired(tables, out):
        assert outstanding.pop(0) == tables == out
        retired.append(tables)
    peak = [0]
    counter = iter(range(10 ** 6))
    rec = loop.offer(traffic, seed, draw=lambda: next(counter), call=call,
                     device=dev, retired=on_retired, **stop)
    return rec, sent, retired, peak[0]


@pytest.mark.parametrize("in_flight", [1, 2, 3])
def test_a_closed_loop_keeps_in_flight_requests_outstanding(in_flight):
    dev = _Serial(0.01)
    rec, sent, retired, peak = _run(
        {"arrival": "closed", "in_flight": in_flight}, dev, count=12)
    assert sent == retired == list(range(12))
    assert peak == in_flight and rec["attempted"] == 12
    assert len(rec["latency_s"]) == len(rec["dispatch_s"]) == 12
    # queued behind the others, a request waits for them
    steady = sorted(rec["latency_s"][in_flight:12 - in_flight])
    assert steady[len(steady) // 2] >= 0.75 * 0.01 * in_flight
    # the draw is synchronized only where nothing is outstanding
    assert dev.syncs == (12 if in_flight == 1 else 1)


def test_a_closed_loop_stops_sending_when_the_window_ends():
    rec, sent, retired, _ = _run({"arrival": "closed", "in_flight": 2},
                                 _Serial(0.005), seconds=0.1)
    assert len(sent) == len(retired) == rec["attempted"]
    assert 0.1 <= rec["window_s"] < 0.1 + 3 * 0.005
    assert 15 <= rec["attempted"] <= 25


def test_an_open_loop_sends_at_arrivals_drawn_from_the_seed():
    traffic = {"arrival": "open", "rate_per_s": 400.0, "in_flight": 4}
    a = _run(traffic, _Serial(0.0005), seed=9, seconds=0.25)[0]
    b = _run(traffic, _Serial(0.0005), seed=9, seconds=0.25)[0]
    # about rate x seconds requests, the same number for the same seed
    assert abs(a["attempted"] - b["attempted"]) <= 3
    assert 60 <= a["attempted"] <= 140
    # below capacity a request waits little beyond its service time
    assert sorted(a["latency_s"])[len(a["latency_s"]) // 2] < 0.005


def test_an_open_loop_above_capacity_counts_the_wait_in_the_queue():
    traffic = {"arrival": "open", "rate_per_s": 1000.0, "in_flight": 1}
    rec = _run(traffic, _Serial(0.004), seconds=0.2)[0]
    # arrivals every 1 ms on average, served every 4: the queue grows
    assert rec["latency_s"][-1] > 0.05
    assert rec["latency_s"][-1] > 5 * rec["latency_s"][0]


def test_a_failed_request_is_counted_and_the_run_goes_on():
    def call(tables):
        if tables == 2:
            raise RuntimeError("planted")
        return tables
    counter = iter(range(100))
    rec = loop.offer({"arrival": "closed", "in_flight": 1}, 0,
                     draw=lambda: next(counter), call=call,
                     device=_Serial(0.0), count=5)
    assert rec["attempted"] == 5 and rec["failed"] == 1
    assert len(rec["latency_s"]) == 4
    assert "planted" in rec["errors"][0]


@pytest.mark.parametrize("traffic", [{"arrival": "burst"},
                                     {"arrival": "closed", "in_flight": 0}])
def test_an_unknown_traffic_is_refused(traffic):
    with pytest.raises(ValueError):
        loop.offer(traffic, 0, draw=lambda: 0, call=lambda t: t,
                   device=_Serial(0.0), count=1)
