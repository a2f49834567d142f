"""The readers of the program's spans against a fabricated tracer: device
times per request from fake CUDA events, set-up totals, and None wherever
no such span was recorded (on the CPU, with observability off, or in a
program whose tracer lacks device timing and totals)."""

from types import SimpleNamespace

import pytest

from chipbench import spec

DEVICE = ("gram_device_ms", "finish_device_ms", "assemble_device_ms",
          "program_idle_ms")
SETUP = ("setup.build_plan_s", "setup.srcmap_s", "setup.upload_s")


class _Clock:
    """Events stamped with a fake device time in ms."""

    def __init__(self):
        self.t = 0.0

    def event(self, _device):
        t = self.t
        return SimpleNamespace(t=t, query=lambda: True,
                               elapsed_time=lambda other: other.t - t)


@pytest.fixture
def tracer(monkeypatch):
    from repro_torch import obs
    from repro_torch.obs import trace
    tr = trace.Tracer()
    monkeypatch.setattr(obs, "TRACER", tr)
    was = obs.device_timing()
    yield tr
    obs.configure(device=was)


def _read(name, trace_requests=2):
    return spec.metric_reader(name)({"trace_requests": trace_requests})


def _request(tr, clock, dev, prologue, grams, finish=1.0, assemble=0.5):
    with tr.span("similarity", device=dev):
        clock.t += prologue
        with tr.span("plan"):
            pass
        with tr.span("execute"):
            for g in grams:
                with tr.span("gram", device=dev, width=4, R=2):
                    clock.t += g
                with tr.span("finish", device=dev, width=4):
                    clock.t += finish
            with tr.span("assemble", device=dev):
                clock.t += assemble
        clock.t += 0.125          # the client's loop: outside the program


def test_device_readers_average_the_last_timed_requests(tracer,
                                                        monkeypatch):
    from repro_torch import obs
    from repro_torch.obs import trace
    clock = _Clock()
    monkeypatch.setattr(trace, "_event", clock.event)
    cuda = SimpleNamespace(type="cuda")
    _request(tracer, clock, cuda, 9.0, [9.0])     # untimed: before the block
    obs.configure(device=True)
    _request(tracer, clock, cuda, 7.0, [7.0])     # timed, but not the last 2
    _request(tracer, clock, cuda, 0.5, [2.0, 3.0])
    _request(tracer, clock, cuda, 0.25, [1.0, 2.0], finish=2.0,
             assemble=1.5)
    assert _read("gram_device_ms") == pytest.approx(4.0)       # (5 + 3) / 2
    assert _read("finish_device_ms") == pytest.approx(3.0)     # (2 + 4) / 2
    assert _read("assemble_device_ms") == pytest.approx(1.0)   # (0.5 + 1.5) / 2
    assert _read("program_idle_ms") == pytest.approx(0.375)    # (0.5 + 0.25) / 2
    assert _read("gram_device_ms", 3) == pytest.approx((7 + 5 + 3) / 3)
    assert _read("program_idle_ms", 10) == pytest.approx(
        (7 + 0.5 + 0.25) / 3)


def test_setup_readers_take_the_totals(tracer):
    with tracer.span("similarity"):
        with tracer.span("plan"):
            with tracer.span("plan.build") as build:
                pass
        with tracer.span("execute"):
            with tracer.span("upload") as up:
                with tracer.span("plan.srcmap") as srcmap:
                    pass
            with tracer.span("upload") as up2:
                pass
    assert _read("setup.build_plan_s") == build.duration
    assert _read("setup.srcmap_s") == srcmap.duration
    assert _read("setup.upload_s") == pytest.approx(
        up.duration - srcmap.duration + up2.duration, abs=1e-12)


@pytest.mark.parametrize("name", DEVICE + SETUP)
def test_no_span_reads_none(tracer, name):
    assert _read(name) is None


@pytest.mark.parametrize("name", DEVICE)
def test_host_only_spans_read_none(tracer, name):
    # on the CPU, or without the profiler, a request carries no events
    _request(tracer, _Clock(), SimpleNamespace(type="cpu"), 0.5, [1.0])
    assert _read(name) is None


@pytest.mark.parametrize("name", DEVICE + SETUP)
def test_observability_off_reads_none(tracer, name):
    from repro_torch import obs
    obs.configure(enabled=False)
    try:
        with tracer.span("plan.build"):
            pass
        _request(tracer, _Clock(), SimpleNamespace(type="cuda"), 0.5, [1.0])
    finally:
        obs.configure(enabled=True)
    assert _read(name) is None


@pytest.mark.parametrize("name", DEVICE + SETUP)
def test_a_tracer_without_device_timing_or_totals_reads_none(monkeypatch,
                                                             name):
    """A program whose tracer has only the ring (as before its spans were
    device-timed) gives no reading and raises nothing."""
    from repro_torch import obs
    old = SimpleNamespace(spans=lambda: [], clear=lambda: None)
    monkeypatch.setattr(obs, "TRACER", old)
    assert _read(name) is None
