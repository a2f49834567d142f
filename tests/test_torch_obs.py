"""The port's span tracer (``repro_torch.obs.trace``) on the fused A2A
request: the span tree and its one root id per request, the per-name
totals that outlast the ring, self times, the ``torch.profiler`` hook and
the kill switch on the CPU; on a card (``gpu``), device-timed spans held
against the profiler's kernel times.

    PYTHONPATH=src python -m pytest -q tests/test_torch_obs.py
    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_obs.py
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.core import plan_a2a
from repro_torch.mapreduce.allpairs import pairwise_similarity
from repro_torch.obs import trace as obs_trace

Q = 6.0


@pytest.fixture(autouse=True)
def _clean_obs():
    obs.reset_all()
    was, dev = obs.enabled(), obs.device_timing()
    yield
    obs.configure(enabled=was, device=dev)
    obs.reset_all()


def _problem(m=40, d=8, seed=0):
    rng = np.random.default_rng(seed)
    w = np.minimum(rng.zipf(2.0, m), 3).astype(np.float64)
    x = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32))
    return x, w, plan_a2a(w, Q)


def _request(x, w, schema, device="cpu"):
    return pairwise_similarity(x, q=Q, weights=w, schema=schema,
                               metric="cosine", executor="fused",
                               device=device)


def _children(spans):
    kids = {}
    for s in spans:
        kids.setdefault(s.parent_id, []).append(s)
    return kids


def test_a_cold_fused_request_gives_the_span_tree():
    x, w, schema = _problem()
    _sims, plan, _ = _request(x, w, schema)
    spans = obs.TRACER.spans()
    by_id = {s.span_id: s for s in spans}
    kids = _children(spans)
    (root,) = kids[None]
    assert root.name == "similarity"
    assert root.attrs == {"workload": "pairs", "m": 40}
    assert [s.name for s in kids[root.span_id]] == ["plan", "execute"]
    plan_span, execute = kids[root.span_id]
    assert [s.name for s in kids[plan_span.span_id]] == ["plan.build"]
    build = kids[plan_span.span_id][0]
    assert build.attrs == {"reducers": plan.num_reducers,
                           "buckets": len(plan.buckets)}
    under = sorted(kids[execute.span_id], key=lambda s: s.start)
    names = [s.name for s in under]
    nb = len(plan.buckets)
    assert names == (["upload", "upload"] + ["gram", "finish"] * nb
                     + ["assemble"])
    srcmap_up, buckets_up = under[:2]
    assert srcmap_up.attrs == {"kind": "srcmap:40"}
    assert buckets_up.attrs == {"kind": "buckets"}
    assert [s.name for s in kids[srcmap_up.span_id]] == ["plan.srcmap"]
    assert kids[srcmap_up.span_id][0].attrs == {"m": 40}
    assert buckets_up.span_id not in kids
    # every span of the request carries the root's id; parents enclose
    assert {s.root_id for s in spans} == {root.span_id}
    for s in spans:
        if s.parent_id is not None:
            p = by_id[s.parent_id]
            assert p.start <= s.start
            assert s.start + s.duration <= p.start + p.duration + 1e-9


def test_each_gram_span_is_one_bucket_launch():
    x, w, schema = _problem(m=64, seed=3)
    _sims, plan, _ = _request(x, w, schema)
    spans = sorted(obs.TRACER.spans(), key=lambda s: s.start)
    grams = [s.attrs for s in spans if s.name == "gram"]
    assert grams == [{"width": b.width, "R": b.R} for b in plan.buckets]
    finishes = [s.attrs for s in spans if s.name == "finish"]
    assert finishes == [{"width": b.width} for b in plan.buckets]
    # on the CPU nothing is device-timed
    assert all(s.device_start is None and s.device_ms is None
               for s in spans)


def test_a_warm_request_builds_and_uploads_nothing():
    x, w, schema = _problem()
    _request(x, w, schema)
    cold = obs.TRACER.totals()
    assert {n: cold[n]["count"] for n in ("plan.build", "plan.srcmap",
                                          "upload", "similarity")} == {
        "plan.build": 1, "plan.srcmap": 1, "upload": 2, "similarity": 1}
    obs.TRACER.clear()
    _request(x, w, schema)
    names = {s.name for s in obs.TRACER.spans()}
    assert not names & {"plan.build", "upload", "plan.srcmap"}
    assert {"similarity", "plan", "execute", "gram", "finish",
            "assemble"} <= names
    assert len({s.root_id for s in obs.TRACER.spans()}) == 1


def test_two_requests_have_two_root_ids():
    x, w, schema = _problem()
    _request(x, w, schema)
    _request(x, w, schema)
    roots = [s for s in obs.TRACER.spans() if s.parent_id is None]
    assert [s.name for s in roots] == ["similarity", "similarity"]
    assert ({s.root_id for s in obs.TRACER.spans()}
            == {r.span_id for r in roots})


def test_totals_outlast_the_ring_and_self_time_excludes_children():
    tr = obs_trace.Tracer(capacity=4)
    for _ in range(5):
        with tr.span("outer") as outer:
            with tr.span("inner") as a:
                pass
            with tr.span("inner") as b:
                pass
        assert outer.self_s == pytest.approx(
            outer.duration - a.duration - b.duration, abs=1e-12)
        assert a.self_s == a.duration
    assert len(tr.spans()) == 4
    t = tr.totals()
    assert t["outer"]["count"] == 5 and t["inner"]["count"] == 10
    assert t["outer"]["self_s"] == pytest.approx(
        t["outer"]["host_s"] - t["inner"]["host_s"], abs=1e-9)
    assert t["inner"]["self_s"] == pytest.approx(t["inner"]["host_s"])
    tr.clear()
    assert tr.totals() == {} and tr.spans() == []


def test_totals_of_a_request_add_up():
    x, w, schema = _problem()
    _request(x, w, schema)
    t = obs.TRACER.totals()
    # the root's host seconds are its own plus every descendant's self time
    assert sum(v["self_s"] for v in t.values()) == pytest.approx(
        t["similarity"]["host_s"], rel=1e-9)
    up = t["upload"]
    assert up["self_s"] == pytest.approx(
        up["host_s"] - t["plan.srcmap"]["host_s"], abs=1e-9)


def _counting_annotations(monkeypatch):
    entered = []
    real = obs_trace._annotation

    def counting(name):
        entered.append("repro." + name)
        return real(name)
    monkeypatch.setattr(obs_trace, "_annotation", counting)
    return entered


def test_profiler_hook_annotates_only_while_recording(monkeypatch):
    entered = _counting_annotations(monkeypatch)
    x, w, schema = _problem()
    _request(x, w, schema)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _request(x, w, schema)
    names = {e.name for e in prof.events()}
    assert {"repro.similarity", "repro.plan", "repro.execute",
            "repro.gram", "repro.finish", "repro.assemble"} <= names
    assert set(entered) == {n for n in names if n.startswith("repro.")}
    entered.clear()
    _request(x, w, schema)
    assert entered == []


def test_the_kill_switch_records_nothing(monkeypatch):
    entered = _counting_annotations(monkeypatch)
    obs.configure(enabled=False)
    x, w, schema = _problem()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _request(x, w, schema)
    assert obs.TRACER.spans() == [] and obs.TRACER.totals() == {}
    assert entered == []
    assert not any(e.name.startswith("repro.") for e in prof.events())


def test_device_timing_switch_follows_configure():
    assert obs.configure(device=True) is obs.enabled()
    assert obs.device_timing() is True
    obs.configure(device=False)
    assert obs.device_timing() is False


class _Clock:
    """A fake device clock: events stamped with its time in ms."""

    def __init__(self):
        self.t = 0.0

    def event(self, _device):
        clock = self

        class Ev:
            t = clock.t

            def query(self):
                return True

            def elapsed_time(self, other):
                return other.t - self.t
        return Ev()


def test_device_spans_and_queries_on_a_fake_clock(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(obs_trace, "_event", clock.event)
    obs.configure(device=True)
    cuda = torch.device("cuda", 0)     # nothing runs on it: only the type
    tr = obs_trace.Tracer()
    for prologue in (0.5, 0.25):
        with tr.span("similarity", device=cuda):
            clock.t += prologue
            with tr.span("execute"):
                for ms in (2.0, 3.0):
                    with tr.span("gram", device=cuda):
                        clock.t += ms
                    with tr.span("finish", device=cuda):
                        clock.t += 1.0
                with tr.span("assemble", device=cuda):
                    clock.t += 0.5
    reqs = tr.requests("similarity")
    assert len(reqs) == 2
    root, members = reqs[-1]
    assert [s.name for s in members] == ["execute", "gram", "finish",
                                         "gram", "finish", "assemble"]
    assert root.device_ms == pytest.approx(0.25 + 5.0 + 2.0 + 0.5)
    assert obs.device_interval_ms(root.device_start,
                                  members[1].device_start) == 0.25
    assert tr.device_ms("similarity", "gram") == pytest.approx(5.0)
    assert tr.device_ms("similarity", "finish", last=1) == 2.0
    assert tr.device_ms("similarity", "execute") is None   # host only
    assert tr.device_ms("request", "gram") is None
    assert tr.requests("similarity", last=1) == reqs[1:]
    trace = tr.chrome_trace()["traceEvents"]
    assert [e["args"].get("device_ms") for e in trace
            if e["name"] == "assemble"] == [0.5, 0.5]
    # a span on a CPU device, or with device timing off, takes no event
    with tr.span("similarity", device=torch.device("cpu")) as s:
        pass
    assert s.device_start is None
    obs.configure(device=False)
    with tr.span("similarity", device=cuda) as s:
        pass
    assert s.device_start is None


# ---------------------------------------------------------------- on a card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _gram_kernel_ms(prof) -> float:
    from torch.autograd import DeviceType
    return sum((e.time_range.end - e.time_range.start) * 1e-3
               for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and "fused_gather_gram" in e.name)


@pytest.mark.gpu
def test_device_spans_agree_with_the_profiler(cuda):
    x, w, schema = _problem(m=2048, d=256, seed=1)
    x = x.to(cuda)
    for _ in range(2):                      # build and warm the kernels
        _request(x, w, schema, device=cuda)
    torch.cuda.synchronize()
    obs.reset_all()
    n = 6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            # the card sleeps while the host dispatches the request, so no
            # span's interval holds a wait for the host (as in a request
            # whose device time exceeds its dispatch)
            torch.cuda._sleep(20_000_000)
            _request(x, w, schema, device=cuda)
        torch.cuda.synchronize()
    reqs = obs.TRACER.requests("similarity")
    assert len(reqs) == n
    for root, members in reqs:
        assert root.device_ms is not None and root.device_ms > 0
        for s in members:
            if s.name in ("gram", "finish", "assemble"):
                assert s.device_ms is not None and s.device_ms >= 0
    gram = obs.TRACER.device_ms("similarity", "gram")
    want = _gram_kernel_ms(prof) / n
    assert want > 0
    assert gram == pytest.approx(want, rel=0.05)
    names = {e.name for e in prof.events()}
    assert {"repro.similarity", "repro.gram", "repro.assemble"} <= names


@pytest.mark.gpu
def test_device_timing_without_a_profiler(cuda):
    x, w, schema = _problem(m=512, d=64, seed=2)
    x = x.to(cuda)
    _request(x, w, schema, device=cuda)
    obs.reset_all()
    _request(x, w, schema, device=cuda)
    assert obs.TRACER.requests("similarity") == []      # nothing timed
    obs.configure(device=True)
    _request(x, w, schema, device=cuda)
    torch.cuda.synchronize()
    (root, members), = obs.TRACER.requests("similarity")
    timed = [s for s in members if s.device_start is not None]
    # every bucket is at most 32 wide: the kernel finishes it, so the card
    # records no finish span
    assert {s.name for s in timed} == {"gram", "assemble"}
    assert all(s.device_ms is not None for s in timed)
    assert obs.TRACER.device_ms("similarity", "gram") > 0
