"""The harness's metric arithmetic on hand-worked inputs."""

from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from chipbench import cell, spec
from chipbench._small import A2A
from chipbench.trace import read_events, top

PEAKS = {"fp32_flops": 67e12, "hbm_bytes": 3.35e12}


def _read(name, **ctx):
    return spec.metric_reader(name)(ctx)


def _rec(**over):
    rec = {"latency_s": [0.001, 0.002, 0.003, 0.004],
           "dispatch_s": [0.001] * 4, "window_s": 2.0, "attempted": 4,
           "failed": 0, "window_start_wall": 110.0, "compared": 4,
           "sim_max_abs_err": 1e-7, "uncovered_pairs": 0,
           "overfull_reducers": 0, "memory_peak_bytes": 123,
           "kind": "NVIDIA H100 80GB HBM3"}
    rec.update(over)
    return rec


def test_end_to_end_metrics_of_a_run():
    s = spec.cell_spec(A2A)
    res = cell.result(s, _rec(), start_wall=100.0, trace=False)
    pairs = 8192 * 8191 // 2
    assert pairs == 33_550_336
    assert res["metrics"]["pairs_per_s"]["value"] == pytest.approx(
        4 * pairs / 2.0)
    # numpy's linear 95th percentile of 1, 2, 3, 4 ms: 3 + 0.85
    assert res["metrics"]["request_p95_ms"]["value"] == pytest.approx(3.85)
    assert res["metrics"]["setup_s"]["value"] == pytest.approx(10.0)
    assert res["correct"] is True
    assert list(res)[-1] == "checks"
    assert res["device"] == {"platform": "gpu",
                             "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                             "memory_peak_bytes": 123}


@pytest.mark.parametrize("name", ["pairs_per_s", "request_p95_ms",
                                  "setup_s"])
def test_each_end_to_end_metric_is_its_own_reader(name):
    ctx = {"latency_s": [0.01] * 3, "window_s": 0.5,
           "pairs_per_request": 10, "window_start_wall": 7.0,
           "start_wall": 4.5}
    want = {"pairs_per_s": 60.0, "request_p95_ms": 10.0, "setup_s": 2.5}
    assert spec.end_to_end_reader(name)(ctx) == pytest.approx(want[name])


@pytest.mark.parametrize("over", [
    {"sim_max_abs_err": 2e-5}, {"uncovered_pairs": 1},
    {"overfull_reducers": 1}, {"failed": 1}, {"compared": 0},
    {"latency_s": []}])
def test_any_number_over_its_limit_is_not_correct(over):
    s = spec.cell_spec(A2A)
    assert cell.result(s, _rec(**over), 100.0, False)["correct"] is False


def test_a_p95_is_taken_over_all_requests():
    s = spec.cell_spec(A2A)
    lat = [0.001] * 95 + [0.1] * 5
    res = cell.result(s, _rec(latency_s=lat), 100.0, False)
    assert res["metrics"]["request_p95_ms"]["value"] == pytest.approx(
        1 + 0.05 * 99)


def test_request_mfu_counts_2d_per_required_pair():
    ops = 2 * 256 * 33_550_336
    assert ops == 17_177_772_032
    # three requests in 15 ms, one or two outstanding: the same work a second
    v = _read("request_mfu", latency_s=[0.005] * 3, window_s=0.015,
              peaks=PEAKS, chips=1, config={"d": 256},
              pairs_per_request=33_550_336)
    assert v == pytest.approx(100 * ops / 0.005 / 67e12)
    two = _read("request_mfu", latency_s=[0.010] * 3, window_s=0.015,
                peaks=PEAKS, chips=1, config={"d": 256},
                pairs_per_request=33_550_336)
    assert two == pytest.approx(v)
    four = _read("request_mfu", latency_s=[0.005] * 3, window_s=0.015,
                 peaks=PEAKS, chips=4, config={"d": 256},
                 pairs_per_request=33_550_336)
    assert four == pytest.approx(v / 4)
    assert _read("request_mfu", latency_s=[0.005], window_s=0.005,
                 peaks=None, chips=1, config={"d": 256},
                 pairs_per_request=1) is None


def test_planner_replication_counts_distinct_inputs_per_reducer():
    # reducers hold {0,1,2}, {0,1,3} and {2,3}: 8 copies of 4 inputs
    schema = SimpleNamespace(bins=[[0, 1], [2], [3]],
                             reducers=[[0, 1], [0, 2], [1, 2]])
    assert _read("planner.replication", schema=schema, inputs=4) == 2.0
    overlapping = SimpleNamespace(bins=[[0, 1], [1, 2]], reducers=[[0, 1]])
    assert _read("planner.replication", schema=overlapping, inputs=3) == 1.0


def _trace(device_s, busy_s=0.0):
    return {"device_s": device_s, "busy_s": busy_s, "idle_s": {}}


def test_device_time_readers():
    tr = _trace({"void fused_gather_gram_kernel<float, 8>(Grid)": 0.002,
                 "where_kernel": 0.004, "CatArrayBatchedCopy": 0.002},
                busy_s=0.8)
    ctx = {"trace": tr, "trace_requests": 2, "trace_window_s": 1.0}
    assert _read("finish_assembly_ms", **ctx) == pytest.approx(3.0)
    assert _read("device_idle_share", **ctx) == pytest.approx(20.0)
    # the Gram kernels take 1 ms a request; the least time is 0.1 ms
    roof = _read("gram_roofline", **ctx, peaks=PEAKS,
                 work={"ops": 6.7e9, "bytes": 3.35e7})
    assert roof == pytest.approx(10.0)
    assert _read("gram_roofline", **ctx, peaks=None, work={}) is None
    none = {"trace": None, "trace_requests": 2, "trace_window_s": 1.0}
    for name in ("finish_assembly_ms", "device_idle_share"):
        assert _read(name, **none) is None


def test_host_readers():
    assert _read("host_dispatch_ms", dispatch_s=[0.001, 0.003]) == \
        pytest.approx(2.0)
    assert _read("plan_build_s", plan_s=1.5, first_request_s=2.5) == 4.0


def _ev(name, dev, start_us, end_us, annotation=False):
    return SimpleNamespace(
        name=name, device_type=dev, is_user_annotation=annotation,
        time_range=SimpleNamespace(start=start_us, end=end_us))


def test_read_events_unions_device_time_and_names_gaps():
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    events = [
        _ev("k1", cuda, 0, 100), _ev("k2", cuda, 50, 150),
        _ev("k1", cuda, 300, 400),
        _ev("ProfilerStep#3", cuda, 0, 500),
        _ev("nccl:_all_gather_base", cuda, 0, 450, annotation=True),
        _ev("outer", cpu, 0, 500), _ev("aten::index", cpu, 200, 250),
        _ev("ProfilerStep#3", cpu, 0, 500)]
    got = read_events(events)
    assert got["busy_s"] == pytest.approx(250e-6)
    assert got["device_s"] == pytest.approx({"k1": 200e-6, "k2": 100e-6})
    assert got["idle_s"] == pytest.approx({"aten::index": 150e-6})
    quiet = read_events([_ev("k", cuda, 0, 10), _ev("k", cuda, 20, 30)])
    assert quiet["idle_s"] == pytest.approx({"host": 10e-6})


def test_top_sorts_and_cuts():
    assert top({"a": 1.0, "b": 3.0, "c": 2.0}, n=2) == [["b", 3.0],
                                                         ["c", 2.0]]
    assert top({"x" * 300: 1.0})[0][0] == "x" * 160


def test_reservoir_keeps_k_of_all_offers_by_the_seed():
    def kept(seed):
        r = cell._Reservoir(4, seed)
        for i in range(1000):
            r.offer(i)
        return sorted(r.items)
    assert kept(7) == kept(7)
    assert len(kept(7)) == 4 and max(kept(7)) >= 4
    assert kept(7) != kept(8)


def test_banned_names_are_compared_whole(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "repro_torch_like", torch)
    assert "repro" not in cell.banned_modules()
    monkeypatch.setitem(sys.modules, "repro.core", torch)
    assert cell.banned_modules() == ["repro"]
