"""The X2Y cell, ``x2y-nytimes.refresh``: its frozen rect work model
against the port's, its parts found by name, a small copy of it correct
on the CPU, and faults planted under its timed path (one similarity off
by 1e-3, half of one bucket's Y masks cleared, the TF32 control in the
entry's place) not correct; (``gpu``) the same at the cell's own size on
a card."""

import pytest
import torch

from chipbench import cell, roofline_x2y, spec

X2Y = "x2y-nytimes.refresh"
CONFIG = "x2y-nytimes-q4096-m8192-d256"
SEED = 2 ** 33 + 29
READERS = ("x2y.gram_roofline", "x2y.gram_device_ms", "x2y.finish_device_ms",
           "x2y.assemble_device_ms", "x2y.program_idle_ms", "x2y.block_fill",
           "x2y.setup.build_plan_s", "x2y.setup.srcmap_s")
FAULTS = ("one_similarity", "half_y_masks")


def small_x2y_spec(*, mx: int = 48, my: int = 96, d: int = 16,
                   **traffic) -> dict:
    """The cell's spec at ``mx`` queries and ``my`` articles of ``d``
    features (each size draw cut to its side's count), its traffic's keys
    overridden by ``traffic``."""
    s = spec.cell_spec(X2Y)
    c = s["config"]
    c["mx"], c["my"], c["d"] = mx, my, d
    for draw in c["sizes"]:
        draw["n"] = {"x": mx, "y": my}[draw["side"]]
    s["traffic"]["trace_requests"] = 4
    s["traffic"].update(traffic)
    return s


def _plan(s):
    from repro_torch.mapreduce.engine import build_x2y_plan
    prob = spec.problem("x2y")
    return build_x2y_plan(prob.plan(s["config"], prob.sizes(s["config"])),
                          s["config"]["mx"])


def _one_similarity(fn):
    """The first valid (x, y) entry of every launch moved so that its
    cosine is 1e-3 off (the raw product by 1e-3 times both rows' norms)."""
    def call(x, y, xidx, xmask, yidx, ymask):
        g = fn(x, y, xidx, xmask, yidx, ymask)
        r = int(torch.nonzero(xmask[:, 0] & ymask[:, 0])[0, 0])
        nx = x[xidx[r, 0].long()].double().norm()
        ny = y[yidx[r, 0].long()].double().norm()
        g[r, 0, 0] += float(1e-3 * nx * ny)
        return g
    return call


def _half_y_masks(target):
    """The launches of bucket ``target`` with the Y masks of their first
    half of reducers cleared."""
    def wrap(fn):
        def call(x, y, xidx, xmask, yidx, ymask):
            if (xidx.shape[0], xidx.shape[1], yidx.shape[1]) == target:
                ymask = ymask.clone()
                ymask[: ymask.shape[0] // 2] = False
            return fn(x, y, xidx, xmask, yidx, ymask)
        return call
    return wrap


def _plant(monkeypatch, fault, plan):
    from repro_torch.mapreduce import executors
    if fault == "one_similarity":
        wrap = _one_similarity
    else:
        b = max(plan.buckets, key=lambda b: b.R)
        wrap = _half_y_masks((b.R, b.width, b.ywidth))
    monkeypatch.setattr(executors, "fused_gather_gram_rect",
                        wrap(executors.fused_gather_gram_rect))


def _result(s, control=False, seconds=0.3, trace=False):
    rec = cell.run(s, SEED, seconds, trace, device_type="cpu",
                   control=control)
    return cell.result(s, rec, 0.0, trace)


def test_frozen_rect_work_equals_the_ports():
    from repro_torch.launch import roofline as port
    s = small_x2y_spec(mx=90, my=150)
    plan = _plan(s)
    assert len(plan.buckets) > 1
    for b in plan.buckets:
        assert roofline_x2y.rect_bucket_work(b, 64) == \
            port.rect_bucket_work(b, 64)
    assert roofline_x2y.rect_work(plan, 240, 64, 4) == \
        port.rect_work(plan, 240, 64, 4)
    launched = spec.problem("x2y").launches(plan, "fused")
    assert roofline_x2y.rect_work(launched, 240, 64, 4) == \
        port.rect_work(plan, 240, 64, 4)


def test_the_cell_its_configuration_and_readers_are_found_by_name():
    s = spec.cell_spec(X2Y)
    assert s["cell"] == {**s["cell"], "config": CONFIG,
                         "traffic": "refresh", "chips": 1}
    c = s["config"]
    assert (c["name"], c["problem"], c["metric"], c["dtype"]) == (
        CONFIG, "x2y", "cosine", "float32")
    assert (c["q"], c["mx"], c["my"], c["d"]) == (1.0, 4096, 8192, 256)
    assert sorted(m["name"] for m in s["per_layer"]) == sorted(READERS)
    for name in READERS:
        assert callable(spec.metric_reader(name))
    sz = spec.problem("x2y").sizes(c)
    assert (len(sz["wx"]), len(sz["wy"])) == (4096, 8192)
    # the catalogue's sizes are the A2A cell's
    a2a = spec.cell_spec("a2a-nytimes.refresh")["config"]
    assert (sz["wy"] == spec.problem("a2a").sizes(a2a)["w"]).all()


def test_a_small_copy_of_the_cell_is_correct_and_reads_its_counters():
    from repro_torch import obs
    obs.reset_all()
    s = small_x2y_spec()
    res = _result(s, trace=True)
    assert res["correct"] is True
    assert res["checks"]["sim_max_abs_err"]["value"] < 1e-6
    assert res["checks"]["uncovered_pairs"]["value"] == 0
    plan = _plan(s)
    computed = sum(b.R * b.width * b.ywidth for b in plan.buckets)
    got = res["metrics"]
    assert got["x2y.block_fill"]["value"] == pytest.approx(
        100.0 * 48 * 96 / computed)
    assert got["x2y.setup.build_plan_s"]["value"] > 0
    assert got["x2y.setup.srcmap_s"]["value"] > 0
    # nothing on the CPU is device-timed, and it has no peaks
    assert not {"x2y.gram_device_ms", "x2y.gram_roofline"} & set(got)


@pytest.mark.parametrize("fault", FAULTS)
def test_a_fault_under_the_timed_path_is_not_correct(monkeypatch, fault):
    s = small_x2y_spec()
    _plant(monkeypatch, fault, _plan(s))
    res = _result(s)
    assert res["correct"] is False
    err = res["checks"]["sim_max_abs_err"]
    assert err["value"] > err["limit"]


def test_the_control_in_the_entrys_place_is_not_correct():
    res = _result(small_x2y_spec(d=256), control=True)
    assert res["correct"] is False
    err = res["checks"]["sim_max_abs_err"]
    assert err["value"] > 3 * err["limit"]


def test_block_fill_reads_the_counters_or_nothing(monkeypatch):
    from repro_torch import obs
    from repro_torch.obs.metrics import MetricsRegistry
    reg = MetricsRegistry()
    monkeypatch.setattr(obs, "REGISTRY", reg)
    read = spec.metric_reader("x2y.block_fill")
    assert read({}) is None
    reg.counter("fused.rect_entries", kind="computed").inc(64)
    reg.counter("fused.rect_entries", kind="valid").inc(16)
    assert read({}) == 25.0


# ---------------------------------------------------------------- on a card
@pytest.fixture(scope="module")
def full_cell():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    s = spec.cell_spec(X2Y)
    c = cell.Cell(s, SEED, "cuda")
    return s, c, c.violations()


def _judged(s, c, violations, seconds=1.0):
    rec, sample = c.window(SEED + 1, seconds)
    rec.update(c.check(sample))
    rec.update(violations)
    return cell.result(s, rec, 0.0, False)


@pytest.mark.gpu
def test_on_the_card_the_cell_is_correct(full_cell):
    s, c, violations = full_cell
    assert violations == {"uncovered_pairs": 0, "overfull_reducers": 0}
    assert _judged(s, c, violations)["correct"] is True


@pytest.mark.gpu
@pytest.mark.parametrize("fault", FAULTS)
def test_on_the_card_a_fault_is_not_correct(full_cell, monkeypatch, fault):
    s, c, violations = full_cell
    _plant(monkeypatch, fault, c.plan)
    res = _judged(s, c, violations)
    assert res["correct"] is False
    err = res["checks"]["sim_max_abs_err"]
    assert err["value"] > err["limit"]


@pytest.mark.gpu
def test_on_the_card_the_control_is_not_correct(full_cell):
    s, c, violations = full_cell
    call = c.call
    c.use_control()
    try:
        res = _judged(s, c, violations)
    finally:
        c.call = call
    assert res["correct"] is False
