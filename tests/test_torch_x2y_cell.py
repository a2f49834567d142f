"""The path of the benchmark's X2Y cell on the CPU: the port's
``x2y_similarity(..., executor="fused")`` on a schema planned once, held
against the benchmark's plain reference (``chipbench.reference_x2y``); the
reference's schema checks on ``plan_x2y``'s schemas and on broken ones;
and the spans and counters of one X2Y request beside the square path's.

    PYTHONPATH=src python -m pytest -q tests/test_torch_x2y_cell.py
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = str(Path(__file__).resolve().parents[1])
if ROOT not in sys.path:        # chipbench lives at the checkout's root
    sys.path.insert(0, ROOT)

from chipbench.reference import max_abs_err  # noqa: E402
from chipbench.reference_x2y import cosine_x2y, x2y_violations  # noqa: E402
from chipbench.sizes import draw_sizes  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import plan_a2a, plan_x2y  # noqa: E402
from repro_torch.mapreduce.allpairs import (  # noqa: E402
    pairwise_similarity,
    x2y_similarity,
)
from repro_torch.mapreduce.assembly import rect_launch_plan  # noqa: E402

Q = 1.0
SHAPES = [(40, 72), (96, 160)]
SEEDS = [0, 1, 2]
# The port multiplies in fp32 and the reference in float64: at d = 16 the
# port's rounding is ~1e-7 of a cosine of at most 1, so 1e-5, the cell's
# own limit, leaves two orders of room and still fails a TF32 product
# (~1e-4 at the cell's d = 256).
LIMIT = 1e-5


@pytest.fixture(autouse=True)
def _clean_obs():
    obs.reset_all()
    yield
    obs.reset_all()


def _sizes(mx, my, seed):
    """Zipf sizes as the cell draws them: the catalogue (Y) first."""
    zipf = {"dist": "zipf", "a": 1.6, "divide": 32.0, "clip": [0.01, 0.45]}
    wy, wx = draw_sizes([{**zipf, "n": my}, {**zipf, "n": mx}], seed)
    return wx, wy


def _tables(mx, my, d, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((mx, d), generator=g),
            torch.randn((my, d), generator=g))


def _request(x, y, wx, wy, schema):
    return x2y_similarity(x, y, q=Q, wx=wx, wy=wy, schema=schema,
                          metric="cosine", executor="fused", device="cpu")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("mx,my", SHAPES)
def test_fused_x2y_on_a_schema_planned_once_matches_the_reference(
        mx, my, seed):
    wx, wy = _sizes(mx, my, seed)
    schema = plan_x2y(wx, wy, Q)
    plans = []
    for req in range(2):            # fresh tables, the same schema
        x, y = _tables(mx, my, 16, 100 * seed + req)
        sims, plan, got_schema = _request(x, y, wx, wy, schema)
        assert got_schema is schema
        plans.append(plan)
        assert sims.shape == (mx, my) and sims.dtype == torch.float32
        assert max_abs_err(sims, cosine_x2y(x, y)) < LIMIT
    assert plans[0] is plans[1]     # the plan is memoized on the schema


@pytest.mark.parametrize("seed", SEEDS[:2])
@pytest.mark.parametrize("mx,my", SHAPES)
def test_planner_schemas_have_no_violations(mx, my, seed):
    wx, wy = _sizes(mx, my, seed)
    s = plan_x2y(wx, wy, Q)
    assert x2y_violations(s.bins, s.reducers, wx, wy, Q, 1e-9) == {
        "uncovered_pairs": 0, "overfull_reducers": 0}


def test_a_dropped_reducer_leaves_its_pairs_uncovered():
    wx, wy = _sizes(*SHAPES[0], 0)
    s = plan_x2y(wx, wy, Q)
    xb, yb = s.reducers[0]
    got = x2y_violations(s.bins, s.reducers[1:], wx, wy, Q, 1e-9)
    # plan_x2y meets every pair at exactly one reducer
    assert got == {"uncovered_pairs": len(s.bins[xb]) * len(s.bins[yb]),
                   "overfull_reducers": 0}


def test_an_overfilled_reducer_is_counted_once():
    wx, wy = _sizes(*SHAPES[0], 0)
    s = plan_x2y(wx, wy, Q)
    ybins = sorted({r[1] for r in s.reducers})
    reducers = [list(s.reducers[0]) + ybins] + s.reducers[1:]
    assert x2y_violations(s.bins, reducers, wx, wy, Q, 1e-9) == {
        "uncovered_pairs": 0, "overfull_reducers": 1}
    # a bin listed twice counts once
    reducers = [list(s.reducers[0]) * 2] + s.reducers[1:]
    assert x2y_violations(s.bins, reducers, wx, wy, Q, 1e-9)[
        "overfull_reducers"] == 0


def _children(spans):
    kids = {}
    for s in sorted(spans, key=lambda s: s.start):
        kids.setdefault(s.parent_id, []).append(s)
    return kids


def _counters():
    return {k: v for k, v in obs.REGISTRY.snapshot()["counters"].items()
            if k.startswith(("fused.finish", "fused.rect_entries")) and v}


def test_one_request_records_the_rect_spans_and_counters():
    mx, my = SHAPES[1]
    wx, wy = _sizes(mx, my, 3)
    x, y = _tables(mx, my, 16, 3)
    schema = plan_x2y(wx, wy, Q)
    _sims, plan, _ = _request(x, y, wx, wy, schema)
    kids = _children(obs.TRACER.spans())
    (root,) = kids[None]
    assert root.name == "similarity"
    assert root.attrs == {"workload": "x2y", "mx": mx, "my": my}
    plan_span, execute = kids[root.span_id]
    assert (plan_span.name, execute.name) == ("plan", "execute")
    (build,) = kids[plan_span.span_id]
    assert build.name == "plan.build"
    assert build.attrs == {"reducers": plan.num_reducers,
                           "buckets": len(plan.buckets)}
    under = kids[execute.span_id]
    # one launch per tight class of each bucket's reducers
    launch = rect_launch_plan(plan)
    nb = len(launch.buckets)
    assert nb > len(plan.buckets)
    # the source map is looked up (here built) after the launches
    assert [s.name for s in under] == (["upload"]
                                       + ["gram", "finish"] * nb
                                       + ["upload", "assemble"])
    assert [under[0].attrs["kind"], under[-2].attrs["kind"]] == [
        "x2y-buckets", f"srcmap-rect:{mx}x{my}"]
    (srcmap,) = kids[under[-2].span_id]
    assert (srcmap.name, srcmap.attrs) == ("plan.srcmap", {"mx": mx, "my": my})
    # launched the largest block first (ties in launch-plan order)
    launched = sorted(launch.buckets,
                      key=lambda b: -b.R * b.width * b.ywidth)
    assert [s.attrs for s in under if s.name == "gram"] == [
        {"width": b.width, "ywidth": b.ywidth, "R": b.R} for b in launched]
    assert [s.attrs for s in under if s.name == "finish"] == [
        {"width": b.width, "ywidth": b.ywidth} for b in launched]
    # the counters, against a count taken from the launch plan
    valid = sum(int((b.mask.sum(1) * b.ymask.sum(1)).sum())
                for b in launch.buckets)
    computed = sum(b.R * b.width * b.ywidth for b in launch.buckets)
    assert valid == mx * my and computed > valid
    assert computed < sum(b.R * b.width * b.ywidth for b in plan.buckets)
    want = {"fused.finish{shape=rect,where=torch}": nb,
            "fused.rect_entries{kind=valid}": valid,
            "fused.rect_entries{kind=computed}": computed}
    assert _counters() == want
    # a warm request builds nothing and counts as much again
    obs.TRACER.clear()
    _request(x, y, wx, wy, schema)
    names = {s.name for s in obs.TRACER.spans()}
    assert not names & {"plan.build", "plan.srcmap", "upload"}
    assert {"gram", "finish", "assemble"} <= names
    assert _counters() == {k: 2 * v for k, v in want.items()}


def test_the_square_path_keeps_its_spans_and_counter():
    rng = np.random.default_rng(4)
    w = np.minimum(rng.zipf(2.0, 40), 3).astype(np.float64) / 6.0
    x = torch.from_numpy(rng.normal(size=(40, 8)).astype(np.float32))
    _sims, plan, _ = pairwise_similarity(
        x, q=Q, weights=w, schema=plan_a2a(w, Q), metric="cosine",
        executor="fused", device="cpu")
    grams = [s.attrs for s in sorted(obs.TRACER.spans(),
                                     key=lambda s: s.start)
             if s.name == "gram"]
    assert grams == [{"width": b.width, "R": b.R} for b in plan.buckets]
    square = {"fused.finish{where=torch}": len(plan.buckets)}
    assert _counters() == square
    # an X2Y request adds its own series and leaves the square one alone
    mx, my = SHAPES[0]
    wx, wy = _sizes(mx, my, 5)
    _request(*_tables(mx, my, 8, 5), wx, wy, plan_x2y(wx, wy, Q))
    got = _counters()
    assert got["fused.finish{where=torch}"] == len(plan.buckets)
    assert set(got) == set(square) | {
        "fused.finish{shape=rect,where=torch}",
        "fused.rect_entries{kind=valid}", "fused.rect_entries{kind=computed}"}
