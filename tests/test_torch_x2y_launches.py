"""The fused X2Y path's launch plan (``assembly.rect_launch_plan``): each
rect bucket split into tight ``(wx, wy)`` classes of its reducers' valid
extents, one launch each.

On the CPU, over the reference's four X2Y profiles
(``test_torch_x2y._profiles``), a small Zipf plan and a plan padded to 8
slots and 4 reducers in at most 2 buckets: the launch plan holds the plan's
valid (x, y) pairs exactly; each class is the tightest power of two per
side over its reducers' extents and no wider than their bucket; a class
keeps its bucket's rows in order and no padding row; a tight plan splits
into itself; the launch plan is cached; and the fused answer is the
launches' own composition bit for bit and the plan's buckets' within fp32
rounding (the plain version's ``bmm`` picks its CPU kernel by block
shape; on a card the two are equal to the bit, see
``test_torch_rect_epilogue.py``).

    PYTHONPATH=src python -m pytest -q tests/test_torch_x2y_launches.py
"""

from collections import Counter

import numpy as np
import pytest
import torch

from test_torch_x2y import _profiles

from repro_torch.core import plan_x2y
from repro_torch.kernels.pairwise.fused_gather_gram import (
    fused_gather_gram_rect,
    rect_table_norms,
)
from repro_torch.mapreduce.allpairs import _block_fn_x2y, x2y_similarity
from repro_torch.mapreduce.assembly import (
    _pair_source_map_rect,
    rect_launch_plan,
    with_zero_slot,
)
from repro_torch.mapreduce.engine import (
    build_x2y_plan,
    build_x2y_plan_arrays,
    rect_bucket_arrays,
)
from repro_torch.mapreduce.executors import FusedExecutor

FP32 = dict(rtol=1e-5, atol=1e-5)
CASES = ["balanced", "skew_join", "tiny_y", "uniform", "zipf", "pad8"]
METRICS = ["dot", "cosine", "l2"]


def _sizes(kind):
    if kind in ("zipf", "pad8"):
        rng = np.random.default_rng(7)
        return (np.clip(rng.zipf(1.6, 90) / 32, 0.01, 0.45),
                np.clip(rng.zipf(1.6, 150) / 32, 0.01, 0.45))
    return _profiles()[kind]


def _plan(kind):
    """``(plan, schema, wx, wy)``: the plan ``x2y_similarity`` builds, or
    for ``pad8`` one padded to 8 slots and 4 reducers in 2 buckets."""
    wx, wy = _sizes(kind)
    schema = plan_x2y(wx, wy, 1.0)
    kw = (dict(pad_slots_to=8, pad_reducers_to=4, max_buckets=2)
          if kind == "pad8" else {})
    return build_x2y_plan(schema, len(wx), **kw), schema, wx, wy


def _pairs(plan):
    """The valid (x, y) pairs of the plan's buckets, as a multiset."""
    out = Counter()
    for b in plan.buckets:
        for r in range(b.R):
            xs = b.idx[r][b.mask[r]].tolist()
            ys = b.yidx[r][b.ymask[r]].tolist()
            out.update((i, j) for i in xs for j in ys)
    return out


def _tight(mask_row, width):
    valid = np.flatnonzero(mask_row)
    extent = int(valid[-1]) + 1 if valid.size else 1
    return min(1 << (extent - 1).bit_length(), width)


def _by_bucket(plan, launch):
    """Each plan bucket beside the launch plan's classes of its rows."""
    owner = {int(r): i for i, b in enumerate(plan.buckets)
             for r in b.rows if r >= 0}
    classes = [[] for _ in plan.buckets]
    for c in launch.buckets:
        (i,) = {owner[int(r)] for r in c.rows}
        classes[i].append(c)
    return list(zip(plan.buckets, classes))


@pytest.mark.parametrize("kind", CASES)
def test_the_launch_plan_holds_the_plans_valid_pairs(kind):
    plan, _, wx, wy = _plan(kind)
    launch = rect_launch_plan(plan)
    got = _pairs(launch)
    assert got == _pairs(plan)
    assert sum(got.values()) >= len(wx) * len(wy)
    for f in ("idx", "mask", "yidx", "ymask", "num_reducers", "num_x",
              "num_y", "comm_cost", "algorithm"):
        assert getattr(launch, f) is getattr(plan, f), f


@pytest.mark.parametrize("kind", CASES)
def test_each_class_is_tight_and_within_its_bucket(kind):
    plan, *_ = _plan(kind)
    launch = rect_launch_plan(plan)
    for b, classes in _by_bucket(plan, launch):
        for c in classes:
            assert c.width <= b.width and c.ywidth <= b.ywidth
            assert c.idx.shape == c.mask.shape == (c.R, c.width)
            assert c.yidx.shape == c.ymask.shape == (c.R, c.ywidth)
            for k, r in enumerate(c.rows):
                (p,) = np.flatnonzero(b.rows == r)
                assert _tight(b.mask[p], b.width) == c.width
                assert _tight(b.ymask[p], b.ywidth) == c.ywidth
                # the slots cut to the class: nothing valid is cut off
                assert np.array_equal(c.idx[k], b.idx[p, :c.width])
                assert np.array_equal(c.ymask[k], b.ymask[p, :c.ywidth])
                assert c.mask[k].sum() == b.mask[p].sum()
                assert c.ymask[k].sum() == b.ymask[p].sum()
        # one class per (wx, wy), by area
        shapes = [(c.width, c.ywidth) for c in classes]
        assert len(set(shapes)) == len(shapes)
        assert [w * v for w, v in shapes] == sorted(w * v for w, v in shapes)


@pytest.mark.parametrize("kind", CASES)
def test_classes_keep_bucket_order_and_drop_padding_rows(kind):
    plan, *_ = _plan(kind)
    launch = rect_launch_plan(plan)
    at = 0
    for b, classes in _by_bucket(plan, launch):
        # a bucket's classes come together, in bucket order
        assert all(a is c for a, c in zip(launch.buckets[at:], classes))
        at += len(classes)
        order = {int(r): k for k, r in enumerate(b.rows)}
        for c in classes:
            assert (c.rows >= 0).all()
            ks = [order[int(r)] for r in c.rows]
            assert ks == sorted(ks)
        real = sorted(int(r) for r in b.rows if r >= 0)
        assert sorted(int(r) for c in classes for r in c.rows) == real
    assert at == len(launch.buckets)
    if kind == "pad8":
        assert any((b.rows < 0).any() for b in plan.buckets)


@pytest.mark.parametrize("kind", CASES)
def test_a_tight_plan_splits_into_itself_and_the_split_is_cached(kind):
    plan, *_ = _plan(kind)
    launch = rect_launch_plan(plan)
    assert rect_launch_plan(plan) is launch               # cached
    assert rect_launch_plan(launch) is launch             # already tight
    computed = [sum(b.R * b.width * b.ywidth for b in p.buckets)
                for p in (plan, launch)]
    assert computed[1] <= computed[0]
    if launch is not plan:
        assert computed[1] < computed[0]


def test_a_plan_of_tight_buckets_is_its_own_launch_plan():
    # widths 1, 2 and 4 on each side, each reducer filling its bucket
    xs = [[0], [1, 2], [3, 4, 5, 6], [7]]
    ys = [[0, 1], [2], [3, 4, 5, 6], [7, 8]]
    plan = build_x2y_plan_arrays(xs, ys, num_x=8, num_y=9, max_buckets=8)
    assert [(b.width, b.ywidth) for b in plan.buckets] == [
        (1, 2), (2, 1), (4, 4)]
    assert rect_launch_plan(plan) is plan


def _by_hand(x, y, plan, metric):
    """One finished launch per bucket of ``plan``, written into its vector
    and gathered through its source map."""
    norms = rect_table_norms(x, y, metric)
    blocks = [fused_gather_gram_rect(x, y, *a[:4], metric, None, norms)
              for a in rect_bucket_arrays(plan, x.device)]
    srcmap = torch.as_tensor(_pair_source_map_rect(
        plan, x.shape[0], y.shape[0])).long()
    return with_zero_slot(blocks, x.device)[srcmap]


def _tables(mx, my, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((mx, 16), generator=g), torch.randn((my, 16),
                                                           generator=g)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("kind", CASES)
def test_the_fused_answer_is_the_launches_and_the_plans(kind, metric):
    plan, schema, wx, wy = _plan(kind)
    x, y = _tables(len(wx), len(wy), 11)
    if kind == "pad8":          # a plan x2y_similarity does not build
        got = FusedExecutor().run_x2y((x, y), plan, _block_fn_x2y(metric),
                                      (len(wx), len(wy)), device="cpu")
    else:
        got, used, _ = x2y_similarity(x, y, q=1.0, wx=wx, wy=wy,
                                      schema=schema, metric=metric,
                                      executor="fused", device="cpu")
        assert [(b.width, b.ywidth, b.R) for b in used.buckets] == [
            (b.width, b.ywidth, b.R) for b in plan.buckets]
        plan = used
    assert torch.equal(got, _by_hand(x, y, rect_launch_plan(plan), metric))
    torch.testing.assert_close(got, _by_hand(x, y, plan, metric), **FP32)
