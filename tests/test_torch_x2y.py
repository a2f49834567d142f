"""The port's rectangular (X2Y) path against the JAX package, on the CPU.

Plans: ``build_x2y_plan`` arrays and the rectangular source map must be
byte-equal to the reference's.  Kernel: the plain version of
``fused_gather_gram_rect`` against the reference's Pallas kernel in
interpret mode, its materializing oracle and its streamed twin, at the
reference's cases (``tests/test_x2y_executors.py``).  End to end:
``x2y_similarity`` and ``skew_join`` on every port executor against the
reference at its fp32 tolerance (rtol/atol 1e-5), bf16 tables at 2e-2, and
``PairwiseService.x2y`` with the reference's ``info``.  Also the repair of
index checks and gathers that followed every slot, masked or not.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.mapreduce as ref_mr
import repro_torch.mapreduce as port_mr
from repro.core import plan_a2a as ref_plan_a2a
from repro.core import plan_x2y as ref_plan_x2y
from repro.kernels.pairwise.fused_gather_gram import (
    fused_gather_gram_rect as jax_rect,
)
from repro.kernels.pairwise.fused_gather_gram import (
    fused_gather_gram_rect_ref as jax_rect_ref,
)
from repro.kernels.pairwise.fused_gather_gram import (
    fused_gather_gram_rect_streamed as jax_rect_streamed,
)
from repro.mapreduce.allpairs import _block_fn as ref_block_fn
from repro.mapreduce.allpairs import (
    _pair_source_map_rect as ref_srcmap_rect,
)
from repro.serve import PairwiseService as RefService
from repro_torch.core import plan_x2y
from repro_torch.kernels.pairwise.fused_gather_gram import (
    fused_gather_gram_rect,
    fused_gather_gram_rect_ref,
)
from repro_torch.mapreduce import engine as port_engine
from repro_torch.mapreduce.allpairs import (
    _block_fn,
    _block_fn_x2y,
    _x2y_plan_for,
)
from repro_torch.mapreduce.assembly import _pair_source_map_rect
from repro_torch.mapreduce.skewjoin import join_block
from repro_torch.serve import PairwiseService

TOL = dict(rtol=1e-5, atol=1e-5)
EXECUTORS = ["dense", "bucketed", "fused"]
METRICS = ["dot", "l2", "cosine"]


def _profiles(seed=0):
    """The reference's X2Y benchmark profiles (``benchmarks/bench_x2y.py``
    ``_cases``) at test size, plus the unit-size case."""
    rng = np.random.default_rng(seed)
    return {
        "balanced": (rng.uniform(0.05, 0.45, 30), rng.uniform(0.05, 0.45, 30)),
        "skew_join": (rng.uniform(0.01, 0.1, 200), rng.uniform(0.2, 0.45, 8)),
        "tiny_y": (rng.uniform(0.05, 0.3, 60), rng.uniform(0.3, 0.5, 3)),
        "uniform": (np.full(50, 0.2), np.full(20, 0.25)),
    }


# ------------------------------------------------------------------ plans
@pytest.mark.parametrize("kind", ["balanced", "skew_join", "tiny_y",
                                  "uniform"])
def test_x2y_plan_and_source_map_byte_equal(kind):
    wx, wy = _profiles()[kind]
    ref = ref_mr.build_x2y_plan(ref_plan_x2y(wx, wy, 1.0), len(wx))
    port = port_mr.build_x2y_plan(plan_x2y(wx, wy, 1.0), len(wx))
    for f in ("idx", "mask", "yidx", "ymask"):
        a, b = getattr(port, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    for f in ("num_reducers", "comm_cost", "max_inputs", "max_y_inputs",
              "num_x", "num_y", "algorithm", "lower_bound"):
        assert getattr(port, f) == getattr(ref, f), f
    assert len(port.buckets) == len(ref.buckets)
    for pb, rb in zip(port.buckets, ref.buckets):
        assert (pb.width, pb.ywidth) == (rb.width, rb.ywidth)
        for f in ("rows", "idx", "mask", "yidx", "ymask"):
            a, b = getattr(pb, f), getattr(rb, f)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    assert port.dense_padded_elements == ref.dense_padded_elements
    assert port.bucketed_padded_elements == ref.bucketed_padded_elements
    np.testing.assert_array_equal(
        _pair_source_map_rect(port, len(wx), len(wy)),
        ref_srcmap_rect(ref, len(wx), len(wy)))


def test_x2y_plan_arrays_padding_matches_reference():
    xs = [[0, 3, 4], [1], [2, 5, 6, 7, 8]]
    ys = [[1, 2], [0, 1, 2, 3], [4]]
    kw = dict(num_x=9, num_y=5, pad_reducers_to=4, pad_slots_to=8,
              max_buckets=2)
    ref = ref_mr.engine.build_x2y_plan_arrays(xs, ys, **kw)
    port = port_mr.build_x2y_plan_arrays(xs, ys, **kw)
    assert port.idx.tobytes() == ref.idx.tobytes()
    assert port.yidx.tobytes() == ref.yidx.tobytes()
    for pb, rb in zip(port.buckets, ref.buckets, strict=True):
        assert pb.rows.tobytes() == rb.rows.tobytes()
        assert pb.ymask.tobytes() == rb.ymask.tobytes()
    rebuilt = port_engine.plan_from_arrays(dataclasses.asdict(ref))
    assert rebuilt.is_rect and rebuilt.yidx.tobytes() == ref.yidx.tobytes()


def test_rect_source_map_refuses_int32_overflow():
    R, Lx, Ly = 2049, 1024, 1024            # 2049 * 1024**2 > 2**31 entries
    b = port_mr.ReducerBucket(
        width=Lx, rows=np.arange(R), idx=np.zeros((R, Lx), np.int32),
        mask=np.zeros((R, Lx), bool), ywidth=Ly,
        yidx=np.zeros((R, Ly), np.int32), ymask=np.zeros((R, Ly), bool))
    plan = port_mr.ReducerPlan(idx=b.idx, mask=b.mask, num_reducers=R,
                               comm_cost=0.0, max_inputs=Lx, buckets=(b,),
                               yidx=b.yidx, ymask=b.ymask, max_y_inputs=Ly)
    with pytest.raises(OverflowError):
        _pair_source_map_rect(plan, 4, 4)


# ------------------------------------------------------------------ kernel
def _rect_case(R, Lx, Ly, mx, my, d, seed, tail_masks=True):
    """The reference's ``_rect_case`` inputs, as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(mx, d)).astype(np.float32)
    y = rng.normal(size=(my, d)).astype(np.float32)
    xidx = rng.integers(0, mx, size=(R, Lx)).astype(np.int32)
    yidx = rng.integers(0, my, size=(R, Ly)).astype(np.int32)
    if tail_masks:
        xmask = np.arange(Lx)[None, :] < rng.integers(1, Lx + 1, size=(R, 1))
        ymask = np.arange(Ly)[None, :] < rng.integers(1, Ly + 1, size=(R, 1))
    else:
        xmask = np.ones((R, Lx), bool)
        ymask = np.ones((R, Ly), bool)
    return x, y, xidx, xmask, yidx, ymask


def _port_rect(args, dtype=torch.float32):
    x, y, *rest = (torch.from_numpy(a) for a in args)
    return fused_gather_gram_rect(x.to(dtype), y.to(dtype), *rest)


@pytest.mark.parametrize("R,Lx,Ly,bl", [
    (3, 8, 8, 8),              # single tile per side
    (5, 19, 11, 8),            # multi-tile, masked tails, |X| != |Y|
    (4, 9, 9, 8),              # square through the rect path
    (2, 7, 23, 8),             # non-pow2, Y side much wider
    (6, 39, 2, 16),            # the skew join's widest bucket shape
])
def test_rect_plain_matches_pallas_interpret_ref_and_streamed(R, Lx, Ly, bl):
    args = _rect_case(R, Lx, Ly, mx=31, my=17, d=6, seed=R + Lx)
    jargs = [jnp.asarray(a) for a in args]
    got = _port_rect(args).numpy()
    assert got.shape == (R, Lx, Ly)
    for want in (jax_rect(*jargs, bl=bl, interpret=True),
                 jax_rect_ref(*jargs), jax_rect_streamed(*jargs, bl=bl)):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_rect_bf16_tables_accumulate_fp32():
    args = _rect_case(4, 12, 7, mx=20, my=15, d=8, seed=0)
    jargs = [jnp.asarray(a) for a in args]
    want = jax_rect(jargs[0].astype(jnp.bfloat16),
                    jargs[1].astype(jnp.bfloat16), *jargs[2:], bl=8,
                    interpret=True)
    got = _port_rect(args, torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2,
                               atol=2e-2)


def test_rect_all_masked_rows_are_zero_and_masked_indices_unread():
    x, y, xidx, _, yidx, ymask = _rect_case(3, 5, 4, mx=9, my=9, d=3,
                                            seed=2, tail_masks=False)
    xmask = np.zeros((3, 5), bool)
    xmask[1, :2] = True
    xidx[~xmask] = 10 ** 6                     # masked: must never be read
    got = _port_rect((x, y, xidx, xmask, yidx, ymask)).numpy()
    assert np.abs(got[[0, 2]]).max() == 0.0 and np.abs(got[1, 2:]).max() == 0
    xidx[~xmask] = 0
    want = jax_rect(*(jnp.asarray(a) for a in
                      (x, y, xidx, xmask, yidx, ymask)), bl=8,
                    interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("Lx,Ly", [(4, 4), (1, 9)])
def test_rect_zero_reducers(Lx, Ly):
    x = torch.ones((5, 3))
    e = torch.zeros((0, Lx), dtype=torch.int32)
    got = fused_gather_gram_rect(x, x, e, e.bool(),
                                 torch.zeros((0, Ly), dtype=torch.int32),
                                 torch.zeros((0, Ly), dtype=torch.bool))
    assert got.shape == (0, Lx, Ly) and got.dtype == torch.float32


def test_rect_wrapper_rejects_mismatched_shapes():
    x = torch.ones((5, 3))
    i = torch.zeros((2, 2), dtype=torch.int32)
    m = torch.ones((2, 2), dtype=torch.bool)
    with pytest.raises(ValueError):
        fused_gather_gram_rect(x, torch.ones((5, 4)), i, m, i, m)
    with pytest.raises(ValueError):
        fused_gather_gram_rect(x, x, i, m, i[:1], m[:1])
    assert torch.equal(fused_gather_gram_rect(x, x, i, m, i, m),
                       fused_gather_gram_rect_ref(x, x, i, m, i, m))


# ------------------------------------------------------------ end to end
def _xy(seed, mx, my, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(mx, d)).astype(np.float32),
            rng.normal(size=(my, d)).astype(np.float32),
            rng.integers(1, 4, size=mx).astype(float),
            rng.integers(1, 3, size=my).astype(float))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("executor", EXECUTORS)
def test_x2y_similarity_matches_reference(executor, metric):
    x, y, wx, wy = _xy(3, 13, 9, 5)
    q = float(wx.max() + wy.max() + 1)
    ref, ref_plan, _ = ref_mr.x2y_similarity(
        jnp.asarray(x), jnp.asarray(y), q=q, wx=wx, wy=wy, metric=metric,
        executor=executor)
    got, plan, _ = port_mr.x2y_similarity(x, y, q=q, wx=wx, wy=wy,
                                          metric=metric, executor=executor,
                                          device="cpu")
    assert got.shape == (13, 9) and plan.algorithm == ref_plan.algorithm
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("kind", ["skew_join", "tiny_y"])
@pytest.mark.parametrize("executor", EXECUTORS)
def test_x2y_bench_profiles_match_reference(executor, kind):
    wx, wy = _profiles(1)[kind]
    rng = np.random.default_rng(2)
    x = rng.normal(size=(len(wx), 7)).astype(np.float32)
    y = rng.normal(size=(len(wy), 7)).astype(np.float32)
    ref, _, _ = ref_mr.x2y_similarity(jnp.asarray(x), jnp.asarray(y), q=1.0,
                                      wx=wx, wy=wy, metric="cosine",
                                      executor=executor)
    got, _, _ = port_mr.x2y_similarity(x, y, q=1.0, wx=wx, wy=wy,
                                       metric="cosine", executor=executor,
                                       device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("mx,my", [(1, 7), (8, 1), (1, 1), (17, 4)])
@pytest.mark.parametrize("executor", EXECUTORS)
def test_x2y_edge_sizes_match_reference(executor, mx, my):
    x, y, wx, wy = _xy(mx * 10 + my, mx, my, 4)
    ref, _, schema = ref_mr.x2y_similarity(
        jnp.asarray(x), jnp.asarray(y), q=6.0, wx=wx, wy=wy,
        metric="l2", executor=executor)
    got, _, _ = port_mr.x2y_similarity(x, y, q=6.0, wx=wx, wy=wy,
                                       metric="l2", executor=executor,
                                       device="cpu")
    assert got.shape == (mx, my)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    direct = ((x[:, None, :] - y[None, :, :]) ** 2).sum(-1)
    np.testing.assert_allclose(got.numpy(), direct, rtol=1e-4, atol=1e-4)


def test_x2y_square_degenerate_case_matches_allpairs():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(10, 4)).astype(np.float32)
    sq, _, _ = port_mr.pairwise_similarity(x, q=4.0, executor="bucketed",
                                           device="cpu")
    for executor in EXECUTORS:
        rect, _, _ = port_mr.x2y_similarity(x, x, q=8.0, executor=executor,
                                            device="cpu")
        off = ~np.eye(10, dtype=bool)
        np.testing.assert_allclose(rect.numpy()[off], sq.numpy()[off], **TOL)


def test_x2y_bf16_tables_match_reference():
    x, y, wx, wy = _xy(8, 21, 11, 16)
    ref, _, schema = ref_mr.x2y_similarity(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16), q=6.0,
        wx=wx, wy=wy, executor="fused")
    got, _, _ = port_mr.x2y_similarity(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(y).bfloat16(),
        q=6.0, wx=wx, wy=wy, executor="fused", device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_fused_x2y_counts_and_reconciles():
    x, y, wx, wy = _xy(4, 11, 6, 4)
    ex = port_mr.make_executor("fused")
    got, plan, schema = port_mr.x2y_similarity(
        x, y, q=6.0, wx=wx, wy=wy, executor=ex, device="cpu")
    assert ex.stats() == {"calls": 1, "kernel": 0, "streamed": 1,
                          "fallbacks": 0}
    want, _, _ = port_mr.x2y_similarity(x, y, q=6.0, schema=schema,
                                        executor="dense", device="cpu")
    torch.testing.assert_close(got, want, **TOL)


# -------------------------------------------------------------- skew join
def _example3():
    """The reference's Example-3 heavy hitter (200 X : 8 Y, scaled)."""
    rng = np.random.default_rng(42)
    mx, my = 40, 8
    xv = rng.normal(size=(mx, 3)).astype(np.float32)
    yv = rng.normal(size=(my, 2)).astype(np.float32)
    wx = rng.uniform(0.01, 0.1, mx)
    wx[0] = 2.0                        # the heavy hitter
    wy = rng.uniform(0.01, 0.5, my)
    return xv, yv, wx, wy, 4.0


@pytest.mark.parametrize("executor", EXECUTORS)
def test_skew_join_matches_reference(executor):
    xv, yv, wx, wy, q = _example3()
    ref, _ = ref_mr.skew_join(jnp.asarray(xv), jnp.asarray(yv), q=q, wx=wx,
                              wy=wy, executor="dense")
    out, schema = port_mr.skew_join(xv, yv, q=q, wx=wx, wy=wy,
                                    executor=executor, device="cpu")
    assert out.shape == (40, 8, 5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert port_mr.join is port_mr.skew_join


def test_skew_join_fused_fallback_is_counted():
    xv, yv, wx, wy, q = _example3()
    plan = _x2y_plan_for(plan_x2y(wx, wy, q), len(wx), pad_reducers_to=1,
                         pad_slots_to=1)
    ex = port_mr.make_executor("fused")
    out = ex.run_x2y((torch.from_numpy(xv), torch.from_numpy(yv)), plan,
                     join_block, (len(wx), len(wy)), device="cpu")
    assert ex.stats()["fallbacks"] == 1 and ex.stats()["streamed"] == 0
    dense = port_mr.make_executor("dense").run_x2y(
        (xv, yv), plan, join_block, (len(wx), len(wy)), device="cpu")
    torch.testing.assert_close(out, dense)


def test_x2y_runners_dense_combine_matches_reference():
    x, y, wx, wy = _xy(9, 14, 10, 3)
    schema = ref_plan_x2y(wx, wy, 6.0)
    ref_plan = ref_mr.build_x2y_plan(schema, 14)
    plan = port_engine.plan_from_arrays(dataclasses.asdict(ref_plan))
    ref = np.asarray(ref_mr.run_reducers_x2y_bucketed(
        (jnp.asarray(x), jnp.asarray(y)), ref_plan,
        ref_mr.skewjoin.join_block))
    for run in (port_mr.run_reducers_x2y, port_mr.run_reducers_x2y_bucketed):
        got = run((x, y), plan, join_block, device="cpu")
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, **TOL)


# ----------------------------------------------------------------- repair
def _plan_with_junk_in_masked_slots():
    """A ``plan_a2a`` plan over 12 inputs whose masked-out slots hold index
    999 — anything may sit there, since masked slots are never gathered."""
    w = np.random.default_rng(1).uniform(0.1, 0.3, 12)
    ref = ref_mr.build_plan(ref_plan_a2a(w, 1.0))
    ref.idx[~ref.mask] = 999
    for b in ref.buckets:
        b.idx[~b.mask] = 999
    assert (~ref.mask).any()
    return ref, port_engine.plan_from_arrays(dataclasses.asdict(ref))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("executor", EXECUTORS)
def test_masked_slots_may_hold_out_of_range_indices(executor, metric):
    ref_plan, plan = _plan_with_junk_in_masked_slots()
    x = np.random.default_rng(2).normal(size=(12, 5)).astype(np.float32)
    ref = ref_mr.get_executor(executor).run_pairs(
        jnp.asarray(x), ref_plan, ref_block_fn(metric, False), 12)
    got = port_mr.make_executor(executor).run_pairs(
        x, plan, _block_fn(metric, False), 12, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("executor", EXECUTORS)
def test_rect_index_checks_follow_the_mask_per_side(executor):
    xv, yv, wx, wy, q = _example3()
    ref_plan = ref_mr.build_x2y_plan(ref_plan_x2y(wx, wy, q), len(wx))
    for b in ref_plan.buckets:
        b.idx[~b.mask] = 999
        b.yidx[~b.ymask] = 999
    ref_plan.idx[~ref_plan.mask] = 999
    ref_plan.yidx[~ref_plan.ymask] = 999
    plan = port_engine.plan_from_arrays(dataclasses.asdict(ref_plan))
    fn = _block_fn_x2y("dot")
    ex = port_mr.make_executor(executor)
    xs, ys = np.ones((40, 2), np.float32), np.ones((8, 2), np.float32)
    got = ex.run_x2y((xs, ys), plan, fn, (40, 8), device="cpu")
    np.testing.assert_allclose(got.numpy(), 2.0)
    # a VALID Y slot past the 7-row Y table is refused on the host, and the
    # check names the Y side although the X table has rows to spare
    with pytest.raises(IndexError, match="Y-side rows 0..7 from a table of "
                                         "7 rows"):
        port_mr.make_executor(executor).run_x2y(
            (xs, ys[:7]), plan, fn, (40, 7), device="cpu")


# ---------------------------------------------------------------- service
@pytest.mark.parametrize("executor", EXECUTORS)
def test_service_x2y_matches_reference(executor):
    ref_svc = RefService(q=1.0, executor=executor, metric="cosine")
    svc = PairwiseService(q=1.0, executor=executor, metric="cosine",
                          device="cpu")
    skip = {"wall_s", "jit_cache"}
    wx, wy = _profiles(3)["skew_join"]
    rng = np.random.default_rng(4)
    x = rng.normal(size=(len(wx), 6)).astype(np.float32)
    y = rng.normal(size=(len(wy), 6)).astype(np.float32)
    for _ in range(2):
        ref, ref_info = ref_svc.x2y(x, y, wx, wy)
        got, info = svc.x2y(x, y, wx, wy)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
        assert set(info) == set(ref_info)
        assert {k: v for k, v in info.items() if k not in skip} == \
            {k: v for k, v in ref_info.items() if k not in skip}
        assert info["comm"]["measured_over_predicted"] == 1.0
        assert not info["plan_cache_hit"]           # plan_x2y is not cached
    assert svc.stats["requests"] == 2
    if executor == "fused":
        assert info["fused_path"] == "streamed"     # plain version on CPU
