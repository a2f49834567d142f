"""The port's sharded executor against the JAX package, on the CPU.

Host arrays first: the stacked per-width groups and both source maps equal
the reference's exactly, on the reference tests' profiles (uniform, zipf,
one-giant; m=48) at 1, 2, 3 and 8 shards.  Then execution in one process
(one shard, as the reference's in-process tests run on one device):
``run_pairs``, ``run_x2y`` and ``run(combine="dense")`` match the
reference's sharded executor at 1e-5 for the dot, l2 and cosine metrics,
with the reference's degenerate cases, stats dicts and service ``info``.
Last, 8 gloo ranks spawned once for this file (``repro_torch.compat.
run_local_group``, 120 s timeout): every rank's matrix equals the
reference's dense executor's at the reference's 1e-4, as
``tests/test_sharded_executor.py::test_sharded_differential_on_8_device_
mesh`` holds its 8-device mesh, and every rank reports 8 shards.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.mapreduce as ref_mr
import repro.mapreduce.executors as ref_ex
import repro_torch.mapreduce as port_mr
import repro_torch.mapreduce.executors as port_ex
from repro.core import partition_plan as ref_partition
from repro.core import plan_a2a as ref_plan_a2a
from repro.core import plan_x2y as ref_plan_x2y
from repro.mapreduce.allpairs import _block_fn as ref_block_fn
from repro.serve import PairwiseService as RefService
from repro_torch.compat import run_local_group
from repro_torch.core import partition_plan, plan_a2a, plan_x2y
from repro_torch.mapreduce.allpairs import _block_fn
from repro_torch.serve import PairwiseService

import _torch_ranks

TIGHT = dict(rtol=1e-5, atol=1e-5)
REF_TOL = dict(rtol=1e-4, atol=1e-4)
KINDS = ["uniform", "zipf", "one-giant"]
METRICS = ["dot", "l2", "cosine"]
SHARDS = [1, 2, 3, 8]


def _weights(kind: str, m: int, seed: int, q: float = 1.0):
    rng = np.random.default_rng(seed)
    return {
        "uniform": lambda: rng.uniform(0.05, 0.33, m),
        "zipf": lambda: np.clip(rng.zipf(1.7, m) / 24.0, 0.02, 0.45 * q),
        "one-giant": lambda: np.concatenate(
            [[0.8 * q], rng.uniform(0.02, 0.1, m - 1)]),
    }[kind]()


def _table(seed, m, d):
    return np.random.default_rng(seed).normal(size=(m, d)).astype(np.float32)


def _plans(kind, m=48, seed=48):
    w = _weights(kind, m, seed)
    return (ref_mr.build_plan(ref_plan_a2a(w, 1.0)),
            port_mr.build_plan(plan_a2a(w, 1.0)))


def _x2y_case(seed=11, nx=21, ny=17, d=5):
    rng = np.random.default_rng(seed)
    wx, wy = rng.uniform(0.05, 0.3, nx), rng.uniform(0.05, 0.3, ny)
    return wx, wy, _table(seed + 1, nx, d), _table(seed + 2, ny, d)


def _x2y_plans(seed=11):
    wx, wy, x, y = _x2y_case(seed)
    return (ref_mr.build_x2y_plan(ref_plan_x2y(wx, wy, 1.0), len(wx)),
            port_mr.build_x2y_plan(plan_x2y(wx, wy, 1.0), len(wx)))


def _assert_groups_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- host arrays
@pytest.mark.parametrize("num_shards", SHARDS)
@pytest.mark.parametrize("kind", KINDS)
def test_stacked_groups_and_srcmap_equal_reference(kind, num_shards):
    ref_plan, plan = _plans(kind)
    ref_groups = ref_ex._stacked_groups(ref_plan,
                                        ref_partition(ref_plan, num_shards))
    groups = port_ex._stacked_groups(plan, partition_plan(plan, num_shards))
    _assert_groups_equal(groups, ref_groups)
    want = ref_ex._sharded_srcmap(ref_groups, 48)
    got = port_ex._sharded_srcmap(groups, 48)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num_shards", SHARDS)
def test_stacked_rect_groups_and_srcmap_equal_reference(num_shards):
    ref_plan, plan = _x2y_plans()
    ref_groups = ref_ex._stacked_rect_groups(
        ref_plan, ref_partition(ref_plan, num_shards))
    groups = port_ex._stacked_rect_groups(plan,
                                          partition_plan(plan, num_shards))
    _assert_groups_equal(groups, ref_groups)
    np.testing.assert_array_equal(
        port_ex._sharded_rect_srcmap(groups, (21, 17)),
        ref_ex._sharded_rect_srcmap(ref_groups, (21, 17)))


def test_bucketless_plan_groups_equal_reference():
    """A plan without capacity buckets stacks from its dense rows."""
    idx = np.arange(6, dtype=np.int32).reshape(2, 3)
    mask = np.array([[True, True, False], [True, True, True]])
    ref_plan = ref_mr.ReducerPlan(idx=idx, mask=mask, num_reducers=2,
                                  comm_cost=5.0, max_inputs=3)
    plan = port_mr.ReducerPlan(idx=idx, mask=mask, num_reducers=2,
                               comm_cost=5.0, max_inputs=3)
    _assert_groups_equal(
        port_ex._stacked_groups(plan, partition_plan(plan, 2)),
        ref_ex._stacked_groups(ref_plan, ref_partition(ref_plan, 2)))


# ------------------------------------------------------ in-process (1 shard)
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("kind", KINDS)
def test_run_pairs_matches_reference(kind, metric):
    m = 29
    w = _weights(kind, m, seed=m)
    x = _table(m, m, 6)
    ref, ref_plan, _ = ref_mr.pairwise_similarity(
        jnp.asarray(x), q=1.0, weights=w, metric=metric, executor="sharded")
    ex = port_mr.make_executor("sharded")
    got, plan, _ = port_mr.pairwise_similarity(
        x, q=1.0, weights=w, metric=metric, executor=ex, device="cpu")
    np.testing.assert_array_equal(plan.idx, ref_plan.idx)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TIGHT)
    assert ex.stats() == {"calls": 1, "sharded": 1, "fallbacks": 0,
                          "num_shards": 1, "balance_factor": 1.0}


@pytest.mark.parametrize("metric", METRICS)
def test_run_x2y_matches_reference(metric):
    wx, wy, x, y = _x2y_case()
    ref, _, sch = ref_mr.x2y_similarity(
        jnp.asarray(x), jnp.asarray(y), q=1.0, wx=wx, wy=wy, metric=metric,
        executor="sharded")
    got, _, _ = port_mr.x2y_similarity(x, y, q=1.0, wx=wx, wy=wy,
                                       metric=metric, executor="sharded",
                                       device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TIGHT)


@pytest.mark.parametrize("metric", METRICS)
def test_run_x2y_finishes_in_the_kernels_wrapper(metric):
    wx, wy, x, y = _x2y_case()
    _torch_ranks.assert_one_rect_finish_path(
        lambda: port_mr.x2y_similarity(
            x, y, q=1.0, wx=wx, wy=wy, metric=metric, executor="sharded",
            device="cpu")[0],
        metric, torch.from_numpy(x), torch.from_numpy(y))


def test_dense_combine_run_matches_reference():
    m = 23
    w = _weights("zipf", m, seed=3)
    x = _table(5, m, 8)
    ref_plan = ref_mr.build_plan(ref_plan_a2a(w, 1.0))
    plan = port_mr.build_plan(plan_a2a(w, 1.0))
    ref = ref_mr.run_reducers_sharded(jnp.asarray(x), ref_plan,
                                      ref_block_fn("dot", False))
    got = port_mr.run_reducers_sharded(x, plan, _block_fn("dot", False),
                                       device="cpu")
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TIGHT)
    dense = port_mr.run_reducers(x, plan, _block_fn("dot", False),
                                 device="cpu")
    torch.testing.assert_close(got, dense, **TIGHT)


def test_some_pairs_matches_reference():
    m = 20
    rng = np.random.default_rng(13)
    w = rng.uniform(0.02, 0.3, m)
    pairs = [(0, 1), (2, 9), (5, 17), (3, 4), (11, 12)]
    x = rng.normal(size=(m, 8)).astype(np.float32)
    ref, _, _ = ref_mr.some_pairs_similarity(
        jnp.asarray(x), pairs, q=1.0, weights=w, executor="sharded")
    got, _, _ = port_mr.some_pairs_similarity(
        x, pairs, q=1.0, weights=w, executor="sharded", device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TIGHT)


def test_block_serving_matches_reference():
    """``run_block`` through the sharded executor's ``run_x2y``."""
    from repro.core import plan_a2a_hierarchical as ref_hier
    from repro_torch.core import plan_a2a_hierarchical
    rng = np.random.default_rng(3)
    m = 120
    x = rng.normal(size=(m, 8)).astype(np.float32)
    w = rng.uniform(0.4, 2.0, m)
    for i0, i1, j0, j1 in [(0, 40, 40, 100), (20, 90, 10, 70)]:
        ref, _, _ = ref_mr.pairwise_similarity_block(
            jnp.asarray(x), i0, i1, j0, j1, q=12.0,
            schema=ref_hier(w, 12.0, c=2, use_cache=False),
            executor="sharded")
        got, _, _ = port_mr.pairwise_similarity_block(
            x, i0, i1, j0, j1, q=12.0,
            schema=plan_a2a_hierarchical(w, 12.0, c=2, use_cache=False),
            executor="sharded", device="cpu")
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TIGHT)


@pytest.mark.parametrize("executor", ["sharded", "coded"])
def test_skew_join_falls_back_and_matches_reference(executor):
    """The join's reducer is no Gram block: both executors take their
    counted bucketed fallback, with the reference's output."""
    rng = np.random.default_rng(2)
    xv = rng.normal(size=(30, 3)).astype(np.float32)
    yv = rng.normal(size=(6, 2)).astype(np.float32)
    wx, wy = rng.uniform(0.01, 0.4, 30), rng.uniform(0.01, 0.5, 6)
    ref, _ = ref_mr.skew_join(jnp.asarray(xv), jnp.asarray(yv), q=4.0,
                              wx=wx, wy=wy, executor=executor)
    ex = port_mr.make_executor(executor)
    out, _ = port_mr.skew_join(xv, yv, q=4.0, wx=wx, wy=wy, executor=ex,
                               device="cpu")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TIGHT)
    assert ex.stats()["fallbacks"] == 1


def test_service_x2y_info_matches_reference():
    wx, wy, x, y = _x2y_case()
    ref, ref_info = RefService(q=1.0, executor="sharded").x2y(
        jnp.asarray(x), jnp.asarray(y), wx, wy)
    got, info = PairwiseService(q=1.0, executor="sharded",
                                device="cpu").x2y(x, y, wx, wy)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TIGHT)
    assert set(info) == set(ref_info)
    assert info["sharded"] == ref_info["sharded"]


def test_single_input_degenerate():
    x = np.ones((1, 4), np.float32)
    got, _, _ = port_mr.pairwise_similarity(x, q=1.0, weights=[0.3],
                                            executor="sharded", device="cpu")
    ref, _, _ = ref_mr.pairwise_similarity(jnp.asarray(x), q=1.0,
                                           weights=[0.3], executor="sharded")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_all_masked_bucket_falls_back():
    idx = np.zeros((2, 3), np.int32)
    mask = np.zeros((2, 3), bool)
    plan = port_mr.ReducerPlan(
        idx=idx, mask=mask, num_reducers=0, comm_cost=0.0, max_inputs=3,
        buckets=(port_mr.ReducerBucket(width=3,
                                       rows=np.full(2, -1, np.int64),
                                       idx=idx, mask=mask),))
    ex = port_mr.make_executor("sharded")
    out = ex.run(torch.ones((4, 5)), plan, _block_fn("dot", False),
                 device="cpu")
    assert ex.stats()["fallbacks"] == 1           # no real reducers
    assert out.shape == (2, 3, 3) and float(out.abs().max()) == 0.0


def test_non_gram_reducer_falls_back():
    m = 17
    w = _weights("zipf", m, seed=3)
    plan = port_mr.build_plan(plan_a2a(w, 1.0))
    x = torch.from_numpy(_table(5, m, 4))

    def colsum(blk, msk):
        return torch.sum(blk * msk[:, None], dim=0)

    ex = port_mr.make_executor("sharded")
    got = ex.run(x, plan, colsum, device="cpu")
    want = port_mr.run_reducers_bucketed(x, plan, colsum, device="cpu")
    torch.testing.assert_close(got, want, **TIGHT)
    assert ex.stats()["fallbacks"] == 1 and ex.stats()["calls"] == 1


def test_stats_keys_and_reset_match_reference():
    a, ref = port_mr.make_executor("sharded"), ref_mr.make_executor("sharded")
    assert a.stats() == ref.stats()
    a._count("calls")
    a.reset()
    assert a.stats()["calls"] == 0


def test_service_info_matches_reference():
    m = 19
    w = _weights("uniform", m, seed=2)
    x = _table(2, m, 4)
    ref_sims, ref_info = RefService(q=1.0, executor="sharded").similarity(
        jnp.asarray(x), w)
    sims, info = PairwiseService(q=1.0, executor="sharded",
                                 device="cpu").similarity(x, w)
    np.testing.assert_allclose(sims.numpy(), np.asarray(ref_sims), **TIGHT)
    assert set(info) == set(ref_info)
    assert info["sharded"] == ref_info["sharded"]
    assert info["comm"] == ref_info["comm"]
    assert info["fused_path"] is None


def test_shard_axes_and_foreign_meshes_are_refused():
    ex = port_mr.make_executor("sharded")
    plan = port_mr.build_plan(plan_a2a(np.full(6, 0.2), 1.0))
    with pytest.raises(ValueError, match="one axis"):
        ex.run(_table(0, 6, 3), plan, _block_fn("dot", False),
               shard_axes=("data",), device="cpu")
    with pytest.raises(TypeError, match="ProcessGroup"):
        port_mr.pairwise_similarity(_table(0, 6, 3), q=1.0,
                                    weights=np.full(6, 0.2), mesh=object(),
                                    executor="sharded", device="cpu")


def test_source_maps_refuse_int32_overflow():
    """Past 2**31 block entries the int32 source maps would wrap (they do
    in the reference); the port raises before building one.  The stacks
    here are zero-stride views, so nothing large is allocated."""
    class Plan:
        pass
    big = np.broadcast_to(np.int32(0), (4, 2 ** 22, 32))
    mask = np.broadcast_to(False, big.shape)
    rows = np.broadcast_to(np.int32(0), big.shape[:2])
    ex = port_mr.make_executor("sharded")
    with pytest.raises(OverflowError, match="int32"):
        ex._srcmap_for(Plan(), [(big, mask, rows)], 4, 8)
    with pytest.raises(OverflowError, match="int32"):
        ex._rect_srcmap_for(Plan(), [(big, mask, big, mask, rows)], 4, (8, 8))


@pytest.mark.parametrize("executor", ["dense", "bucketed", "fused"])
def test_mesh_on_other_executors_still_raises(executor):
    """These executors once refused every mesh; they now split reducer
    rows over a process group (``tests/test_torch_mesh.py``), and still
    raise on a mesh that is not one, before planning and at run time."""
    x = _table(0, 6, 3)
    with pytest.raises(TypeError, match="ProcessGroup"):
        port_mr.pairwise_similarity(x, q=1.0, weights=np.full(6, 0.2),
                                    mesh=object(), executor=executor,
                                    device="cpu")
    plan = port_mr.build_plan(plan_a2a(np.full(6, 0.2), 1.0))
    with pytest.raises(TypeError, match="ProcessGroup"):
        port_mr.make_executor(executor).run_pairs(
            x, plan, _block_fn("dot", False), 6, mesh=object(),
            device="cpu")


# --------------------------------------------------- 8 gloo ranks, spawned
M8 = 48


@pytest.fixture(scope="module")
def eight_ranks():
    """One spawn of 8 gloo ranks for the whole file: sharded A2A on each
    profile and sharded X2Y, every rank's results."""
    rng = np.random.default_rng(0)
    cases = {kind: (_weights(kind, M8, seed=k),
                    rng.normal(size=(M8, 6)).astype(np.float32))
             for k, kind in enumerate(KINDS)}
    x2y = _x2y_case()
    results = run_local_group(_torch_ranks.cpu_paths, 8, "sharded", cases,
                              x2y, timeout_s=120.0)
    return cases, x2y, results


@pytest.mark.parametrize("kind", KINDS)
def test_eight_ranks_match_reference(eight_ranks, kind):
    cases, _, results = eight_ranks
    w, x = cases[kind]
    dense, _, _ = ref_mr.pairwise_similarity(
        jnp.asarray(x), q=1.0, weights=w, executor="dense")
    for rank, res in enumerate(results):
        np.testing.assert_allclose(res["pairs"][kind]["sims"],
                                   np.asarray(dense), **REF_TOL,
                                   err_msg=f"rank {rank}")
        st = res["pairs"][kind]["stats"]
        assert st["num_shards"] == 8 and st["sharded"] == 1, st


def test_eight_ranks_x2y_match_reference(eight_ranks):
    _, (wx, wy, x, y), results = eight_ranks
    ref, _, _ = ref_mr.x2y_similarity(jnp.asarray(x), jnp.asarray(y), q=1.0,
                                      wx=wx, wy=wy, executor="dense")
    for rank, res in enumerate(results):
        np.testing.assert_allclose(res["x2y"]["sims"], np.asarray(ref),
                                   **REF_TOL, err_msg=f"rank {rank}")
        assert res["x2y"]["stats"]["num_shards"] == 8, res["x2y"]["stats"]


def test_eight_ranks_service_reports_eight_shards(eight_ranks):
    """``PairwiseService(mesh=group)`` on every rank: the reference's
    matrix and ``info["sharded"]`` with 8 shards."""
    _, (wx, wy, x, y), results = eight_ranks
    ref, _, _ = ref_mr.x2y_similarity(jnp.asarray(x), jnp.asarray(y), q=1.0,
                                      wx=wx, wy=wy, executor="dense")
    for res in results:
        np.testing.assert_allclose(res["service"]["sims"], np.asarray(ref),
                                   **REF_TOL)
        assert res["service"]["sharded"]["num_shards"] == 8
        assert "coded" not in res["service"]


def test_a_failing_rank_fails_the_group():
    """A rank that raises makes ``run_local_group`` raise with its
    traceback, although the other rank reported a result."""
    with pytest.raises(RuntimeError, match="rank one gives up"):
        run_local_group(_torch_ranks.fail_on_rank_one, 2, timeout_s=30.0)


def test_eight_ranks_balance_equals_reference_partition(eight_ranks):
    """Every rank ran the same LPT partition the reference computes."""
    cases, _, results = eight_ranks
    for kind, (w, _x) in cases.items():
        part = ref_partition(ref_mr.build_plan(ref_plan_a2a(w, 1.0)), 8)
        for res in results:
            assert res["pairs"][kind]["stats"]["balance_factor"] \
                == float(part.balance_factor)
