"""The port's coded executor and its host models against the JAX package,
on the CPU.

Host arrays first, exactly equal to the reference's on its tests' profiles
(uniform, zipf, one-giant; m=48) at S in {1, 2, 3, 8} and r in {1, 2, 3}:
the replica-stacked groups, ``_coded_maps``' send map, source map and
stats, ``coded_assembly_model`` and ``choose_replication``'s r and
frontier.  Then execution in one process (one shard, where r clamps to 1):
``run_pairs`` and ``run_x2y`` match the reference's coded executor at 1e-5
for dot, l2 and cosine, with its degenerate cases, stats and service
``info``.  Last, 8 gloo ranks spawned once for this file (120 s timeout):
every rank's matrix equals the reference's dense executor's at 1e-4 (as
``tests/test_coded_executor.py::test_coded_differential_on_8_device_mesh``),
and the r=2 ledger reads ``measured_over_predicted == 2.0`` with assembly
bytes equal to ``coded_assembly_model`` and to the bytes of the
all-to-all's tensor, the counterpart of ``tests/test_obs.py::
test_coded_r2_reconciles_against_model_on_8_device_mesh``.
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
from repro.serve import PairwiseService as RefService
from repro_torch.compat import run_local_group
from repro_torch.core import partition_plan, plan_a2a, plan_x2y
from repro_torch.serve import PairwiseService

import _torch_ranks

TIGHT = dict(rtol=1e-5, atol=1e-5)
REF_TOL = dict(rtol=1e-4, atol=1e-4)
KINDS = ["uniform", "zipf", "one-giant"]
METRICS = ["dot", "l2", "cosine"]
# (shards, replication): S in {1, 2, 3, 8}, r in {1, 2, 3}, r <= S
RATES = [(1, 1), (2, 1), (2, 2), (3, 2), (3, 3), (8, 1), (8, 2), (8, 3)]


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


def _assert_maps_equal(got, want):
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[2] == want[2]


# ------------------------------------------------------------- host arrays
@pytest.mark.parametrize("num_shards,r", RATES)
@pytest.mark.parametrize("kind", KINDS)
def test_coded_maps_and_model_equal_reference(kind, num_shards, r):
    ref_plan, plan = _plans(kind)
    ref_part = ref_partition(ref_plan, num_shards, replication=r)
    part = partition_plan(plan, num_shards, replication=r)
    ref_groups = [(i, k, i, k, rows) for i, k, rows in ref_ex._stacked_groups(
        ref_plan, ref_part, rows_by_shard=ref_part.replica_rows)]
    groups = [(i, k, i, k, rows) for i, k, rows in port_ex._stacked_groups(
        plan, part, rows_by_shard=part.replica_rows)]
    for g, w in zip(groups, ref_groups):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    rb = -(-48 // num_shards)
    _assert_maps_equal(port_ex._coded_maps(groups, (48, 48), rb, True),
                       ref_ex._coded_maps(ref_groups, (48, 48), rb, True))
    assert port_mr.coded_assembly_model(plan, num_shards, r, 48) == \
        ref_ex.coded_assembly_model(ref_plan, num_shards, r, 48)


@pytest.mark.parametrize("num_shards,r", [(2, 2), (3, 2), (8, 3)])
def test_rect_coded_maps_equal_reference(num_shards, r):
    wx, wy, _x, _y = _x2y_case()
    ref_plan = ref_mr.build_x2y_plan(ref_plan_x2y(wx, wy, 1.0), len(wx))
    plan = port_mr.build_x2y_plan(plan_x2y(wx, wy, 1.0), len(wx))
    ref_part = ref_partition(ref_plan, num_shards, replication=r)
    part = partition_plan(plan, num_shards, replication=r)
    ref_groups = ref_ex._stacked_rect_groups(
        ref_plan, ref_part, rows_by_shard=ref_part.replica_rows)
    groups = port_ex._stacked_rect_groups(plan, part,
                                          rows_by_shard=part.replica_rows)
    rb = -(-21 // num_shards)
    _assert_maps_equal(port_ex._coded_maps(groups, (21, 17), rb, False),
                       ref_ex._coded_maps(ref_groups, (21, 17), rb, False))


@pytest.mark.parametrize("kind", KINDS)
def test_choose_replication_equals_reference(kind):
    ref_plan, plan = _plans(kind)
    assert port_mr.choose_replication(plan, 8, 48, 16) == \
        ref_ex.choose_replication(ref_plan, 8, 48, 16)


# ------------------------------------------------------ in-process (1 shard)
@pytest.mark.parametrize("kind", KINDS)
def test_run_pairs_matches_reference(kind):
    m = 29
    w = _weights(kind, m, seed=m)
    x = _table(m, m, 6)
    ref, _, _ = ref_mr.pairwise_similarity(jnp.asarray(x), q=1.0, weights=w,
                                           executor="coded")
    got, _, _ = port_mr.pairwise_similarity(x, q=1.0, weights=w,
                                            executor="coded", device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TIGHT)


@pytest.mark.parametrize("metric", METRICS)
def test_metrics_match_reference(metric):
    m = 26
    w = _weights("zipf", m, seed=7)
    x = _table(7, m, 8)
    ref, _, _ = ref_mr.pairwise_similarity(jnp.asarray(x), q=1.0, weights=w,
                                           metric=metric, executor="coded")
    got, _, _ = port_mr.pairwise_similarity(x, q=1.0, weights=w,
                                            metric=metric, executor="coded",
                                            device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TIGHT)


@pytest.mark.parametrize("metric", METRICS)
def test_run_x2y_matches_reference(metric):
    wx, wy, x, y = _x2y_case()
    ref, _, _ = ref_mr.x2y_similarity(jnp.asarray(x), jnp.asarray(y), q=1.0,
                                      wx=wx, wy=wy, metric=metric,
                                      executor="coded")
    got, _, _ = port_mr.x2y_similarity(x, y, q=1.0, wx=wx, wy=wy,
                                       metric=metric, executor="coded",
                                       device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TIGHT)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("workload", ["pairs", "x2y"])
def test_launches_finish_in_the_kernels_wrapper(workload, metric):
    """Coded A2A (one table as both sides) and X2Y: the rect kernel's
    wrapper finishes (``_torch_ranks.assert_one_rect_finish_path``)."""
    if workload == "pairs":
        x = y = _table(7, 26, 8)
        w = _weights("zipf", 26, seed=7)
        run = lambda: port_mr.pairwise_similarity(          # noqa: E731
            x, q=1.0, weights=w, metric=metric, executor="coded",
            device="cpu")[0]
    else:
        wx, wy, x, y = _x2y_case()
        run = lambda: port_mr.x2y_similarity(               # noqa: E731
            x, y, q=1.0, wx=wx, wy=wy, metric=metric, executor="coded",
            device="cpu")[0]
    _torch_ranks.assert_one_rect_finish_path(
        run, metric, torch.from_numpy(x), torch.from_numpy(y))


def test_single_input_degenerate():
    x = np.ones((1, 4), np.float32)
    got, _, _ = port_mr.pairwise_similarity(x, q=1.0, weights=[0.3],
                                            executor="coded", device="cpu")
    ref, _, _ = ref_mr.pairwise_similarity(jnp.asarray(x), q=1.0,
                                           weights=[0.3], executor="coded")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_non_gram_reducer_falls_back():
    m = 17
    w = _weights("zipf", m, seed=3)
    plan = port_mr.build_plan(plan_a2a(w, 1.0))
    x = torch.from_numpy(_table(5, m, 4))

    def colsum(blk, msk):
        return torch.sum(blk * msk[:, None], dim=0)

    ex = port_mr.make_executor("coded")
    got = ex.run(x, plan, colsum, device="cpu")
    want = port_mr.run_reducers_bucketed(x, plan, colsum, device="cpu")
    torch.testing.assert_close(got, want, **TIGHT)
    assert ex.stats()["fallbacks"] == 1


def test_stats_match_reference():
    m = 19
    w = _weights("uniform", m, seed=2)
    x = _table(2, m, 4)
    ref_ex_ = ref_mr.make_executor("coded")
    ex = port_mr.make_executor("coded", replication=2)
    assert ex.stats() == ref_ex_.stats() and ex.replication == 2
    ref_mr.pairwise_similarity(jnp.asarray(x), q=1.0, weights=w,
                               executor=ref_ex_)
    port_mr.pairwise_similarity(x, q=1.0, weights=w, executor=ex,
                                device="cpu")
    assert ex.stats() == ref_ex_.stats()
    assert ex.stats()["replication"] == 1          # clamped to 1 shard


def test_service_info_matches_reference():
    m = 19
    w = _weights("zipf", m, seed=4)
    x = _table(4, m, 4)
    ref_sims, ref_info = RefService(q=1.0, executor="coded").similarity(
        jnp.asarray(x), w)
    sims, info = PairwiseService(q=1.0, executor="coded",
                                 device="cpu").similarity(x, w)
    np.testing.assert_allclose(sims.numpy(), np.asarray(ref_sims), **TIGHT)
    assert set(info) == set(ref_info)
    assert info["coded"] == ref_info["coded"]
    assert info["sharded"] == ref_info["sharded"]
    assert info["comm"] == ref_info["comm"]


# --------------------------------------------------- 8 gloo ranks, spawned
M8 = 48


@pytest.fixture(scope="module")
def eight_ranks():
    """One spawn of 8 gloo ranks for the whole file: coded (r=2) A2A on
    each profile and coded X2Y, every rank's results."""
    rng = np.random.default_rng(0)
    cases = {kind: (_weights(kind, M8, seed=k),
                    rng.normal(size=(M8, 6)).astype(np.float32))
             for k, kind in enumerate(KINDS)}
    x2y = _x2y_case()
    results = run_local_group(_torch_ranks.cpu_paths, 8, "coded", cases,
                              x2y, timeout_s=120.0)
    return cases, x2y, results


@pytest.mark.parametrize("kind", KINDS)
def test_eight_ranks_match_reference(eight_ranks, kind):
    cases, _, results = eight_ranks
    w, x = cases[kind]
    dense, _, _ = ref_mr.pairwise_similarity(jnp.asarray(x), q=1.0,
                                             weights=w, executor="dense")
    for rank, res in enumerate(results):
        np.testing.assert_allclose(res["pairs"][kind]["sims"],
                                   np.asarray(dense), **REF_TOL,
                                   err_msg=f"rank {rank}")
        st = res["pairs"][kind]["stats"]
        assert st["num_shards"] == 8 and st["replication"] == 2, st
        assert st["coded"] == 1 and 0.0 <= st["local_fraction"] <= 1.0


@pytest.mark.parametrize("kind", KINDS)
def test_eight_ranks_r2_ledger_equals_model_and_all_to_all(eight_ranks,
                                                           kind):
    cases, _, results = eight_ranks
    w, _x = cases[kind]
    ref_model = ref_ex.coded_assembly_model(
        ref_mr.build_plan(ref_plan_a2a(w, 1.0)), 8, 2, M8)
    model = port_mr.coded_assembly_model(port_mr.build_plan(plan_a2a(w, 1.0)),
                                         8, 2, M8)
    assert model == ref_model
    want = model["assembly_bytes_per_shard"]
    for res in results:
        led = res["pairs"][kind]["ledger"]
        assert led["measured_over_predicted"] == 2.0, led
        assert led["replication"] == 2.0 and not led["anomaly"], led
        assert led["assembly_bytes_per_shard"] == want, (led, want)
        assert led["assembled_bytes"] == 8 * want
        # the bytes the one all-to-all moved, under the ring accounting
        assert int(led["all_to_all_bytes"] * ((8 - 1) / 8)) == want, led
    assert res["pairs"][kind]["stats"]["residual_entries"] == \
        model["residual_entries"]


def test_eight_ranks_service_reports_coded(eight_ranks):
    """``PairwiseService(executor='coded', mesh=group)`` on every rank."""
    _, (wx, wy, x, y), results = eight_ranks
    ref, _, _ = ref_mr.x2y_similarity(jnp.asarray(x), jnp.asarray(y), q=1.0,
                                      wx=wx, wy=wy, executor="dense")
    for res in results:
        np.testing.assert_allclose(res["service"]["sims"], np.asarray(ref),
                                   **REF_TOL)
        assert res["service"]["sharded"]["num_shards"] == 8
        assert res["service"]["coded"]["replication"] == 2


def test_eight_ranks_x2y_match_reference(eight_ranks):
    _, (wx, wy, x, y), results = eight_ranks
    ref, _, _ = ref_mr.x2y_similarity(jnp.asarray(x), jnp.asarray(y), q=1.0,
                                      wx=wx, wy=wy, executor="dense")
    for rank, res in enumerate(results):
        np.testing.assert_allclose(res["x2y"]["sims"], np.asarray(ref),
                                   **REF_TOL, err_msg=f"rank {rank}")
        assert res["x2y"]["stats"]["num_shards"] == 8
