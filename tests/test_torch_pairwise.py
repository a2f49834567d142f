"""The port's all-pairs path against the JAX package, on the CPU.

``pairwise_similarity`` on every ported executor and metric, over three
weight profiles, must match ``repro.mapreduce.pairwise_similarity`` at the
reference's fp32 tolerance (1e-5); the executors must agree with each other
and with the reference's runners on one shared plan; the fused fallback is
counted; what is not ported yet raises.
"""

import dataclasses
import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.mapreduce as ref_mr
import repro_torch.mapreduce as port_mr
from repro.core import plan_a2a as ref_plan_a2a
from repro.mapreduce.allpairs import _block_fn as ref_block_fn
from repro_torch.mapreduce import engine as port_engine
from repro_torch.mapreduce.allpairs import _block_fn
from repro_torch.mapreduce.assembly import _pair_source_map
from repro_torch.obs import EVENTS as PORT_EVENTS


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


def _shared_plan(kind, m, seed):
    """One reference plan, and the port's copy of it."""
    ref = ref_mr.build_plan(ref_plan_a2a(_weights(kind, m, seed), 1.0))
    return ref, port_engine.plan_from_arrays(dataclasses.asdict(ref))


EXECUTORS = ["dense", "bucketed", "fused"]
METRICS = ["dot", "l2", "cosine"]
PROFILES = ["uniform", "zipf", "one-giant"]


@pytest.mark.parametrize("kind", PROFILES)
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("executor", EXECUTORS)
def test_pairwise_similarity_matches_reference(executor, metric, kind):
    m, d = 24, 8
    w = _weights(kind, m, seed=11)
    x = _table(11, m, d)
    ref, ref_plan, _ = ref_mr.pairwise_similarity(
        jnp.asarray(x), q=1.0, weights=w, metric=metric, executor=executor)
    got, plan, _ = port_mr.pairwise_similarity(
        x, q=1.0, weights=w, metric=metric, executor=executor, device="cpu")
    assert got.shape == (m, m) and got.device.type == "cpu"
    assert plan.algorithm == ref_plan.algorithm
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kind", PROFILES)
def test_executors_agree_on_one_shared_plan(kind):
    """Dense combine of all three port executors == the reference's dense
    runner, all on the same reference plan."""
    ref_plan, plan = _shared_plan(kind, 21, seed=4)
    x = _table(4, 21, 6)
    ref = np.asarray(ref_mr.run_reducers(jnp.asarray(x), ref_plan,
                                         ref_block_fn("dot", False)))
    fn = _block_fn("dot", False)
    dense = port_mr.run_reducers(x, plan, fn, device="cpu")
    buck = port_mr.run_reducers_bucketed(x, plan, fn, device="cpu")
    fused = port_mr.get_executor("fused").run(x, plan, fn, device="cpu")
    for out in (dense, buck, fused):
        assert out.shape == ref.shape
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_fused_buckets_combine_matches_bucketed():
    _, plan = _shared_plan("zipf", 27, seed=6)
    x = torch.from_numpy(_table(6, 27, 5))
    fn = _block_fn("cosine", False)
    fused = port_mr.get_executor("fused").run(x, plan, fn, device="cpu",
                                              combine="buckets")
    buck = port_mr.run_reducers_bucketed(x, plan, fn, device="cpu",
                                         combine="buckets")
    assert len(fused) == len(buck) == len(plan.buckets)
    for g, (b, blocks) in zip(fused, buck):
        assert g.shape == (b.R, b.width, b.width)
        torch.testing.assert_close(g, blocks, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", METRICS)
def test_fused_run_pairs_on_shared_plan_matches_reference(metric):
    ref_plan, plan = _shared_plan("one-giant", 19, seed=8)
    x = _table(8, 19, 7)
    ref = ref_mr.get_executor("fused").run_pairs(
        jnp.asarray(x), ref_plan, ref_block_fn(metric, False), 19)
    got = port_mr.make_executor("fused").run_pairs(
        x, plan, _block_fn(metric, False), 19, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_pair_source_map_matches_reference():
    from repro.mapreduce.allpairs import _pair_source_map as ref_srcmap
    ref_plan, plan = _shared_plan("zipf", 30, seed=2)
    np.testing.assert_array_equal(_pair_source_map(plan, 30),
                                  ref_srcmap(ref_plan, 30))


def test_pair_source_map_refuses_int32_overflow():
    L, R = 2048, 513                        # 513 * 2048**2 > 2**31 entries
    b = port_mr.ReducerBucket(width=L, rows=np.arange(R),
                              idx=np.zeros((R, L), np.int32),
                              mask=np.zeros((R, L), bool))
    plan = port_mr.ReducerPlan(idx=b.idx, mask=b.mask, num_reducers=R,
                               comm_cost=0.0, max_inputs=L, buckets=(b,))
    with pytest.raises(OverflowError):
        _pair_source_map(plan, 4)


@pytest.mark.parametrize("executor", EXECUTORS)
def test_plan_indexing_past_the_table_is_refused(executor):
    _, plan = _shared_plan("uniform", 12, seed=5)
    x = _table(5, 11, 4)                      # one row short of the plan
    with pytest.raises(IndexError, match="table of 11 rows"):
        port_mr.make_executor(executor).run_pairs(
            x, plan, _block_fn("dot", False), 11, device="cpu")


def test_non_gram_reducer_falls_back_counted():
    _, plan = _shared_plan("zipf", 17, seed=3)
    x = torch.from_numpy(_table(5, 17, 4))

    def untagged(block, mask):
        return torch.where(mask[:, None] & mask[None, :],
                           block @ block.T, 0.0)

    ex = port_mr.make_executor("fused")
    n_events = len(PORT_EVENTS.events("executor_fallback"))
    out = ex.run(x, plan, untagged, device="cpu")
    buck = port_mr.run_reducers_bucketed(x, plan, untagged, device="cpu")
    torch.testing.assert_close(out, buck)
    assert ex.stats()["fallbacks"] == 1 and ex.stats()["streamed"] == 0
    events = PORT_EVENTS.events("executor_fallback")
    assert len(events) == n_events + 1
    assert events[-1]["reason"] == "non_gram_reducer"


def test_bucketless_plan_falls_back_counted():
    idx = np.array([[0, 1, 2]], np.int32)
    mask = np.ones((1, 3), bool)
    plan = port_mr.ReducerPlan(idx=idx, mask=mask, num_reducers=1,
                               comm_cost=3.0, max_inputs=3)
    x = torch.from_numpy(_table(1, 3, 4))
    ex = port_mr.make_executor("fused")
    out = ex.run(x, plan, _block_fn("dot", False), device="cpu")
    dense = port_mr.run_reducers(x, plan, _block_fn("dot", False),
                                 device="cpu")
    torch.testing.assert_close(out, dense)
    assert ex.stats()["fallbacks"] == 1


def test_all_masked_bucket_gives_zero_blocks():
    idx = np.zeros((2, 3), np.int32)
    mask = np.zeros((2, 3), bool)
    plan = port_mr.ReducerPlan(
        idx=idx, mask=mask, num_reducers=0, comm_cost=0.0, max_inputs=3,
        buckets=(port_mr.ReducerBucket(width=3,
                                       rows=np.full(2, -1, np.int64),
                                       idx=idx, mask=mask),))
    x = torch.ones((4, 5))
    fn = _block_fn("dot", False)
    fused = port_mr.get_executor("fused").run(x, plan, fn, device="cpu")
    buck = port_mr.run_reducers_bucketed(x, plan, fn, device="cpu")
    torch.testing.assert_close(fused, buck)
    assert float(fused.abs().max()) == 0.0


def test_single_input_degenerate():
    x = np.ones((1, 4), np.float32)
    for executor in EXECUTORS:
        s, _, _ = port_mr.pairwise_similarity(x, q=1.0, weights=[0.3],
                                              executor=executor,
                                              device="cpu")
        assert s.shape == (1, 1) and float(s.abs().max()) == 0.0


@pytest.mark.parametrize("executor", EXECUTORS)
def test_mesh_is_not_ported_yet(executor):
    """Once NotImplementedError; ``mesh=`` is ported now (a process group,
    ``tests/test_torch_mesh.py``), so a mesh that is not a process group
    raises ``TypeError`` before any planning."""
    with pytest.raises(TypeError, match="ProcessGroup"):
        port_mr.pairwise_similarity(_table(0, 6, 3), q=1.0,
                                    weights=np.full(6, 0.2), mesh=object(),
                                    executor=executor, device="cpu")


@pytest.mark.parametrize("executor", ["dense", "bucketed"])
def test_use_kernel_on_oracles_is_not_ported_yet(executor):
    """Once NotImplementedError; ``pairwise_gram`` is ported now, so
    ``use_kernel=True`` on the oracles runs its plain version here and
    matches the reference's interpreted Pallas kernel."""
    x, w = _table(0, 6, 3), np.full(6, 0.2)
    ref, _, _ = ref_mr.pairwise_similarity(
        jnp.asarray(x), q=1.0, weights=w, use_kernel=True, executor=executor)
    got, _, _ = port_mr.pairwise_similarity(x, q=1.0, weights=w,
                                            use_kernel=True,
                                            executor=executor, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_registry():
    # "streaming" registers itself on its first lookup, which another test
    # in the same process may already have made
    assert set(port_mr.list_executors()) - {"streaming"} == \
        {"bucketed", "dense", "fused", "sharded", "coded"}
    with pytest.raises(ValueError):
        port_mr.get_executor("warp-drive")
    a, b = port_mr.make_executor("fused"), port_mr.make_executor("fused")
    assert a is not b and a.stats() == {"calls": 0, "kernel": 0,
                                        "streamed": 0, "fallbacks": 0}
    assert port_mr.get_executor(a) is a


def test_upload_cache_stats_keys_and_reuse():
    assert set(port_mr.jit_cache_stats()) == set(ref_mr.jit_cache_stats())
    _, plan = _shared_plan("uniform", 15, seed=12)
    x = torch.from_numpy(_table(12, 15, 4))
    ex = port_mr.make_executor("fused")
    before = port_mr.jit_cache_stats()
    for _ in range(2):
        ex.run_pairs(x, plan, _block_fn("dot", False), 15, device="cpu")
    after = port_mr.jit_cache_stats()
    assert after["misses"] - before["misses"] == 2     # buckets + srcmap
    assert after["hits"] - before["hits"] == 2
    assert after["shape_hits"] - before["shape_hits"] == 2
    assert ex.stats()["calls"] == 2 and ex.stats()["streamed"] == 2


def test_upload_cache_is_bounded_and_drops_collected_plans(monkeypatch):
    monkeypatch.setattr(port_engine, "_JIT_CACHE_MAX", 3)
    x = torch.from_numpy(_table(21, 13, 4))
    ex = port_mr.make_executor("fused")
    plans = [_shared_plan("uniform", 13, seed=s)[1] for s in (21, 22)]
    evictions = port_mr.jit_cache_stats()["evictions"]
    for plan in plans:                         # two entries per plan
        ex.run_pairs(x, plan, _block_fn("dot", False), 13, device="cpu")
    stats = port_mr.jit_cache_stats()
    assert stats["size"] == 3 and stats["evictions"] == evictions + 1
    tok = plans[1]._upload_token
    assert any(k[1] == tok for k in port_engine._JIT_CACHE)
    del plans, plan
    gc.collect()
    assert not any(k[1] == tok for k in port_engine._JIT_CACHE)
