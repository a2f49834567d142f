"""The port's block serving against the JAX package, on the CPU.

``build_sparse_plan`` and ``block_subplan`` arrays must be byte-equal to the
reference's; every block of an m=1024 grid served by the port's bucketed
and fused executors must equal the reference's block (rtol/atol 1e-5, as in
``tests/test_hierarchy.py``); the block sub-plan LRU keeps the reference's
eviction order, cap and counters; ``PairwiseService.load_block_table`` /
``block`` report the reference's ``info``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.mapreduce as ref_mr
import repro_torch.mapreduce as port_mr
from repro.core import plan_a2a as ref_plan_a2a
from repro.core import plan_a2a_hierarchical as ref_hier
from repro.serve import PairwiseService as RefService
from repro_torch.core import plan_a2a, plan_a2a_hierarchical
from repro_torch.mapreduce import engine as port_engine
from repro_torch.serve import PairwiseService

TOL = dict(rtol=1e-5, atol=1e-5)
SPARSE_FIELDS = ("bin_indptr", "bin_inputs", "bin_of", "red_indptr",
                 "red_bins", "binred_indptr", "bin_reds")


def _grid_case(m=1024, d=6, seed=12):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, d)).astype(np.float32)
    w = rng.uniform(0.4, 2.0, m)
    return x, w, 18.0


def _assert_sparse_equal(port, ref):
    for f in SPARSE_FIELDS:
        a, b = getattr(port, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    for f in ("num_inputs", "q", "comm_cost", "lower_bound", "algorithm"):
        assert getattr(port, f) == getattr(ref, f), f


def _assert_plans_equal(port, ref):
    if ref is None:
        assert port is None
        return
    for f in ("idx", "mask", "yidx", "ymask"):
        assert getattr(port, f).tobytes() == getattr(ref, f).tobytes(), f
    assert (port.num_reducers, port.comm_cost, port.algorithm,
            port.num_x, port.num_y) == (ref.num_reducers, ref.comm_cost,
                                        ref.algorithm, ref.num_x, ref.num_y)
    for pb, rb in zip(port.buckets, ref.buckets, strict=True):
        assert (pb.width, pb.ywidth) == (rb.width, rb.ywidth)
        for f in ("rows", "idx", "mask", "yidx", "ymask"):
            assert getattr(pb, f).tobytes() == getattr(rb, f).tobytes(), f


def test_sparse_plan_and_block_subplans_byte_equal():
    _, w, q = _grid_case(m=600)
    ref_schema = ref_hier(w, q, c=2, use_cache=False)
    schema = plan_a2a_hierarchical(w, q, c=2, use_cache=False)
    assert schema.algorithm == ref_schema.algorithm
    ref_sp = ref_mr.build_sparse_plan(ref_schema)
    sp = port_mr.build_sparse_plan(schema)
    _assert_sparse_equal(sp, ref_sp)
    assert sp.host_entries == ref_sp.host_entries
    for blk in [(0, 200, 200, 400), (100, 350, 0, 600), (590, 600, 0, 5),
                (10, 10, 0, 50)]:
        _assert_plans_equal(
            port_engine.block_subplan(sp, *blk, cache_size=8),
            ref_mr.block_subplan(ref_sp, *blk, cache_size=8))


def test_flat_schema_sparse_plan_byte_equal():
    w = np.random.default_rng(14).uniform(0.1, 0.25, 50)
    _assert_sparse_equal(port_mr.build_sparse_plan(plan_a2a(w, 1.0)),
                         ref_mr.build_sparse_plan(ref_plan_a2a(w, 1.0)))


@pytest.mark.parametrize("executor", ["bucketed", "fused"])
def test_full_grid_matches_reference_blocks(executor):
    x, w, q = _grid_case()
    m, B = x.shape[0], 300                  # uneven tail blocks included
    ref_schema = ref_hier(w, q, c=2, use_cache=False)
    schema = plan_a2a_hierarchical(w, q, c=2, use_cache=False)
    ref_full, _, _ = ref_mr.pairwise_similarity(
        jnp.asarray(x), q=q, schema=ref_schema, executor="dense")
    ref_full = np.asarray(ref_full)
    for i0 in range(0, m, B):
        for j0 in range(0, m, B):
            i1, j1 = min(i0 + B, m), min(j0 + B, m)
            blk, sparse, _ = port_mr.pairwise_similarity_block(
                x, i0, i1, j0, j1, q=q, schema=schema, executor=executor,
                device="cpu")
            assert blk.shape == (i1 - i0, j1 - j0)
            np.testing.assert_allclose(
                blk.numpy(), ref_full[i0:i1, j0:j1], **TOL,
                err_msg=f"block [{i0}:{i1})x[{j0}:{j1})")
    assert sparse.host_entries < m * m
    # one diagonal and one off-diagonal block through the reference's own
    # block path
    for i0, i1, j0, j1 in [(300, 600, 300, 600), (0, 300, 900, 1024)]:
        ref_blk, _, _ = ref_mr.pairwise_similarity_block(
            jnp.asarray(x), i0, i1, j0, j1, q=q, schema=ref_schema,
            executor=executor)
        blk, _, _ = port_mr.pairwise_similarity_block(
            x, i0, i1, j0, j1, q=q, schema=schema, executor=executor,
            device="cpu")
        np.testing.assert_allclose(blk.numpy(), np.asarray(ref_blk), **TOL)


def test_dense_executor_serves_blocks():
    x, w, q = _grid_case(m=200, seed=3)
    full, _, schema = port_mr.pairwise_similarity(
        x, q=q, schema=plan_a2a_hierarchical(w, q, c=2, use_cache=False),
        executor="bucketed", device="cpu")
    ex = port_mr.make_executor("dense")
    blk, _, _ = port_mr.pairwise_similarity_block(
        x, 40, 170, 20, 120, schema=schema, executor=ex, device="cpu")
    torch.testing.assert_close(blk, full[40:170, 20:120], **TOL)
    assert ex.stats()["block_calls"] == 1


def test_empty_and_out_of_range_blocks():
    x, w, q = _grid_case(m=100, seed=4)
    blk, sparse, schema = port_mr.pairwise_similarity_block(
        x, 5, 5, 0, 10, q=q, weights=w, executor="fused", device="cpu")
    assert blk.shape == (0, 10)
    with pytest.raises(IndexError):
        port_mr.pairwise_similarity_block(x, 0, 120, 0, 10, schema=schema,
                                          executor="fused", device="cpu")
    with pytest.raises(IndexError):
        port_engine.block_subplan(sparse, 0, 60, 0, 101)
    with pytest.raises(ValueError, match="pass q"):
        port_mr.pairwise_similarity_block(x, 0, 10, 0, 10, device="cpu")


def _small_sparse(m=60, seed=15):
    w = np.random.default_rng(seed).uniform(0.1, 0.25, m)
    return port_mr.build_sparse_plan(plan_a2a(w, 1.0))


def test_block_cache_eviction_order_is_lru():
    sparse = _small_sparse()
    blocks = [(0, 20), (20, 40), (40, 60)]

    def req(b):
        i0, i1 = b
        return port_engine.block_subplan(sparse, i0, i1, i0, i1,
                                         cache_size=2)

    req(blocks[0])
    req(blocks[1])
    before = port_mr.block_cache_stats()
    req(blocks[0])                        # touch A -> cache: [B, A]
    req(blocks[2])                        # insert C -> evicts B
    req(blocks[0])                        # A survived: hit
    delta = {k: port_mr.block_cache_stats()[k] - before[k]
             for k in ("hits", "misses", "evictions")}
    assert delta == {"hits": 2, "misses": 1, "evictions": 1}
    kept = {key[:2] for key in sparse.__dict__["_block_cache"]}
    assert kept == {blocks[0], blocks[2]}
    req(blocks[1])                        # B was evicted: miss again
    assert port_mr.block_cache_stats()["misses"] - before["misses"] == 2


def test_block_cache_cap_configure_and_env(monkeypatch):
    old = port_engine._BLOCK_CACHE_MAX
    try:
        assert port_mr.configure_block_cache(7) == 7
        monkeypatch.setenv("REPRO_BLOCK_CACHE_SIZE", "13")
        assert port_mr.configure_block_cache() == 13
        monkeypatch.setenv("REPRO_BLOCK_CACHE_SIZE", "bogus")
        assert port_mr.configure_block_cache() == 64
        monkeypatch.setenv("REPRO_BLOCK_CACHE_SIZE", "-2")
        assert port_mr.configure_block_cache() == 64
        with pytest.raises(AssertionError):
            port_mr.configure_block_cache(0)
        port_mr.configure_block_cache(1)
        sparse = _small_sparse(seed=16)
        port_engine.block_subplan(sparse, 0, 20, 0, 20)
        port_engine.block_subplan(sparse, 20, 40, 20, 40)
        assert len(sparse.__dict__["_block_cache"]) == 1
        assert port_mr.block_cache_stats()["max_size"] == 1
    finally:
        port_mr.configure_block_cache(old)
    assert set(port_mr.block_cache_stats()) == \
        set(ref_mr.block_cache_stats())


@pytest.mark.parametrize("executor", ["bucketed", "fused"])
def test_service_block_api_matches_reference(executor):
    rng = np.random.default_rng(13)
    m, d, q = 96, 5, 14.0
    x = rng.normal(size=(m, d)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, m)
    ref_svc = RefService(q, metric="dot", executor=executor)
    svc = PairwiseService(q, metric="dot", executor=executor, device="cpu")
    with pytest.raises(RuntimeError, match="load_block_table"):
        svc.block(0, 1, 0, 1)
    ref_info = ref_svc.load_block_table(x, w)
    info = svc.load_block_table(x, w)
    assert set(info) == set(ref_info)
    assert {k: v for k, v in info.items() if k != "wall_s"} == \
        {k: v for k, v in ref_info.items() if k != "wall_s"}
    for blk_range in [(8, 72, 30, 96), (0, 50, 0, 50)]:
        ref, ref_binfo = ref_svc.block(*blk_range)
        blk, binfo = svc.block(*blk_range)
        np.testing.assert_allclose(blk.numpy(), np.asarray(ref), **TOL)
        assert {k: v for k, v in binfo.items() if k != "wall_s"} == \
            {k: v for k, v in ref_binfo.items() if k != "wall_s"}
    assert svc.stats["block_requests"] == 2
