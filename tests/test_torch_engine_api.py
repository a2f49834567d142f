"""The port's engine-level API against the JAX package, on the CPU.

The module-level shims (``fused_stats`` / ``reset_fused_stats`` over the
obs registry, ``run_reducers_fused``, ``configure_jit_cache`` on the upload
LRU), the streaming executor's lazy registration, ``lower`` raising, and
the A2A finish: the dense and bucketed assembly multiply the diagonal by 0
as the reference multiplies by ``1 - eye``, so a non-finite self-product
gives NaN there on both packages (the fused path takes the diagonal from
slot 0 of its source map, 0 on both).
"""

from collections import OrderedDict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.mapreduce as ref_mr
import repro_torch.mapreduce as port_mr
from repro.core import plan_a2a as ref_plan_a2a
from repro.mapreduce import engine as ref_engine
from repro_torch.core import plan_a2a
from repro_torch.mapreduce import engine as port_engine
from repro_torch.mapreduce.allpairs import _block_fn

EXECUTORS = ["dense", "bucketed", "fused"]


def _zipf(m, seed):
    rng = np.random.default_rng(seed)
    w = np.clip(rng.zipf(1.7, m) / 24.0, 0.02, 0.45)
    x = rng.normal(size=(m, 6)).astype(np.float32)
    return w, x


# ------------------------------------------------------------ the diagonal
@pytest.mark.parametrize("executor", EXECUTORS)
def test_non_finite_self_product_matches_reference(executor):
    """m=12, d=8, seed 0, ``x[3, 2] = inf``: the reference's dense and
    bucketed paths give NaN at (3, 3), its fused path 0; every other cell
    agrees too (NaN where the reference has NaN)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(12, 8)).astype(np.float32)
    x[3, 2] = np.inf
    w = rng.uniform(0.05, 0.3, 12)
    ref, _, _ = ref_mr.pairwise_similarity(
        jnp.asarray(x), q=1.0, weights=w, executor=executor)
    got, _, _ = port_mr.pairwise_similarity(x, q=1.0, weights=w,
                                            executor=executor, device="cpu")
    ref = np.asarray(ref)
    want_33 = 0.0 if executor == "fused" else np.nan
    np.testing.assert_array_equal(ref[3, 3], want_33)
    np.testing.assert_array_equal(got.numpy()[3, 3], want_33)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_finish_multiplies_the_diagonal_by_zero():
    from repro_torch.mapreduce.assembly import _finish_pair_matrix
    out = torch.tensor([[float("inf"), float("-inf"), 2.0],
                        [1.0, float("nan"), float("-inf")],
                        [-3.0, 4.0, -5.0]])
    got = _finish_pair_matrix(out.clone())
    want = torch.tensor([[float("nan"), 0.0, 2.0],
                         [1.0, float("nan"), 0.0],
                         [-3.0, 4.0, 0.0]])
    torch.testing.assert_close(got, want, equal_nan=True)


# ------------------------------------------------------- fused_stats shims
def test_fused_stats_is_aggregate_view():
    w, x = _zipf(17, 3)
    port_engine.reset_fused_stats()
    assert port_mr.fused_stats() == {"calls": 0, "kernel": 0,
                                     "streamed": 0, "fallbacks": 0}
    mine = port_mr.make_executor("fused")
    port_mr.pairwise_similarity(x, q=1.0, weights=w, executor="fused",
                                device="cpu")
    port_mr.pairwise_similarity(x, q=1.0, weights=w, executor=mine,
                                device="cpu")
    after = port_mr.fused_stats()
    assert after == {"calls": 2, "kernel": 0, "streamed": 2, "fallbacks": 0}
    assert set(after) == set(ref_engine.fused_stats())
    assert mine.stats()["calls"] == 1               # instance-scoped view
    port_mr.reset_fused_stats()
    assert port_mr.fused_stats()["calls"] == 0
    assert port_engine.FUSED_STATS == ref_engine.FUSED_STATS == {
        "calls": 0, "kernel": 0, "streamed": 0, "fallbacks": 0}


@pytest.mark.parametrize("m", [5, 29])
def test_run_reducers_fused_matches_reference(m):
    w, x = _zipf(m, m)
    ref_plan = ref_mr.build_plan(ref_plan_a2a(w, 1.0))
    plan = port_mr.build_plan(plan_a2a(w, 1.0))
    ref = ref_engine.run_reducers_fused(
        jnp.asarray(x), ref_plan, ref_mr.allpairs._block_fn("dot", False),
        use_kernel=False)
    got = port_mr.run_reducers_fused(x, plan, _block_fn("dot", False),
                                     device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_run_reducers_fused_counts_a_fallback():
    w, x = _zipf(17, 3)
    plan = port_mr.build_plan(plan_a2a(w, 1.0))

    def colsum(blk, msk):
        return torch.sum(blk * msk[:, None], dim=0)

    before = port_mr.fused_stats()
    got = port_mr.run_reducers_fused(x, plan, colsum, device="cpu")
    after = port_mr.fused_stats()
    want = port_mr.run_reducers_bucketed(x, plan, colsum, device="cpu")
    torch.testing.assert_close(got, want)
    assert after["fallbacks"] == before["fallbacks"] + 1
    assert after["calls"] == before["calls"] + 1


# --------------------------------------------------- configure_jit_cache
def test_configure_jit_cache_env_and_eviction(monkeypatch):
    """The counterpart of the reference's ``test_env_configurable_cap``."""
    for mod in (port_engine, ref_engine):
        monkeypatch.setattr(mod, "_JIT_CACHE", OrderedDict())
        monkeypatch.setattr(mod, "_JIT_CACHE_HITS", {})
        monkeypatch.setattr(mod, "_JIT_CACHE_MAX", mod._JIT_CACHE_MAX)
    monkeypatch.setenv("REPRO_JIT_CACHE_SIZE", "3")
    assert port_mr.configure_jit_cache() == 3
    assert port_mr.jit_cache_stats()["max_size"] == 3
    for k in "ABC":
        port_engine._cache_get(k, lambda: k)
        ref_engine._cache_get(k, lambda: k)
    monkeypatch.setenv("REPRO_JIT_CACHE_SIZE", "1")
    assert port_mr.configure_jit_cache() == ref_engine.configure_jit_cache()
    assert list(port_engine._JIT_CACHE) == list(ref_engine._JIT_CACHE) \
        == ["C"]
    assert port_mr.configure_jit_cache(5) == 5
    monkeypatch.delenv("REPRO_JIT_CACHE_SIZE")
    assert port_mr.configure_jit_cache() == 64
    for bad in ("abc", "0", "-3", ""):
        monkeypatch.setenv("REPRO_JIT_CACHE_SIZE", bad)
        assert port_mr.configure_jit_cache() == 64, bad


def test_table_signatures_record_what_was_served():
    w, x = _zipf(11, 4)
    port_mr.pairwise_similarity(x, q=1.0, weights=w, executor="bucketed",
                                device="cpu")
    sigs = port_mr.table_signatures()
    assert ("buckets", "cpu", ((11, 6), "torch.float32")) in sigs
    port_mr.pairwise_similarity(x, q=1.0, weights=w, executor="bucketed",
                                device="cpu")
    assert port_mr.table_signatures() == sigs


# ------------------------------------------------ registry and lowering
def test_streaming_registers_on_first_lookup():
    ex = port_mr.get_executor("streaming")
    from repro_torch.stream import StreamingExecutor
    assert isinstance(ex, StreamingExecutor)
    assert "streaming" in port_mr.list_executors()
    fresh = port_mr.make_executor("streaming")
    assert fresh is not ex and fresh.stats()["calls"] == 0
    assert set(fresh.stats()) == set(
        ref_mr.make_executor("streaming").stats())


@pytest.mark.parametrize("executor", EXECUTORS + ["streaming"])
def test_lower_raises(executor):
    plan = port_mr.build_plan(plan_a2a(np.full(6, 0.2), 1.0))
    with pytest.raises(NotImplementedError, match="no XLA lowering"):
        port_mr.make_executor(executor).lower((6, 4), plan)


def test_streaming_refuses_a_mesh():
    """Streaming takes a process group now (``tests/test_torch_mesh.py``)
    and refuses a mesh that is not one."""
    plan = port_mr.build_plan(plan_a2a(np.full(6, 0.2), 1.0))
    ex = port_mr.make_executor("streaming")
    x = np.ones((6, 4), np.float32)
    with pytest.raises(TypeError, match="ProcessGroup"):
        ex.run_pairs(x, plan, _block_fn("dot", False), 6, mesh=object(),
                     device="cpu")
