"""The port's some-pairs similarity against the JAX package, on the CPU.

``some_pairs_similarity`` on the dense, bucketed and fused executors with
the dot, l2 and cosine metrics: the same schema and byte-equal plan arrays,
matrices allclose to the reference's at its tolerance (rtol / atol 1e-4, as
``tests/test_bucketed_executor.py::test_some_pairs_executors_agree`` and
``tests/test_fused_executor.py::test_x2y_some_pairs_fused_agrees`` hold
theirs), the required pairs carrying the true similarity and everything
else exactly 0.  ``PairwiseService.some_pairs`` returns the reference's
``info`` (``tests/test_serve.py::test_some_pairs_masked_to_request``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.mapreduce as ref_mr
import repro_torch.mapreduce as port_mr
from repro.serve import PairwiseService as RefService
from repro_torch.serve import PairwiseService

TOL = dict(rtol=1e-4, atol=1e-4)
EXECUTORS = ["dense", "bucketed", "fused"]
METRICS = ["dot", "l2", "cosine"]
PAIRS = [(0, 1), (2, 9), (5, 17), (3, 4), (11, 12)]
SKIP = {"wall_s", "jit_cache"}


def _case(m=20, seed=13):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.02, 0.3, m)
    x = rng.normal(size=(m, 8)).astype(np.float32)
    return w, x


def _want(m, pairs):
    want = np.zeros((m, m), dtype=bool)
    for i, j in pairs:
        want[i, j] = want[j, i] = True
    return want


def _direct(x, metric):
    g = x.astype(np.float64) @ x.T.astype(np.float64)
    n2 = np.diag(g)
    if metric == "l2":
        return n2[:, None] + n2[None, :] - 2.0 * g
    if metric == "cosine":
        nrm = np.sqrt(n2 + 1e-9)
        return g / (nrm[:, None] * nrm[None, :])
    return g


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("executor", EXECUTORS)
def test_some_pairs_matches_reference(executor, metric):
    w, x = _case()
    m = len(w)
    ref, ref_plan, ref_schema = ref_mr.some_pairs_similarity(
        jnp.asarray(x), PAIRS, q=1.0, weights=w, metric=metric,
        executor=executor)
    got, plan, schema = port_mr.some_pairs_similarity(
        x, PAIRS, q=1.0, weights=w, metric=metric, executor=executor,
        device="cpu")
    assert schema.algorithm == ref_schema.algorithm
    assert schema.reducers == ref_schema.reducers
    for f in ("idx", "mask"):
        assert getattr(plan, f).tobytes() == getattr(ref_plan, f).tobytes()
    got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)
    want = _want(m, PAIRS)
    assert np.all(got[~want] == 0.0)
    np.testing.assert_allclose(got[want], _direct(x, metric)[want], **TOL)


@pytest.mark.parametrize("metric", METRICS)
def test_some_pairs_executors_agree(metric):
    """dense == bucketed == fused on one schema (the port's own three)."""
    w, x = _case()
    s_d, _, sch = port_mr.some_pairs_similarity(
        x, PAIRS, q=1.0, weights=w, metric=metric, executor="dense",
        device="cpu")
    for executor in ("bucketed", "fused"):
        s, _, _ = port_mr.some_pairs_similarity(
            x, PAIRS, q=1.0, weights=w, schema=sch, metric=metric,
            executor=executor, device="cpu")
        torch.testing.assert_close(s, s_d, **TOL)


def test_some_pairs_on_a_dense_pair_set_covers_every_pair():
    """Every pair requested: the masked result is the all-pairs matrix
    (zero diagonal) on both packages."""
    w, x = _case(m=14, seed=5)
    pairs = [(i, j) for i in range(14) for j in range(i + 1, 14)]
    ref, _, _ = ref_mr.some_pairs_similarity(
        jnp.asarray(x), pairs, q=1.0, weights=w, executor="fused")
    got, _, _ = port_mr.some_pairs_similarity(
        x, np.asarray(pairs), q=1.0, weights=w, executor="fused",
        device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    g = _direct(x, "dot")
    np.fill_diagonal(g, 0.0)
    np.testing.assert_allclose(got.numpy(), g, **TOL)


@pytest.mark.parametrize("executor", EXECUTORS)
def test_service_some_pairs_matches_reference(executor):
    rng = np.random.default_rng(1)
    m = 16
    x = rng.normal(size=(m, 4)).astype(np.float32)
    w = np.full(m, 0.2)
    pairs = [(0, 3), (5, 9)]
    ref_svc = RefService(q=1.0, executor=executor)
    svc = PairwiseService(q=1.0, executor=executor, device="cpu")
    for _ in range(2):
        ref, ref_info = ref_svc.some_pairs(x, pairs, weights=w)
        sims, info = svc.some_pairs(x, pairs, weights=w)
        np.testing.assert_allclose(sims.numpy(), np.asarray(ref), **TOL)
        assert set(info) == set(ref_info)
        assert {k: v for k, v in info.items() if k not in SKIP} == \
            {k: v for k, v in ref_info.items() if k not in SKIP}
    assert np.all(sims.numpy()[~_want(m, pairs)] == 0.0)
    for i, j in pairs:
        np.testing.assert_allclose(float(sims[i, j]), float(x[i] @ x[j]),
                                   rtol=1e-4)
    assert svc.padding_savings >= 1.0
    assert svc.stats["requests"] == ref_svc.stats["requests"] == 2
    if executor == "fused":
        assert info["fused_path"] == "streamed"         # plain version
