"""The port's streaming subsystem against the JAX package, on the CPU.

* Planners: ``repro_torch.stream``'s copies of ``IncrementalPlanner`` and
  ``IncrementalX2YPlanner`` give the reference's ``PlanDelta`` for the same
  edit sequence — equal kinds, ids, touched inputs, dirty rows, costs,
  bounds, meta, byte-equal sub-plan arrays — and equal planner ``stats``.
* Matrices: ``StreamingExecutor.apply_delta`` / ``apply_delta_x2y`` after
  every edit allclose to the reference's at its 1e-4
  (``tests/test_stream.py::test_streamed_matches_cold_dense_replan``), and
  tombstoned rows / columns exactly 0.
* Service: the edit API round trip with the reference's ``info`` apart
  from wall time, ``_require_streaming``, the ``add_input`` rollback,
  ``reset_stats``, edits while a background re-plan is in flight, the
  warmed first edit, and results that later edits leave as they were
  (the maintained matrix is patched in place).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.stream as ref_st
import repro_torch.stream as st
from repro.mapreduce import make_executor as ref_make_executor
from repro.mapreduce.allpairs import _block_fn as ref_block_fn
from repro.mapreduce.allpairs import _block_fn_x2y as ref_block_fn_x2y
from repro.serve import PairwiseService as RefService
from repro_torch.core.schema import InfeasibleError
from repro_torch.kernels import _build
from repro_torch.mapreduce import make_executor, pairwise_similarity
from repro_torch.mapreduce import table_signatures
from repro_torch.mapreduce.allpairs import _block_fn, _block_fn_x2y
from repro_torch.mapreduce.assembly import _scatter_blocks_x2y
from repro_torch.serve import PairwiseService

TOL = dict(rtol=1e-4, atol=1e-4)
EDITS = 10
# the matrix sequences are shorter: every new shape costs the reference a
# compile
MATRIX_EDITS = 6


def _profile(kind: str, m: int, seed: int, q: float = 1.0) -> np.ndarray:
    """``tests/test_stream.py``'s profiles."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.uniform(0.05, 0.33, m)
    if kind == "zipf":
        return np.clip(rng.zipf(1.7, m) / 24.0, 0.02, 0.45 * q)
    if kind == "small":
        return rng.uniform(0.01, 0.04, m)
    if kind == "near-half":
        return rng.uniform(0.30 * q, 0.49 * q, m)
    raise ValueError(kind)


def _random_edit(planner, rng, q=1.0):
    """One edit drawn as ``tests/test_stream.py::_apply_random_edit``
    draws it: ``(op, args)``."""
    act = planner.active_ids()
    op = rng.choice(["insert", "delete", "reweight"], p=[0.5, 0.3, 0.2])
    if op == "insert" or len(act) < 3:
        return "insert", (float(rng.uniform(0.02, 0.45 * q)),)
    if op == "delete":
        return "delete", (int(rng.choice(act)),)
    return "reweight", (int(rng.choice(act)),
                        float(rng.uniform(0.02, 0.45 * q)))


def _random_x2y_edit(planner, rng, q):
    ax, ay = planner.active_x_ids(), planner.active_y_ids()
    r = rng.random()
    if r < 0.3:
        return "insert_x", (float(rng.uniform(0.05, 0.45 * q)),)
    if r < 0.55:
        return "insert_y", (float(rng.uniform(0.05, 0.45 * q)),)
    if r < 0.8 and len(ax) > 3:
        return "delete_x", (int(rng.choice(ax)),)
    if len(ay) > 3:
        return "delete_y", (int(rng.choice(ay)),)
    return "insert_x", (float(rng.uniform(0.05, 0.45 * q)),)


def _same_plan(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    for f in ("idx", "mask", "yidx", "ymask"):
        fa, fb = getattr(a, f), getattr(b, f)
        assert (fa is None) == (fb is None), f
        if fa is not None:
            assert fa.dtype == fb.dtype and fa.tobytes() == fb.tobytes(), f
    assert (a.num_reducers, a.comm_cost, a.algorithm) == \
        (b.num_reducers, b.comm_cost, b.algorithm)
    assert len(a.buckets) == len(b.buckets)
    for ba, bb in zip(a.buckets, b.buckets):
        assert (ba.width, ba.ywidth) == (bb.width, bb.ywidth)
        for f in ("rows", "idx", "mask", "yidx", "ymask"):
            np.testing.assert_array_equal(getattr(ba, f), getattr(bb, f))


def _same_delta(a, b):
    assert (a.kind, a.input_id, a.full_replan, a.num_reducers) == \
        (b.kind, b.input_id, b.full_replan, b.num_reducers)
    assert (a.comm_cost, a.lower_bound, a.gap_drift) == \
        (b.comm_cost, b.lower_bound, b.gap_drift)
    np.testing.assert_array_equal(a.touched_inputs, b.touched_inputs)
    np.testing.assert_array_equal(a.dirty_rows, b.dirty_rows)
    np.testing.assert_equal(a.meta, b.meta)
    assert a.recompute_fraction == b.recompute_fraction
    assert a.delta_comm_rows() == b.delta_comm_rows()
    _same_plan(a.sub_plan, b.sub_plan)


# ---------------------------------------------------------------- planners
PLANNER_CASES = [
    ("uniform", 23, 1, {}), ("zipf", 48, 4, {}), ("small", 12, 5, {}),
    ("near-half", 16, 6, {}),
    ("uniform", 40, 2, {"replan_drift": 1.0 + 1e-9}),
    ("zipf", 64, 0, {"max_gap": 1.05, "repack_gap": 1.0}),
]


@pytest.mark.parametrize("kind,m,seed,kw", PLANNER_CASES)
def test_planner_deltas_match_reference(kind, m, seed, kw):
    w = _profile(kind, m, seed)
    ref = ref_st.IncrementalPlanner(1.0, w, **kw)
    port = st.IncrementalPlanner(1.0, w, **kw)
    _same_plan(port.plan(), ref.plan())
    assert port.delta_shapes() == ref.delta_shapes()
    rng = np.random.default_rng(seed)
    for _ in range(EDITS):
        op, args = _random_edit(port, rng)
        _same_delta(getattr(port, op)(*args), getattr(ref, op)(*args))
        np.testing.assert_array_equal(port.active_ids(), ref.active_ids())
    assert port.stats == ref.stats
    assert (port.comm_cost, port.lower_bound, port.achievable_gap) == \
        (ref.comm_cost, ref.lower_bound, ref.achievable_gap)
    _same_plan(port.plan(), ref.plan())
    port.snapshot().validate("a2a")


@pytest.mark.parametrize("seed,kw", [(0, {}), (1, {"max_gap": 1.05}),
                                     (2, {"replan_drift": 1.0 + 1e-9})])
def test_x2y_planner_deltas_match_reference(seed, kw):
    rng = np.random.default_rng(seed)
    q = 4.0
    wx = np.clip(rng.zipf(1.6, 24) / 8.0, 0.05, 0.45 * q)
    wy = np.clip(rng.zipf(1.6, 16) / 8.0, 0.05, 0.45 * q)
    ref = ref_st.IncrementalX2YPlanner(q, wx=wx, wy=wy, **kw)
    port = st.IncrementalX2YPlanner(q, wx=wx, wy=wy, **kw)
    _same_plan(port.plan(), ref.plan())
    assert port.delta_shapes() == ref.delta_shapes()
    for _ in range(EDITS):
        op, args = _random_x2y_edit(port, rng, q)
        d = getattr(port, op)(*args)
        _same_delta(d, getattr(ref, op)(*args))
        d.verify_x2y(port.x_expanded(), port.y_expanded(),
                     port.active_x_ids(), port.active_y_ids())
    assert port.stats == ref.stats
    _same_plan(port.plan(), ref.plan())


def test_infeasible_insert_rolls_back():
    port = st.IncrementalPlanner(1.0, np.array([0.6, 0.3]))
    m0, r0, edits0 = len(port.weights), port.num_reducers, \
        port.stats["edits"]
    with pytest.raises(InfeasibleError):
        port.insert(0.7)                         # two inputs > q/2
    assert (len(port.weights), port.num_reducers, port.stats["edits"]) == \
        (m0, r0, edits0)


# ---------------------------------------------------------------- matrices
@pytest.mark.parametrize("kind,m,seed", [("uniform", 24, 0), ("zipf", 40, 1),
                                         ("small", 10, 2)])
@pytest.mark.parametrize("metric,use_kernel", [("dot", False),
                                               ("cosine", False),
                                               ("l2", True)])
def test_streamed_matrix_matches_reference(kind, m, seed, metric,
                                           use_kernel):
    """After every edit the port's patched matrix is allclose to the
    reference's (``use_kernel=True`` routes the delta's blocks through
    ``pairwise_gram``'s plain version; the reference runs its non-kernel
    reducer, which computes the same values)."""
    rng = np.random.default_rng(seed)
    w = _profile(kind, m, seed)
    x = rng.normal(size=(m, 8)).astype(np.float32)
    ref_p, port_p = ref_st.IncrementalPlanner(1.0, w), \
        st.IncrementalPlanner(1.0, w)
    ref_ex, ex = ref_make_executor("streaming"), make_executor("streaming")
    ref_fn, fn = ref_block_fn(metric, False), _block_fn(metric, use_kernel)
    ref_sims = ref_ex.run_pairs(jnp.asarray(x), ref_p.plan(), ref_fn, m)
    sims = ex.run_pairs(x, port_p.plan(), fn, m, use_kernel=use_kernel,
                        device="cpu")
    np.testing.assert_allclose(sims.numpy(), np.asarray(ref_sims), **TOL)
    table = x
    for _ in range(MATRIX_EDITS):
        op, args = _random_edit(port_p, rng)
        if op == "insert":
            table = np.concatenate(
                [table, rng.normal(size=(1, 8)).astype(np.float32)])
        rd, d = getattr(ref_p, op)(*args), getattr(port_p, op)(*args)
        ref_sims = ref_ex.apply_delta(jnp.asarray(table), rd, ref_fn,
                                      table.shape[0],
                                      plan_provider=ref_p.plan)
        sims = ex.apply_delta(table, d, fn, table.shape[0],
                              plan_provider=port_p.plan,
                              use_kernel=use_kernel, device="cpu")
        np.testing.assert_allclose(sims.numpy(), np.asarray(ref_sims),
                                   **TOL)
        dead = np.flatnonzero(~np.asarray(port_p.active))
        assert np.all(sims.numpy()[dead] == 0.0)
        assert np.all(sims.numpy()[:, dead] == 0.0)
    assert ex.stats() == ref_ex.stats()
    assert ex.sims.shape == ref_ex.sims.shape


@pytest.mark.parametrize("seed", [0])
def test_streamed_x2y_matrix_matches_reference(seed):
    rng = np.random.default_rng(seed)
    d, q = 8, 4.0
    wx = np.clip(rng.zipf(1.6, 24) / 8.0, 0.05, 0.45 * q)
    wy = np.clip(rng.zipf(1.6, 16) / 8.0, 0.05, 0.45 * q)
    X = rng.normal(size=(24, d)).astype(np.float32)
    Y = rng.normal(size=(16, d)).astype(np.float32)
    ref_p = ref_st.IncrementalX2YPlanner(q, wx=wx, wy=wy)
    port_p = st.IncrementalX2YPlanner(q, wx=wx, wy=wy)
    ref_ex, ex = ref_make_executor("streaming"), make_executor("streaming")
    ref_fn, fn = ref_block_fn_x2y("dot"), _block_fn_x2y("dot")
    ref_ex.run_x2y((jnp.asarray(X), jnp.asarray(Y)), ref_p.plan(), ref_fn,
                   (24, 16))
    got = ex.run_x2y((X, Y), port_p.plan(), fn, (24, 16), device="cpu")
    np.testing.assert_allclose(got.numpy(), X @ Y.T, **TOL)
    for _ in range(MATRIX_EDITS):
        op, args = _random_x2y_edit(port_p, rng, q)
        if op == "insert_x":
            X = np.concatenate([X, rng.normal(size=(1, d))
                                .astype(np.float32)])
        elif op == "insert_y":
            Y = np.concatenate([Y, rng.normal(size=(1, d))
                                .astype(np.float32)])
        rd, dd = getattr(ref_p, op)(*args), getattr(port_p, op)(*args)
        shape = (X.shape[0], Y.shape[0])
        ref = ref_ex.apply_delta_x2y((jnp.asarray(X), jnp.asarray(Y)), rd,
                                     ref_fn, shape, plan_provider=ref_p.plan)
        got = ex.apply_delta_x2y((X, Y), dd, fn, shape,
                                 plan_provider=port_p.plan, device="cpu")
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
        ax, ay = port_p.active_x_ids(), port_p.active_y_ids()
        np.testing.assert_allclose(got.numpy()[np.ix_(ax, ay)],
                                   X[ax] @ Y[ay].T, **TOL)
        dx = np.setdiff1d(np.arange(shape[0]), ax)
        dy = np.setdiff1d(np.arange(shape[1]), ay)
        assert np.all(got.numpy()[dx] == 0.0)
        assert np.all(got.numpy()[:, dy] == 0.0)
    assert ex.stats() == ref_ex.stats()


def test_x2y_scatter_never_reads_masked_slots():
    """Masked slots may hold indices outside either table; their -inf
    entries land on cell (0, 0), a real pair that amax leaves as it was."""
    out = torch.full((3, 4), 7.0)
    out[0, 0] = 5.0
    blocks = torch.arange(6, dtype=torch.float32).reshape(1, 2, 3) + 10.0
    xidx = torch.tensor([[2, 10**6]], dtype=torch.int32)
    xmask = torch.tensor([[True, False]])
    yidx = torch.tensor([[1, -5, 3]], dtype=torch.int32)
    ymask = torch.tensor([[True, False, True]])
    _scatter_blocks_x2y(out, blocks, xidx, xmask, yidx, ymask)
    want = torch.full((3, 4), 7.0)
    want[0, 0] = 5.0
    want[2, 1], want[2, 3] = 10.0, 12.0
    torch.testing.assert_close(out, want)


# ----------------------------------------------------------------- service
def _services(m=24, d=8, seed=0, **load_kw):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, d)).astype(np.float32)
    w = _profile("uniform", m, seed)
    ref = RefService(1.0, executor="streaming")
    port = PairwiseService(1.0, executor="streaming", device="cpu")
    out = []
    for svc in (port, ref):
        sims, info = svc.load_table(x, w, **load_kw)
        out.append((svc, sims, info))
    return rng, out


def _same_info(info, ref_info):
    assert set(info) == set(ref_info)
    assert {k: v for k, v in info.items() if k != "wall_s"} == \
        {k: v for k, v in ref_info.items() if k != "wall_s"}


def test_edit_api_roundtrip_matches_reference():
    rng, [(svc, sims, info), (ref, ref_sims, ref_info)] = _services(
        warmup=False)
    _same_info(info, ref_info)
    np.testing.assert_allclose(sims.numpy(), np.asarray(ref_sims), **TOL)
    edits = [("add_input", (rng.normal(size=8), 0.1)),
             ("add_input", (rng.normal(size=8), 0.3)),
             ("remove_input", (24,)), ("update_weight", (0, 0.2)),
             ("update_weight", (3, 0.33)), ("remove_input", (5,)),
             ("add_input", (rng.normal(size=8), 0.05))]
    for op, args in edits:
        sims, info = getattr(svc, op)(*args)
        ref_sims, ref_info = getattr(ref, op)(*args)
        _same_info(info, ref_info)
        np.testing.assert_allclose(sims.numpy(), np.asarray(ref_sims),
                                   **TOL)
    assert info["comm"]["measured_over_predicted"] == \
        ref_info["comm"]["measured_over_predicted"]
    assert svc.stats == {**ref.stats, "wall_s": svc.stats["wall_s"]}
    assert svc.executor_stats() == ref.executor_stats()
    assert np.all(sims.numpy()[24] == 0.0) and np.all(sims.numpy()[5] == 0.0)


def test_edits_require_streaming_executor():
    svc = PairwiseService(1.0, executor="bucketed", device="cpu")
    x = np.random.default_rng(0).normal(size=(8, 4)).astype(np.float32)
    with pytest.raises(AssertionError, match="streaming"):
        svc.load_table(x)
    assert svc._planner is None and svc._table is None


def test_failed_add_input_rolls_back_table():
    rng, [(svc, _, _), (ref, _, _)] = _services(warmup=False)
    row = rng.normal(size=8)
    for s in (svc, ref):
        m0 = s._table.shape[0]
        with pytest.raises(Exception) as err:
            s.add_input(row, weight=5.0)                # > q
        assert type(err.value).__name__ == "InfeasibleError"
        assert s._table.shape[0] == m0
    assert svc.stats["edits"] == ref.stats["edits"] == 0


def test_reset_stats_clears_both_coherently():
    rng, [(svc, _, _), _] = _services(warmup=False)
    svc.add_input(rng.normal(size=8), weight=0.1)
    assert svc.stats["requests"] > 0 and svc.stats["edits"] > 0
    assert svc.executor_stats()["calls"] > 0
    svc.reset_stats()
    assert all(v == 0 for v in svc.stats.values())
    assert all(v == 0 for v in svc.executor_stats().values())
    svc.add_input(rng.normal(size=8), weight=0.1)
    assert svc.stats["edits"] == 1 and svc.executor_stats()["calls"] == 1


def _live_oracle(svc):
    """x·xᵀ of the live rows with a zero diagonal, on the live block."""
    act = svc._planner.active_ids()
    xa = svc._table[act].astype(np.float64)
    g = xa @ xa.T
    np.fill_diagonal(g, 0.0)
    return g, act


def test_edits_during_background_replan_stay_correct():
    rng = np.random.default_rng(0)
    m = 64
    w = np.clip(rng.zipf(1.6, m) / 32.0, 0.01, 0.45)
    x = rng.normal(size=(m, 8)).astype(np.float32)
    svc = PairwiseService(1.0, executor="streaming", device="cpu")
    svc.load_table(x, w, warmup=False, max_gap=1.02, background=True)
    pending = 0
    for i in range(EDITS):
        act = svc._planner.active_ids()
        if i % 3 == 0:
            sims, info = svc.add_input(rng.normal(size=8), 0.05)
        else:
            sims, info = svc.remove_input(int(rng.choice(act)))
        pending += int(info["replan_pending"])
        assert not info["full_replan"]
        g, act = _live_oracle(svc)
        np.testing.assert_allclose(sims.numpy()[np.ix_(act, act)], g, **TOL)
        if pending and svc._planner._bg is not None:
            svc._planner._bg["thread"].join()      # lands on the next edit
    assert pending >= 1
    assert svc.stats["stream_swaps"] >= 1
    svc.flush_replan()
    svc._planner.snapshot().validate("a2a")
    assert svc.executor_stats()["full_builds"] == 1


def test_warmed_first_edit_builds_nothing_new():
    """The port's counterpart of the reference's "the first edit compiles
    nothing" (``tests/test_stream_tail.py``).  Upload-cache entries are
    keyed by plan, so each new sub-plan misses the cache by construction;
    what the first edit must not bring is a table signature that warmup
    did not serve, or an ``nvcc`` build."""
    rng = np.random.default_rng(0)
    m = 64
    w = np.clip(rng.zipf(1.6, m) / 32.0, 0.01, 0.45)
    x = rng.normal(size=(m, 8)).astype(np.float32)
    svc = PairwiseService(1.0, executor="streaming", use_kernel=True,
                          device="cpu")
    ref = RefService(1.0, executor="streaming")
    _, info0 = svc.load_table(x, w, warmup=True)
    _, ref_info0 = ref.load_table(x, w, warmup=False)
    assert svc._planner.algorithm.startswith("binpack")
    assert info0["warmed_shapes"] == len(ref._planner.delta_shapes()) > 0
    assert svc.executor_stats()["warmed_shapes"] == info0["warmed_shapes"]
    sigs, builds = table_signatures(), _build.build_counts()
    _, info = svc.add_input(rng.normal(size=(1, 8)), 0.2)
    assert table_signatures() == sigs
    assert _build.build_counts() == builds
    assert info["dirty_reducers"] >= 1
    _, info_off = PairwiseService(
        1.0, executor="streaming", device="cpu").load_table(x, w,
                                                            warmup=False)
    assert info_off["warmed_shapes"] == 0


def test_results_do_not_change_under_later_edits():
    """The maintained matrix is patched in place; what an edit returned
    stays as it was."""
    rng, [(svc, sims0, _), _] = _services(warmup=False)
    kept = [sims0.clone()]
    results = [sims0]
    for i in range(4):
        sims, _ = svc.add_input(rng.normal(size=8), 0.1) if i % 2 == 0 \
            else svc.remove_input(i)
        results.append(sims)
        kept.append(sims.clone())
    for got, want in zip(results, kept):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    ex = svc._executor
    assert all(r.untyped_storage().data_ptr()
               != ex.sims.untyped_storage().data_ptr() for r in results)


def test_streamed_equals_cold_dense_replan():
    """After the service's edits the live block equals a cold re-plan on
    the port's dense executor."""
    rng, [(svc, _, _), _] = _services(warmup=False)
    for i in range(4):
        sims, _ = svc.add_input(rng.normal(size=8), 0.12)
    act = svc._planner.active_ids()
    ref, _, _ = pairwise_similarity(
        svc._table[act], q=1.0, weights=svc._planner.active_weights(),
        executor="dense", device="cpu")
    torch.testing.assert_close(sims[np.ix_(act, act)], ref, **TOL)
