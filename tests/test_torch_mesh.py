"""``mesh=`` on the port's dense, bucketed, fused and streaming executors,
against the JAX package, on the CPU.

A mesh is a ``torch.distributed.ProcessGroup``: rank ``r`` of ``S`` runs
rows ``[r Rb/S, (r+1) Rb/S)`` of every bucket and the blocks are
all-gathered once per request, so every rank returns the whole result.

* One rank in process (a gloo group of one, made from a file store): the
  counterpart of ``tests/test_mapreduce_engine.py::
  test_run_reducers_mesh_single_device``, and ``mesh=None`` staying local
  on these executors while a default group is initialised (the sharded
  executor's ``mesh=None`` takes that group).
* 2 gloo ranks: the streaming service over the group, as
  ``tests/test_stream.py::test_streaming_on_multi_device_mesh`` runs it on
  a 2-device mesh (m=25, d=6, 4 ``add_input`` edits, 1e-4 to the dense
  executor).
* 8 gloo ranks, spawned once for this file (``compat.run_local_group``;
  the rank program is ``tests/_torch_ranks.py::mesh_paths``): dense,
  bucketed (also ``use_kernel=True``) and fused, each with the dot and
  cosine metrics, on A2A and X2Y.  Every rank's matrix is allclose to the
  port's ``mesh=None`` one at 1e-5 and to the reference's at its 1e-4;
  the plans equal the reference's ``pad_reducers_to=8`` plans and every
  ledger record the reference's record for the same call; each request
  makes one all-gather, ``mesh=None`` none; a plan not padded to 8 raises.
"""

import dataclasses
import datetime
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.mapreduce as ref_mr
import repro.mapreduce.executors as ref_ex
import repro_torch.mapreduce as port_mr
from repro.core import plan_a2a as ref_plan_a2a
from repro.core import plan_x2y as ref_plan_x2y
from repro.mapreduce.allpairs import _block_fn as ref_block_fn
from repro.mapreduce.allpairs import _block_fn_x2y as ref_block_fn_x2y
from repro.obs import LEDGER as REF_LEDGER
from repro_torch import compat
from repro_torch.compat import run_local_group
from repro_torch.core import plan_a2a
from repro_torch.mapreduce.allpairs import _block_fn
from repro_torch.obs import REGISTRY

import _torch_ranks

TIGHT = dict(rtol=1e-5, atol=1e-5)
REF_TOL = dict(rtol=1e-4, atol=1e-4)
RANKS = 8
M8, D8 = 48, 5
PATHS = [pytest.param(name, uk, metric,
                      id=f"{name}{'-kernel' if uk else ''}-{metric}")
         for name, uk in _torch_ranks.MESH_PATHS
         for metric in _torch_ranks.MESH_METRICS]


# ------------------------------------------------------ one rank, in process
@pytest.fixture(scope="module")
def one_rank():
    """A default gloo group of one rank in this process, for the module."""
    assert not dist.is_initialized()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "gloo", store=dist.FileStore(f"{tmp}/store", 1), rank=0,
            world_size=1, timeout=datetime.timedelta(seconds=60))
        try:
            yield dist.group.WORLD
        finally:
            dist.destroy_process_group()


def test_run_reducers_mesh_single_device(one_rank):
    """The reference's one-device mesh test: the table replicated, the
    reducer rows over the group; the output has one entry per plan row and
    equals the reference's."""
    mesh = jax.make_mesh((1,), ("data",))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(10, 4)).astype(np.float32)
    ref_plan = ref_mr.build_plan(ref_plan_a2a(np.full(10, 0.3), 1.0),
                                 pad_reducers_to=mesh.devices.size)
    plan = port_mr.build_plan(plan_a2a(np.full(10, 0.3), 1.0),
                              pad_reducers_to=dist.get_world_size(one_rank))
    want = ref_mr.run_reducers(
        jnp.asarray(x), ref_plan, lambda blk, msk: jnp.sum(blk * msk[:, None]),
        mesh=mesh)
    out = port_mr.run_reducers(
        x, plan, lambda blk, msk: torch.sum(blk * msk[:, None]),
        mesh=one_rank, device="cpu")
    assert out.shape == (plan.R,)
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TIGHT)


@pytest.mark.parametrize("executor",
                         ["dense", "bucketed", "fused", "streaming"])
def test_mesh_none_with_default_group_stays_local(one_rank, executor):
    """``mesh=None`` on these executors means no group although a default
    one is initialised: no collective runs.  On the sharded executor it
    means the default group, which all-gathers."""
    assert compat.reducer_group(None) == (None, 1, 0)
    assert compat.shard_group(None)[0] is one_rank
    x = np.random.default_rng(0).normal(size=(12, 3)).astype(np.float32)
    w = np.full(12, 0.2)

    def calls():
        return REGISTRY.counter_total("collective.calls")
    before = calls()
    local, _, _ = port_mr.pairwise_similarity(
        x, q=1.0, weights=w, executor=port_mr.make_executor(executor),
        device="cpu")
    assert calls() == before
    grouped, _, _ = port_mr.pairwise_similarity(
        x, q=1.0, weights=w, executor=port_mr.make_executor(executor),
        mesh=one_rank, device="cpu")
    assert calls() == before + 1
    np.testing.assert_allclose(grouped.numpy(), local.numpy(), **TIGHT)
    port_mr.pairwise_similarity(x, q=1.0, weights=w, executor="sharded",
                                device="cpu")
    assert calls() == before + 2


# ------------------------------------------------------ 2 ranks, streaming
def test_streaming_on_two_ranks():
    """``PairwiseService(executor='streaming', mesh=group)``: the planner
    pads the full plan and every delta sub-plan to 2 rows, the cold build
    and the edits split their rows over the ranks, and each rank's matrix
    equals the other's and the dense executor's on the live table."""
    rng = np.random.default_rng(0)
    m, d = 25, 6
    x = rng.normal(size=(m, d)).astype(np.float32)
    w = rng.uniform(0.05, 0.33, m)
    rows = rng.normal(size=(4, d)).astype(np.float32)
    results = run_local_group(_torch_ranks.stream_paths, 2, x, w, rows, 0.1,
                              timeout_s=120.0)
    first = results[0]
    act = first["active"]
    ref, _, _ = ref_mr.pairwise_similarity(
        jnp.asarray(first["table"]), q=1.0, weights=first["weights"],
        executor="dense")
    port, _, _ = port_mr.pairwise_similarity(
        first["table"], q=1.0, weights=first["weights"], executor="dense",
        device="cpu")
    for res in results:
        np.testing.assert_array_equal(res["active"], act)
        np.testing.assert_array_equal(res["sims"], first["sims"])
        got = res["sims"][np.ix_(act, act)]
        np.testing.assert_allclose(got, np.asarray(ref), **REF_TOL)
        np.testing.assert_allclose(got, port.numpy(), **REF_TOL)
        assert res["stats"]["full_builds"] == 1
        assert res["stats"]["delta_updates"] == 4
        assert res["all_gathers"] > 0
    assert len(first["recompute_fractions"]) == 4


# ------------------------------------------------------ 8 ranks, spawned
def _cases():
    rng = np.random.default_rng(0)
    w = np.clip(rng.zipf(1.7, M8) / 24.0, 0.02, 0.45)
    x = rng.normal(size=(M8, D8)).astype(np.float32)
    wx, wy = rng.uniform(0.05, 0.3, 21), rng.uniform(0.05, 0.3, 17)
    xx = rng.normal(size=(21, D8)).astype(np.float32)
    yy = rng.normal(size=(17, D8)).astype(np.float32)
    return (w, x), (wx, wy, xx, yy)


@pytest.fixture(scope="module")
def eight_ranks():
    pairs, x2y = _cases()
    results = run_local_group(_torch_ranks.mesh_paths, RANKS, pairs, x2y,
                              timeout_s=120.0)
    return pairs, x2y, results


@pytest.mark.parametrize("name,uk,metric", PATHS)
def test_eight_ranks_match_local_and_reference(eight_ranks, name, uk,
                                               metric):
    """Every rank's A2A and X2Y matrices against the port's ``mesh=None``
    ones and the reference's (``use_kernel=True`` is held against the
    reference's non-kernel path, the same products)."""
    (w, x), (wx, wy, xx, yy), results = eight_ranks
    local, _, _ = port_mr.pairwise_similarity(
        x, q=1.0, weights=w, metric=metric, executor=name, use_kernel=uk,
        device="cpu")
    local_x2y, _, _ = port_mr.x2y_similarity(
        xx, yy, q=1.0, wx=wx, wy=wy, metric=metric, executor=name,
        use_kernel=uk, device="cpu")
    ref, _, _ = ref_mr.pairwise_similarity(
        jnp.asarray(x), q=1.0, weights=w, metric=metric, executor=name)
    ref_x2y, _, _ = ref_mr.x2y_similarity(
        jnp.asarray(xx), jnp.asarray(yy), q=1.0, wx=wx, wy=wy,
        metric=metric, executor=name)
    for rank, res in enumerate(results):
        rec = res[(name, uk, metric)]
        msg = f"rank {rank}"
        np.testing.assert_allclose(rec["pairs"], local.numpy(), **TIGHT,
                                   err_msg=msg)
        np.testing.assert_allclose(rec["x2y"], local_x2y.numpy(), **TIGHT,
                                   err_msg=msg)
        np.testing.assert_allclose(rec["pairs"], np.asarray(ref), **REF_TOL,
                                   err_msg=msg)
        np.testing.assert_allclose(rec["x2y"], np.asarray(ref_x2y),
                                   **REF_TOL, err_msg=msg)
        np.testing.assert_allclose(rec["local"], local.numpy(), **TIGHT,
                                   err_msg=msg)


@pytest.mark.parametrize("name,uk,metric", PATHS)
def test_eight_ranks_gather_once_per_request(eight_ranks, name, uk, metric):
    """One all-gather for the A2A request and one for the X2Y request on
    every rank; none with ``mesh=None``."""
    for res in eight_ranks[2]:
        rec = res[(name, uk, metric)]
        assert rec["all_gathers"] == 2, rec["all_gathers"]
        assert rec["local_all_gathers"] == 0


def _assert_fields_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            _assert_fields_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, v) in enumerate(zip(got, want)):
            _assert_fields_equal(g, v, f"{path}[{i}]")
    elif isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=path)
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("name,uk,metric", PATHS)
def test_eight_ranks_plans_and_ledger_equal_reference(eight_ranks, name,
                                                      uk, metric):
    """The plans the ranks ran are the reference's plans padded to the
    group's size, and each rank's ledger records equal the reference's
    records for the same two calls (the ledger reads host plan arrays, so
    every rank records the whole plan: the ratio stays 1.0)."""
    (w, x), (wx, wy, xx, yy), results = eight_ranks
    ref_plan = ref_mr.build_plan(ref_plan_a2a(w, 1.0),
                                 pad_reducers_to=RANKS)
    ref_xplan = ref_mr.build_x2y_plan(ref_plan_x2y(wx, wy, 1.0), len(wx),
                                      pad_reducers_to=RANKS)
    plans = results[0][(name, uk, metric)]["plans"]
    _assert_fields_equal(plans[0], dataclasses.asdict(ref_plan))
    _assert_fields_equal(plans[1], dataclasses.asdict(ref_xplan))
    ex = ref_ex.make_executor(name)
    seq = REF_LEDGER.seq
    ex.run_pairs(jnp.asarray(x), ref_plan, ref_block_fn(metric, uk), M8)
    ex.run_x2y((jnp.asarray(xx), jnp.asarray(yy)), ref_xplan,
               ref_block_fn_x2y(metric), (len(wx), len(wy)))
    want = [_torch_ranks.ledger_fields(r) for r in REF_LEDGER.records(seq)]
    assert len(want) == 2
    for res in results:
        got = res[(name, uk, metric)]["ledger"]
        _assert_fields_equal(got, want)
        assert all(r["measured_slots"] == r["plan_slots"] for r in got)


@pytest.mark.parametrize("name,uk", _torch_ranks.MESH_PATHS)
def test_unpadded_plan_raises(eight_ranks, name, uk):
    """A plan whose bucket rows do not divide by the group's size raises
    ``ValueError`` naming ``pad_reducers_to`` on every rank, before any
    collective."""
    for res in eight_ranks[2]:
        msg = res[("uneven", name, uk)]
        assert f"pad_reducers_to={RANKS}" in msg, msg


def test_rank_rows_split_and_refuse():
    from repro_torch.mapreduce.engine import rank_rows
    assert [rank_rows(8, 4, r) for r in range(4)] == [
        slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]
    assert rank_rows(5, 1, 0) == slice(0, 5)
    with pytest.raises(ValueError, match="pad_reducers_to=3"):
        rank_rows(8, 3, 0)
