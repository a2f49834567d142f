"""The port's planner copy and plan substrate against the JAX package.

The same numpy weights go through ``repro.core.plan_a2a`` and the port's
copy in ``repro_torch.core``; schemas, costs and ``build_plan`` arrays must
be identical, and ``plan_from_arrays`` must rebuild a reference plan
exactly (so both packages can run one plan).
"""

import dataclasses

import numpy as np
import pytest

import repro.core as ref_core
import repro.mapreduce.engine as ref_engine
import repro_torch.core as port_core
import repro_torch.mapreduce.engine as port_engine


def _weights(kind: str, m: int, seed: int, q: float = 1.0):
    rng = np.random.default_rng(seed)
    return {
        "uniform": lambda: rng.uniform(0.05, 0.33, m),
        "zipf": lambda: np.clip(rng.zipf(1.7, m) / 24.0, 0.02, 0.45 * q),
        "one-giant": lambda: np.concatenate(
            [[0.8 * q], rng.uniform(0.02, 0.1, m - 1)]),
    }[kind]()


PROFILES = ["uniform", "zipf", "one-giant"]
SIZES = [7, 40]


def _assert_plans_equal(a, b):
    assert a.idx.dtype == b.idx.dtype and a.mask.dtype == b.mask.dtype
    assert a.idx.tobytes() == b.idx.tobytes()
    assert a.mask.tobytes() == b.mask.tobytes()
    assert (a.num_reducers, a.max_inputs, a.algorithm) == \
        (b.num_reducers, b.max_inputs, b.algorithm)
    assert a.comm_cost == b.comm_cost and a.lower_bound == b.lower_bound
    assert a.bucket_widths() == b.bucket_widths()
    for ba, bb in zip(a.buckets, b.buckets, strict=True):
        assert ba.rows.dtype == bb.rows.dtype
        for f in ("rows", "idx", "mask"):
            assert getattr(ba, f).tobytes() == getattr(bb, f).tobytes(), f
    assert a.dense_padded_elements == b.dense_padded_elements
    assert a.bucketed_padded_elements == b.bucketed_padded_elements


@pytest.mark.parametrize("m", SIZES)
@pytest.mark.parametrize("kind", PROFILES)
def test_planner_copy_matches_reference(kind, m):
    w = _weights(kind, m, seed=m + 1)
    ref = ref_core.plan_a2a(w, 1.0)
    port = port_core.plan_a2a(w, 1.0)
    assert port.expand() == ref.expand()
    assert port.algorithm == ref.algorithm
    assert port.communication_cost() == ref.communication_cost()
    assert port.lower_bound == ref.lower_bound


@pytest.mark.parametrize("m", SIZES)
@pytest.mark.parametrize("kind", PROFILES)
def test_build_plan_byte_equal(kind, m):
    w = _weights(kind, m, seed=m + 2)
    ref = ref_engine.build_plan(ref_core.plan_a2a(w, 1.0))
    port = port_engine.build_plan(port_core.plan_a2a(w, 1.0))
    _assert_plans_equal(port, ref)


@pytest.mark.parametrize("kind", PROFILES)
def test_plan_from_arrays_rebuilds_reference_plan(kind):
    w = _weights(kind, 29, seed=3)
    ref = ref_engine.build_plan(ref_core.plan_a2a(w, 1.0))
    port = port_engine.plan_from_arrays(dataclasses.asdict(ref))
    _assert_plans_equal(port, ref)
    assert port.optimality_gap == ref.optimality_gap
    assert port.padding_savings == ref.padding_savings


def test_build_plan_padding_matches_reference():
    w = _weights("zipf", 23, seed=9)
    kw = dict(pad_reducers_to=4, pad_slots_to=8, max_buckets=2)
    ref = ref_engine.build_plan(ref_core.plan_a2a(w, 1.0), **kw)
    port = port_engine.build_plan(port_core.plan_a2a(w, 1.0), **kw)
    _assert_plans_equal(port, ref)
    assert all(b.R % 4 == 0 for b in port.buckets)


def test_compute_buckets_copy_matches_reference():
    counts = np.random.default_rng(0).integers(1, 40, 200)
    ref = ref_core.compute_buckets(counts, max_buckets=3)
    port = port_core.compute_buckets(counts, max_buckets=3)
    assert [w for w, _ in port] == [w for w, _ in ref]
    for (_, a), (_, b) in zip(port, ref):
        np.testing.assert_array_equal(a, b)


def test_plan_cache_hits_on_repeat_profile():
    w = _weights("uniform", 31, seed=17)
    port_core.plan_a2a(w, 1.0)
    hits = port_core.PLAN_CACHE.hits
    port_core.plan_a2a(w[::-1].copy(), 1.0)     # a permutation: same profile
    assert port_core.PLAN_CACHE.hits == hits + 1
