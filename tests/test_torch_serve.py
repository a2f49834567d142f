"""The port's ``PairwiseService.similarity`` against the JAX package's.

Both services see the same requests (two weight profiles, each twice); the
matrices must agree at 1e-5 and every ``info`` entry must be equal, apart
from wall time and the cache internals (the port caches uploads, the
reference caches compiled programs).  The comm ledger's
measured/predicted ratio is exactly 1.0 on every executor.
"""

import numpy as np
import pytest
import torch

from repro.serve import PairwiseService as RefService
from repro_torch.serve import PairwiseService

SKIP = {"wall_s", "jit_cache"}


def _requests(m=22, d=6):
    out = []
    for seed in (101, 202):
        rng = np.random.default_rng(seed)
        w = np.clip(rng.zipf(1.7, m) / 24.0, 0.02, 0.45)
        x = rng.normal(size=(m, d)).astype(np.float32)
        out += [(x, w), (x, w.copy())]
    return out


@pytest.mark.parametrize("executor", ["dense", "bucketed", "fused"])
def test_similarity_matches_reference(executor):
    ref_svc = RefService(q=1.0, executor=executor, metric="cosine")
    svc = PairwiseService(q=1.0, executor=executor, metric="cosine",
                          device="cpu")
    for i, (x, w) in enumerate(_requests()):
        ref, ref_info = ref_svc.similarity(x, w)
        got, info = svc.similarity(x, w)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
        assert set(info) == set(ref_info)
        assert {k: v for k, v in info.items() if k not in SKIP} == \
            {k: v for k, v in ref_info.items() if k not in SKIP}
        assert info["comm"]["measured_over_predicted"] == 1.0
        assert set(info["jit_cache"]) == set(ref_info["jit_cache"])
        if i % 2:
            assert info["plan_cache_hit"]
    assert svc.stats["requests"] == 4
    assert svc.stats["plan_cache_hits"] == ref_svc.stats["plan_cache_hits"]
    if executor == "fused":
        assert info["fused_path"] == "streamed"         # plain version on CPU
        assert svc.executor_stats()["streamed"] == 4


def test_reset_stats_is_coherent():
    svc = PairwiseService(q=1.0, executor="fused", device="cpu")
    x, w = _requests()[0]
    svc.similarity(torch.from_numpy(x), w)
    assert svc.stats["requests"] == 1 and svc.executor_stats()["calls"] == 1
    svc.reset_stats()
    assert all(v == 0 for v in svc.stats.values())
    assert all(v == 0 for v in svc.executor_stats().values())
    assert svc.padding_savings == 0.0


def test_services_keep_private_counters():
    a = PairwiseService(q=1.0, executor="fused", device="cpu")
    b = PairwiseService(q=1.0, executor="fused", device="cpu")
    x, w = _requests()[0]
    a.similarity(x, w)
    assert a.executor_stats()["calls"] == 1
    assert b.executor_stats()["calls"] == 0
