"""The hand-written CUDA kernels against their plain versions, on the card.

Run on a machine with an NVIDIA card and nvcc:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Every test here skips (inside the ``cuda`` fixture, never at import) when
``torch.cuda.is_available()`` is false.

Tolerances: fp32 at rtol 1e-5 / atol 1e-4 — the kernel and the plain
``torch.bmm`` sum d products in different orders, which moves the result by
a few fp32 ulps of the largest partial sum; a TF32 product (10-bit
mantissa) misses this by orders of magnitude.  bf16 tables at 2e-2, as in
the reference.
"""

import numpy as np
import pytest
import torch

import repro_torch.mapreduce as port_mr
from repro_torch.kernels.pairwise import fused_gather_gram as fgg_mod
from repro_torch.kernels.pairwise.fused_gather_gram import (
    fused_gather_gram,
    fused_gather_gram_ref,
)
from repro_torch.serve import PairwiseService

pytestmark = pytest.mark.gpu

FP32 = dict(rtol=1e-5, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(seed, R, L, m, d, dev, dtype=torch.float32, p_valid=0.7):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, m, (R, L)).astype(np.int32))
    mask = torch.from_numpy(rng.uniform(size=(R, L)) < p_valid)
    return x.to(dev, dtype), idx.to(dev), mask.to(dev)


CASES = [
    (3, 5, 17, 8),          # single tile, ragged width
    (5, 16, 37, 16),
    (4, 24, 50, 12),
    (1, 1, 2, 4),           # minimal
    (300, 1, 40, 33),       # width 1: 256 reducers per block, d % 32 != 0
    (257, 2, 40, 64),       # R not a multiple of the block's reducers
    (129, 4, 80, 256),
    (65, 8, 80, 256),
    (17, 32, 500, 256),
    (7, 37, 64, 256),       # two tiles per side
    (3, 130, 300, 64),      # five tiles per side
]


@pytest.mark.parametrize("R,L,m,d", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain(cuda, R, L, m, d, dtype):
    dt = getattr(torch, dtype)
    x, idx, mask = _inputs(R * 1000 + L, R, L, m, d, cuda, dt)
    before = fgg_mod.launch_count()
    got = fused_gather_gram(x, idx, mask)
    torch.cuda.synchronize()
    assert fgg_mod.launch_count() == before + 1
    assert got.shape == (R, L, L) and got.dtype == torch.float32
    want = fused_gather_gram_ref(x, idx, mask)
    torch.testing.assert_close(got, want,
                               **(FP32 if dtype == "float32" else BF16))


def test_all_masked_rows_and_zero_reducers(cuda):
    x, idx, mask = _inputs(1, 6, 9, 20, 40, cuda)
    mask[::2] = False
    got = fused_gather_gram(x, idx, mask)
    assert float(got[::2].abs().max()) == 0.0
    torch.testing.assert_close(got, fused_gather_gram_ref(x, idx, mask),
                               **FP32)
    before = fgg_mod.launch_count()
    empty = fused_gather_gram(x, idx[:0], mask[:0])
    assert empty.shape == (0, 9, 9) and fgg_mod.launch_count() == before


def test_index_outside_the_table_gives_nan_not_a_fault(cuda):
    x, idx, mask = _inputs(3, 5, 6, 30, 16, cuda)
    mask[:] = True
    idx[2, 4] = 30                                    # one row past the table
    got = fused_gather_gram(x, idx, mask)
    torch.cuda.synchronize()
    bad = torch.zeros_like(got, dtype=torch.bool)
    bad[2, 4, :] = True
    bad[2, :, 4] = True
    assert bool(got[bad].isnan().all()) and not bool(got[~bad].isnan().any())
    idx[2, 4] = 0
    torch.testing.assert_close(got[~bad],
                               fused_gather_gram_ref(x, idx, mask)[~bad],
                               **FP32)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, idx, mask = _inputs(2, 3, 4, 10, 8, cuda)
    with pytest.raises(TypeError):
        fused_gather_gram(x.half(), idx, mask)
    with pytest.raises(TypeError):
        fused_gather_gram(x, idx.long(), mask)
    with pytest.raises(ValueError):
        fused_gather_gram(x.t().contiguous().t(), idx, mask)
    with pytest.raises(ValueError):
        fused_gather_gram(x, idx.cpu(), mask)


@pytest.mark.parametrize("metric", ["dot", "l2", "cosine"])
def test_fused_pairwise_matches_oracles_on_the_card(cuda, metric):
    rng = np.random.default_rng(3)
    m = 200
    w = np.clip(rng.zipf(1.6, m) / 32.0, 0.01, 0.45)
    x = rng.normal(size=(m, 64)).astype(np.float32)
    before = fgg_mod.launch_count()
    fused, plan, _ = port_mr.pairwise_similarity(
        x, q=1.0, weights=w, metric=metric, executor="fused")
    assert fused.is_cuda
    assert fgg_mod.launch_count() == before + len(plan.buckets)
    for oracle in ("bucketed", "dense"):
        want, _, _ = port_mr.pairwise_similarity(
            x, q=1.0, weights=w, metric=metric, executor=oracle)
        torch.testing.assert_close(fused, want, **FP32)
    cpu, _, _ = port_mr.pairwise_similarity(
        x, q=1.0, weights=w, metric=metric, executor="fused", device="cpu")
    torch.testing.assert_close(fused.cpu(), cpu, **FP32)


def test_service_reports_the_kernel_path(cuda):
    rng = np.random.default_rng(4)
    w = np.clip(rng.zipf(1.6, 120) / 32.0, 0.01, 0.45)
    x = rng.normal(size=(120, 32)).astype(np.float32)
    svc = PairwiseService(q=1.0, executor="fused")
    for i in range(2):
        sims, info = svc.similarity(x, w)
        assert sims.is_cuda and info["fused_path"] == "kernel"
        assert info["comm"]["measured_over_predicted"] == 1.0
    assert info["plan_cache_hit"]
    assert svc.executor_stats()["kernel"] == 2
