"""The hand-written CUDA kernels against their plain versions, on the card:
``fused_gather_gram`` (square), ``fused_gather_gram_rect`` (X2Y) and
``pairwise_gram`` (the ``use_kernel=True`` Gram block), and the paths that
run them.

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
from repro_torch.kernels import _build
from repro_torch.kernels.pairwise import fused_gather_gram as fgg_mod
from repro_torch.kernels.pairwise.fused_gather_gram import (
    fused_gather_gram,
    fused_gather_gram_rect,
    fused_gather_gram_rect_ref,
    fused_gather_gram_ref,
)
from repro_torch.kernels.pairwise.pairwise import (
    pairwise_gram,
    pairwise_gram_batched,
    pairwise_gram_ref,
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


def _launches(name):
    return _build.launch_counts().get(name, 0)


def _rect_inputs(seed, R, Lx, Ly, mx, my, d, dev, dtype=torch.float32,
                 p_valid=0.7):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(mx, d)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(my, d)).astype(np.float32))
    xidx = torch.from_numpy(rng.integers(0, mx, (R, Lx)).astype(np.int32))
    yidx = torch.from_numpy(rng.integers(0, my, (R, Ly)).astype(np.int32))
    xmask = torch.from_numpy(rng.uniform(size=(R, Lx)) < p_valid)
    ymask = torch.from_numpy(rng.uniform(size=(R, Ly)) < p_valid)
    return (x.to(dev, dtype), y.to(dev, dtype), xidx.to(dev),
            xmask.to(dev), yidx.to(dev), ymask.to(dev))


RECT_CASES = [
    (3, 8, 8, 31, 17, 6),
    (5, 19, 11, 31, 17, 40),
    (300, 1, 1, 40, 20, 33),       # 256 reducers per block, d % 32 != 0
    (257, 2, 2, 40, 30, 64),       # the balanced X2Y profile's bucket
    (129, 37, 1, 900, 60, 256),    # skew join: wide X, one Y row
    (65, 39, 2, 900, 60, 256),
    (17, 41, 32, 500, 500, 256),   # block serving: two X tiles
    (7, 2, 37, 64, 64, 256),
    (3, 130, 70, 300, 200, 64),    # five by three tiles
]


@pytest.mark.parametrize("R,Lx,Ly,mx,my,d", RECT_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rect_kernel_matches_plain(cuda, R, Lx, Ly, mx, my, d, dtype):
    dt = getattr(torch, dtype)
    args = _rect_inputs(R * 1000 + Lx * 10 + Ly, R, Lx, Ly, mx, my, d, cuda,
                        dt)
    before = _launches("fused_gather_gram_rect")
    got = fused_gather_gram_rect(*args)
    torch.cuda.synchronize()
    assert _launches("fused_gather_gram_rect") == before + 1
    assert got.shape == (R, Lx, Ly) and got.dtype == torch.float32
    torch.testing.assert_close(got, fused_gather_gram_rect_ref(*args),
                               **(FP32 if dtype == "float32" else BF16))


def test_rect_kernel_edges(cuda):
    x, y, xidx, xmask, yidx, ymask = _rect_inputs(2, 6, 9, 3, 20, 12, 40,
                                                  cuda)
    xmask[::2] = False                                # all-masked X rows
    xidx[~xmask] = 10 ** 6                            # never read
    got = fused_gather_gram_rect(x, y, xidx, xmask, yidx, ymask)
    assert float(got[::2].abs().max()) == 0.0
    torch.testing.assert_close(
        got, fused_gather_gram_rect_ref(x, y, xidx, xmask, yidx, ymask),
        **FP32)
    before = _launches("fused_gather_gram_rect")
    empty = fused_gather_gram_rect(x, y, xidx[:0], xmask[:0], yidx[:0],
                                   ymask[:0])
    assert empty.shape == (0, 9, 3)
    assert _launches("fused_gather_gram_rect") == before
    # overlapping row slices of one table, as block serving passes them
    t = torch.randn(50, 16, device=cuda)
    xs, ys = t[5:40], t[20:50]
    idx = torch.randint(0, 30, (8, 4), device=cuda, dtype=torch.int32)
    m = torch.ones((8, 4), dtype=torch.bool, device=cuda)
    torch.testing.assert_close(
        fused_gather_gram_rect(xs, ys, idx, m, idx, m),
        fused_gather_gram_rect_ref(xs, ys, idx, m, idx, m), **FP32)


PAIRWISE_CASES = [
    (1000, 1, 1, 64),
    (300, 2, 2, 33),
    (129, 4, 4, 256),
    (65, 8, 8, 256),
    (33, 16, 16, 256),
    (17, 32, 32, 256),
    (5, 37, 41, 256),
    (2, 130, 70, 100),
]


@pytest.mark.parametrize("B,M,N,K", PAIRWISE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pairwise_gram_matches_plain(cuda, B, M, N, K, dtype):
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(B * 7 + M)
    x = torch.randn(B, M, K, generator=g).to(cuda, dt)
    y = torch.randn(B, N, K, generator=g).to(cuda, dt)
    before = _launches("pairwise_gram")
    got = pairwise_gram_batched(x, y)
    torch.cuda.synchronize()
    assert _launches("pairwise_gram") == before + 1
    assert got.shape == (B, M, N) and got.dtype == torch.float32
    torch.testing.assert_close(got, pairwise_gram_ref(x, y),
                               **(FP32 if dtype == "float32" else BF16))


def test_pairwise_gram_under_vmap_is_one_launch(cuda):
    x = torch.randn(40, 12, 64, device=cuda)
    before = _launches("pairwise_gram")
    got = torch.func.vmap(lambda b: pairwise_gram(b, b))(x)
    assert _launches("pairwise_gram") == before + 1
    torch.testing.assert_close(got, pairwise_gram_ref(x, x), **FP32)
    single = pairwise_gram(x[3], x[5])
    torch.testing.assert_close(single, pairwise_gram_ref(x[3], x[5]),
                               **FP32)


@pytest.mark.parametrize("executor", ["dense", "bucketed"])
@pytest.mark.parametrize("metric", ["dot", "l2", "cosine"])
def test_use_kernel_pairwise_matches_fused_on_the_card(cuda, executor,
                                                       metric):
    rng = np.random.default_rng(5)
    m = 150
    w = np.clip(rng.zipf(1.6, m) / 32.0, 0.01, 0.45)
    x = rng.normal(size=(m, 48)).astype(np.float32)
    before = _launches("pairwise_gram")
    got, plan, _ = port_mr.pairwise_similarity(
        x, q=1.0, weights=w, metric=metric, executor=executor,
        use_kernel=True)
    assert _launches("pairwise_gram") - before == (
        1 if executor == "dense" else len(plan.buckets))
    want, _, _ = port_mr.pairwise_similarity(x, q=1.0, weights=w,
                                             metric=metric, executor="fused")
    # the kernel path's cosine clips at 1e-18, the fused one adds 1e-9:
    # both differ from the exact ratio far below this tolerance
    torch.testing.assert_close(got, want, **FP32)


@pytest.mark.parametrize("metric", ["dot", "l2", "cosine"])
def test_fused_x2y_matches_oracles_on_the_card(cuda, metric):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(300, 32)).astype(np.float32)
    y = rng.normal(size=(40, 32)).astype(np.float32)
    wx, wy = rng.uniform(0.01, 0.1, 300), rng.uniform(0.2, 0.45, 40)
    before = _launches("fused_gather_gram_rect")
    fused, plan, schema = port_mr.x2y_similarity(
        x, y, q=1.0, wx=wx, wy=wy, metric=metric, executor="fused")
    assert _launches("fused_gather_gram_rect") - before == len(plan.buckets)
    for oracle in ("bucketed", "dense"):
        want, _, _ = port_mr.x2y_similarity(x, y, q=1.0, schema=schema,
                                            metric=metric, executor=oracle)
        torch.testing.assert_close(fused, want, **FP32)
    cpu, _, _ = port_mr.x2y_similarity(x, y, q=1.0, schema=schema,
                                       metric=metric, executor="fused",
                                       device="cpu")
    torch.testing.assert_close(fused.cpu(), cpu, **FP32)


def test_block_serving_on_the_card(cuda):
    rng = np.random.default_rng(7)
    m = 400
    x = rng.normal(size=(m, 24)).astype(np.float32)
    w = rng.uniform(0.4, 2.0, m)
    svc = PairwiseService(q=18.0, executor="fused")
    svc.load_block_table(x, w)
    xt = torch.from_numpy(x).to(cuda)
    for i0, i1, j0, j1 in [(0, 128, 128, 256), (64, 200, 100, 400)]:
        before = _launches("fused_gather_gram_rect")
        blk, info = svc.block(i0, i1, j0, j1)
        assert blk.is_cuda and _launches("fused_gather_gram_rect") > before
        want = xt[i0:i1] @ xt[j0:j1].T
        lo, hi = max(i0, j0), min(i1, j1)
        d = torch.arange(lo, hi, device=cuda)
        want[d - i0, d - j0] = 0.0
        torch.testing.assert_close(blk, want, **FP32)
