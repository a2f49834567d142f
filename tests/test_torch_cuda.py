"""The hand-written CUDA kernels against their plain versions, on the card:
``fused_gather_gram`` (square), ``fused_gather_gram_rect`` (X2Y),
``pairwise_gram`` (the ``use_kernel=True`` Gram block), ``flash_attention``
and ``ssd_scan`` (the LM prefill), and the paths that run them, the sharded
and coded executors' included (in one process, and on two gloo ranks
spawned on the one card).

Run on a machine with an NVIDIA card and nvcc:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Every test here skips (inside the ``cuda`` fixture, never at import) when
``torch.cuda.is_available()`` is false.

Tolerances: fp32 at rtol 1e-5 / atol 1e-4 — the kernel and the plain
``torch.bmm`` sum d products in different orders, which moves the result by
a few fp32 ulps of the largest partial sum; a TF32 product (10-bit
mantissa) misses this by orders of magnitude.  bf16 tables at 2e-2, as in
the reference.  The attention and SSD kernels are held at the reference's
own kernel tolerances (``tests/test_kernels.py``): 2e-4 in fp32 and 3e-2
in bf16; the LM prefill at the reference's model-level 2e-3.
"""

import dataclasses

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
from repro_torch.configs import get_config
from repro_torch.kernels.flash.flash_attention import (
    flash_attention,
    flash_attention_heads,
)
from repro_torch.kernels.flash.ref import mha_ref
from repro_torch.kernels.ssd.ops import ssd
from repro_torch.kernels.ssd.ssd import ssd_scan, ssd_scan_heads
from repro_torch.models import RuntimeFlags, build_model
from repro_torch.compat import run_local_group
from repro_torch.serve import BatchedServer, PairwiseService, Request

import _torch_ranks

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


def _check_square(x, idx, mask):
    got = fused_gather_gram(x, idx, mask)
    torch.cuda.synchronize()
    want = fused_gather_gram_ref(x, idx, mask)
    torch.testing.assert_close(
        got, want, **(FP32 if x.dtype == torch.float32 else BF16))
    return got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_every_width_up_to_32(cuda, dtype):
    """Every bucket width 1..32: the six tile widths T (1 to 32), the
    symmetric one-tile block with its mirrored stores, ragged widths
    inside a tile; R is never a multiple of the 128 / T reducers of a
    block."""
    dt = getattr(torch, dtype)
    for L in range(1, 33):
        x, idx, mask = _inputs(L, 131 + 7 * L, L, 300, 64, cuda, dt)
        _check_square(x, idx, mask)


@pytest.mark.parametrize("R,L,m,d,dtype", [
    (50, 20, 60, 33, "float32"),     # rows of 132 bytes: element loads
    (50, 20, 60, 100, "bfloat16"),   # rows of 200 bytes: element loads
    (9, 37, 80, 33, "float32"),      # unaligned rows, two tiles per side
    (5, 130, 300, 100, "bfloat16"),  # unaligned rows, five tiles per side
    (129, 16, 500, 256, "float32"),  # R past a whole number of blocks
    (33, 8, 64, 8, "bfloat16"),      # one vector per row
])
def test_kernel_unaligned_rows_and_partial_blocks(cuda, R, L, m, d, dtype):
    x, idx, mask = _inputs(R + d, R, L, m, d, cuda, getattr(torch, dtype))
    _check_square(x, idx, mask)


@pytest.mark.parametrize("L", [4, 16, 37, 130])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_all_masked_reducer_and_outside_index(cuda, L, dtype):
    """An all-masked reducer gives exact zeros; a valid index past the
    table gives NaN in its row and column only, also in the mirrored
    tiles of wide buckets (n_t > 1); the rest matches the plain version."""
    R, m = 6, 50
    x, idx, mask = _inputs(L, R, L, m, 40, cuda, getattr(torch, dtype))
    mask[1] = False
    mask[4, :] = True
    idx[4, L - 1] = m + 3                      # valid slot, outside
    got = fused_gather_gram(x, idx, mask)
    torch.cuda.synchronize()
    assert float(got[1].abs().max()) == 0.0
    bad = torch.zeros_like(got, dtype=torch.bool)
    bad[4, L - 1, :] = True
    bad[4, :, L - 1] = True
    assert bool(got[bad].isnan().all()) and not bool(got[~bad].isnan().any())
    idx[4, L - 1] = 0
    torch.testing.assert_close(
        got[~bad], fused_gather_gram_ref(x, idx, mask)[~bad],
        **(FP32 if dtype == "float32" else BF16))


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


def _valid_first(mask):
    """A mask as the planners build them: each row's valid slots first."""
    return mask.sort(dim=1, descending=True, stable=True).values


def _check_rect(args):
    got = fused_gather_gram_rect(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got, fused_gather_gram_rect_ref(*args),
        **(FP32 if args[0].dtype == torch.float32 else BF16))
    return got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rect_kernel_every_tile_pair(cuda, dtype):
    """Every tile pair (TM, TN) the dispatch picks (1 .. 32 a side, and a
    side of two tiles), on random masks (valid slots anywhere) and on
    valid-first masks (as the planners build them); R = 37 is no whole
    number of blocks for any pair."""
    dt = getattr(torch, dtype)
    widths = (1, 2, 3, 5, 9, 17, 33)
    seen = set()
    for Lx in widths:
        for Ly in widths:
            seen.add(fgg_mod.rect_tile_widths(Lx, Ly))
            args = list(_rect_inputs(Lx * 100 + Ly, 37, Lx, Ly, 60, 50, 40,
                                     cuda, dt))
            _check_rect(args)
            args[3], args[5] = _valid_first(args[3]), _valid_first(args[5])
            _check_rect(args)
    assert len(seen) == 36


@pytest.mark.parametrize("Lx,Ly", [(8, 1), (39, 2), (2, 2), (1, 3), (3, 3),
                                   (16, 32), (32, 16), (16, 38), (41, 16),
                                   (41, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rect_kernel_on_the_paths_bucket_shapes(cuda, Lx, Ly, dtype):
    """The X2Y and block serving buckets' shapes at d = 256, on
    valid-first masks as the planners build them."""
    args = list(_rect_inputs(Lx * 7 + Ly, 301, Lx, Ly, 900, 700, 256, cuda,
                             getattr(torch, dtype), p_valid=0.6))
    args[3], args[5] = _valid_first(args[3]), _valid_first(args[5])
    _check_rect(args)


@pytest.mark.parametrize("R,Lx,Ly", [(100_003, 2, 2), (20_001, 16, 32),
                                     (30_011, 8, 1)])
def test_rect_kernel_more_items_than_resident_blocks(cuda, R, Lx, Ly):
    """The persistent grid walks many items per block, and the last reducer
    group is partial."""
    _check_rect(_rect_inputs(R + Lx, R, Lx, Ly, 2000, 1500, 64, cuda))


@pytest.mark.parametrize("dtype,d", [("float32", 33), ("bfloat16", 100),
                                     ("float32", 64), ("bfloat16", 128)])
@pytest.mark.parametrize("side", ["x", "y"])
def test_rect_kernel_one_side_off_16_bytes(cuda, dtype, d, side):
    """One side's table starts off 16 bytes and the other does not: a slice
    at an odd row of a table whose rows are not 16-byte multiples (fp32
    d = 33, bf16 d = 100), or a table that begins one element into its
    buffer (fp32 d = 64, bf16 d = 128, rows of whole vectors)."""
    dt = getattr(torch, dtype)
    x, y, xidx, xmask, yidx, ymask = _rect_inputs(d, 70, 20, 12, 61, 41, d,
                                                  cuda, dt)
    t = x if side == "x" else y
    if d in (33, 100):
        big = torch.randn(t.shape[0] + 1, d, device=cuda).to(dt)
        big[1:] = t
        t = big[1:]
    else:
        buf = torch.empty(t.numel() + 1, device=cuda, dtype=dt)
        buf[1:] = t.reshape(-1)
        t = buf[1:].view(t.shape)
    assert t.data_ptr() % 16 != 0 and t.is_contiguous()
    args = (t, y, xidx, xmask, yidx, ymask) if side == "x" else (
        x, t, xidx, xmask, yidx, ymask)
    _check_rect(args)


@pytest.mark.parametrize("side", ["x", "y"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rect_kernel_outside_index_gives_nan_in_its_row_or_column(
        cuda, side, dtype):
    """A valid slot past its table, on a block of two tiles a side: NaN in
    its whole row (X) or column (Y), beside the other side's masked slots
    too (NaN times their zero rows, as in the square kernel), and nowhere
    else; the rest matches the plain version."""
    R, Lx, Ly, mx, my = 6, 41, 37, 50, 40
    x, y, xidx, xmask, yidx, ymask = _rect_inputs(
        7, R, Lx, Ly, mx, my, 40, cuda, getattr(torch, dtype))
    bad = torch.zeros((R, Lx, Ly), dtype=torch.bool, device=cuda)
    if side == "x":
        xmask[4, 35], xidx[4, 35] = True, mx + 3
        bad[4, 35, :] = True
    else:
        ymask[4, 30], yidx[4, 30] = True, my
        bad[4, :, 30] = True
    got = fused_gather_gram_rect(x, y, xidx, xmask, yidx, ymask)
    torch.cuda.synchronize()
    assert bool(got[bad].isnan().all()) and not bool(got[~bad].isnan().any())
    if side == "x":
        xidx[4, 35] = 0
    else:
        yidx[4, 30] = 0
    want = fused_gather_gram_rect_ref(x, y, xidx, xmask, yidx, ymask)
    torch.testing.assert_close(got[~bad], want[~bad],
                               **(FP32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rect_kernel_empty_and_short_reducers(cuda, dtype):
    """All-masked reducers give exact zeros; reducers whose valid slots
    fit a narrower tile (or end inside the first of two), in slot order and
    out of it, match the plain version."""
    R, Lx, Ly = 40, 41, 16
    x, y, xidx, xmask, yidx, ymask = _rect_inputs(
        11, R, Lx, Ly, 90, 70, 64, cuda, getattr(torch, dtype), p_valid=1.0)
    for r in range(R):
        nx, ny = (0, 3, 7, 31, 41)[r % 5], (0, 1, 5, 16)[r % 4]
        xmask[r, nx:], ymask[r, ny:] = False, False
        if r % 2:                        # valid slots not first
            xmask[r] = xmask[r].flip(0)
            ymask[r] = ymask[r].flip(0)
    got = _check_rect((x, y, xidx, xmask, yidx, ymask))
    empty = (xmask.sum(1) == 0) | (ymask.sum(1) == 0)
    assert bool(empty.any()) and float(got[empty].abs().max()) == 0.0


@pytest.mark.parametrize("Lx,Ly", [(8, 2), (16, 32), (41, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rect_kernel_non_finite_rows_match_the_plain_version(
        cuda, Lx, Ly, dtype):
    """Tables with Inf and NaN rows: a masked slot stands for a zero row in
    the kernel as in the plain version, so its entries beside an Inf or NaN
    row are NaN, and beside finite rows zero."""
    R, mx, my = 50, 60, 40
    x, y, xidx, xmask, yidx, ymask = _rect_inputs(
        Lx + Ly, R, Lx, Ly, mx, my, 64, cuda, getattr(torch, dtype))
    x[3, 5], x[7, 0], y[2, 63] = float("inf"), float("-inf"), float("nan")
    xidx[:, 0], xmask[:, 0] = 3, True          # an Inf row in every reducer
    yidx[::2, 0], ymask[::2, 0] = 2, True      # a NaN row in half of them
    xidx[1::3, -1] = 7
    ymask[:, -1] = False                       # masked beside the Inf rows
    got = fused_gather_gram_rect(x, y, xidx, xmask, yidx, ymask)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got, fused_gather_gram_rect_ref(x, y, xidx, xmask, yidx, ymask),
        equal_nan=True, **(FP32 if dtype == "float32" else BF16))
    assert bool(got[:, 0, -1].isnan().all())
    finite = ~(xmask[:, :, None] & ymask[:, None, :]) & \
        torch.isfinite(fgg_mod.gather_rows(x, xidx, xmask)).all(-1)[
            :, :, None] & \
        torch.isfinite(fgg_mod.gather_rows(y, yidx, ymask)).all(-1)[
            :, None, :]
    assert bool(finite.any()) and float(got[finite].abs().max()) == 0.0


def test_rect_kernel_same_slice_same_plan(cuda):
    """x and y the same row slice of one table with the same idx and mask
    (block serving's diagonal block): the rect kernel agrees with the
    plain version and with the square kernel."""
    t = torch.randn(300, 64, device=cuda)
    xs = t[7:207]
    rng = np.random.default_rng(5)
    idx = torch.from_numpy(rng.integers(0, 200, (90, 16)).astype(
        np.int32)).to(cuda)
    mask = _valid_first(torch.from_numpy(
        rng.uniform(size=(90, 16)) < 0.7).to(cuda))
    got = _check_rect((xs, xs, idx, mask, idx, mask))
    torch.testing.assert_close(got, fused_gather_gram(xs, idx, mask),
                               **FP32)


PAIRWISE_CASES = [
    (1000, 1, 1, 64),       # B not a multiple of the 32 reducers per block
    (300, 2, 2, 33),        # rows off 16 bytes: element loads
    (129, 4, 4, 256),
    (65, 8, 8, 256),
    (33, 16, 16, 256),
    (77, 16, 16, 256),      # 77 = 9 blocks of 8 reducers + 5
    (17, 32, 32, 256),
    (13, 32, 32, 100),      # 13 = 3 blocks of 4 reducers + 1; K % 8 != 0
    (5, 37, 41, 256),
    (2, 130, 70, 100),
]


def _spy_launches(monkeypatch):
    """Record the arguments of every ``_build.launch`` call."""
    seen = []
    real = _build.launch

    def spy(name, argtypes, args, what=""):
        seen.append((name, args))
        return real(name, argtypes, args, what)
    monkeypatch.setattr(_build, "launch", spy)
    return seen


@pytest.mark.parametrize("B,M,N,K", PAIRWISE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["self", "distinct"])
def test_pairwise_gram_matches_plain(cuda, monkeypatch, B, M, N, K, dtype,
                                     route):
    """``(x, x)`` takes the self-Gram route (one pointer, the flag set),
    distinct ``(x, y)`` the two-table one; both equal the plain version."""
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(B * 7 + M)
    x = torch.randn(B, M, K, generator=g).to(cuda, dt)
    y = x if route == "self" else torch.randn(B, N, K, generator=g).to(
        cuda, dt)
    seen = _spy_launches(monkeypatch)
    before = _launches("pairwise_gram")
    got = pairwise_gram_batched(x, y)
    torch.cuda.synchronize()
    assert _launches("pairwise_gram") == before + 1
    (name, args), = seen
    assert name == "pairwise_gram"
    if route == "self":
        assert args[1] is None and args[8] == 1      # y not passed, flag set
    else:
        assert args[1] == y.data_ptr() and args[8] == 0
    assert got.shape == (B, M, y.shape[1]) and got.dtype == torch.float32
    torch.testing.assert_close(got, pairwise_gram_ref(x, y),
                               **(FP32 if dtype == "float32" else BF16))
    if route == "self":
        # the same values as the two-table route on a copy of x
        torch.testing.assert_close(got, pairwise_gram_batched(x, x.clone()),
                                   **(FP32 if dtype == "float32" else BF16))


def test_pairwise_gram_under_vmap_is_one_launch(cuda, monkeypatch):
    x = torch.randn(40, 12, 64, device=cuda)
    seen = _spy_launches(monkeypatch)
    before = _launches("pairwise_gram")
    got = torch.func.vmap(lambda b: pairwise_gram(b, b))(x)
    assert _launches("pairwise_gram") == before + 1
    assert seen[-1][1][1] is None              # the vmap rule's views: self
    torch.testing.assert_close(got, pairwise_gram_ref(x, x), **FP32)
    single = pairwise_gram(x[3], x[5])
    torch.testing.assert_close(single, pairwise_gram_ref(x[3], x[5]),
                               **FP32)


def test_pairwise_gram_expanded_batch(cuda):
    """An unbatched side under vmap reaches the kernel as a stride-0
    ``expand``; so does an expanded batch passed as both sides."""
    w = torch.randn(12, 64, device=cuda)
    ys = torch.randn(30, 9, 64, device=cuda)
    got = torch.func.vmap(lambda b: pairwise_gram(w, b))(ys)
    torch.testing.assert_close(got, pairwise_gram_ref(w.expand(30, 12, 64),
                                                      ys), **FP32)
    e = w.expand(30, 12, 64)
    assert e.stride(0) == 0
    torch.testing.assert_close(pairwise_gram_batched(e, e),
                               pairwise_gram_ref(e, e), **FP32)


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


# ------------------------------------------- some-pairs and streaming paths
def test_some_pairs_on_the_card_equals_the_cpu(cuda):
    rng = np.random.default_rng(3)
    m = 300
    x = rng.normal(size=(m, 24)).astype(np.float32)
    w = rng.uniform(0.02, 0.2, m)
    sig = x @ rng.normal(size=(24, 3)).astype(np.float32) > 0
    code = sig @ np.array([1, 2, 4])
    pairs = [(i, j) for i in range(m) for j in range(i + 1, m)
             if code[i] == code[j]]
    svc = PairwiseService(q=1.0, executor="fused", metric="cosine")
    before = _launches("fused_gather_gram")
    sims, info = svc.some_pairs(x, pairs, w)
    assert info["fused_path"] == "kernel"
    assert _launches("fused_gather_gram") - before == \
        len(info["bucket_widths"])
    cpu = PairwiseService(q=1.0, executor="fused", metric="cosine",
                          device="cpu").some_pairs(x, pairs, w)[0]
    torch.testing.assert_close(sims.cpu(), cpu, **FP32)


def _stream_edits(svc, rng, d, n=8):
    out = []
    for i in range(n):
        act = svc._planner.active_ids()
        if i % 3 == 0:
            out.append(svc.add_input(rng.normal(size=d), 0.1))
        elif i % 3 == 1:
            out.append(svc.remove_input(int(act[i])))
        else:
            out.append(svc.update_weight(int(act[i]), 0.15))
    return out


def test_streaming_edits_on_the_card_equal_the_cpu(cuda):
    """The same edit sequence with ``use_kernel=True`` on the card and on
    the CPU: every patched matrix equal; the cold build launches
    ``fused_gather_gram``, executed deltas ``pairwise_gram``."""
    rng = np.random.default_rng(0)
    m, d = 96, 16
    w = np.clip(rng.zipf(1.6, m) / 32.0, 0.01, 0.45)
    x = rng.normal(size=(m, d)).astype(np.float32)
    runs = {}
    for dev in ("cuda", "cpu"):
        svc = PairwiseService(1.0, executor="streaming", use_kernel=True,
                              device=dev)
        before = dict(_build.launch_counts())
        sims, _ = svc.load_table(x, w, warmup=False)
        if dev == "cuda":
            assert _build.launch_counts().get("fused_gather_gram", 0) > \
                before.get("fused_gather_gram", 0)
        before = _launches("pairwise_gram")
        runs[dev] = [sims] + [s for s, _ in _stream_edits(
            svc, np.random.default_rng(1), d)]
        if dev == "cuda":
            assert _launches("pairwise_gram") > before
    for got, want in zip(runs["cuda"], runs["cpu"]):
        assert got.is_cuda
        torch.testing.assert_close(got.cpu(), want, **FP32)


def test_warmed_first_edit_builds_no_library(cuda):
    rng = np.random.default_rng(0)
    m, d = 64, 16
    w = np.clip(rng.zipf(1.6, m) / 32.0, 0.01, 0.45)
    x = rng.normal(size=(m, d)).astype(np.float32)
    svc = PairwiseService(1.0, executor="streaming", use_kernel=True)
    _build.reset_launch_counts()
    _, info = svc.load_table(x, w, warmup=True)
    assert info["warmed_shapes"] > 0
    assert _launches("pairwise_gram") >= info["warmed_shapes"]
    builds, sigs = _build.build_counts(), port_mr.table_signatures()
    _, info = svc.add_input(rng.normal(size=d), 0.2)
    assert info["dirty_reducers"] >= 1
    assert _build.build_counts() == builds
    assert port_mr.table_signatures() == sigs


# ------------------------------------------------ sharded and coded paths
def _zipf_case(seed=0, m=300, d=64):
    rng = np.random.default_rng(seed)
    w = np.clip(rng.zipf(1.6, m) / 32.0, 0.01, 0.45)
    return w, rng.normal(size=(m, d)).astype(np.float32)


def _skew_case(seed=1, mx=400, my=40, d=64):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.01, 0.1, mx), rng.uniform(0.2, 0.45, my),
            rng.normal(size=(mx, d)).astype(np.float32),
            rng.normal(size=(my, d)).astype(np.float32))


@pytest.mark.parametrize("executor", ["sharded", "coded"])
def test_one_shard_matches_fused_on_the_card(cuda, executor):
    """One shard (no process group): every Gram launch against its plain
    version, the matrices against the fused executor's."""
    w, x = _zipf_case()
    xt = torch.from_numpy(x).to(cuda)
    wx, wy, xx, yy = _skew_case()
    X, Y = torch.from_numpy(xx).to(cuda), torch.from_numpy(yy).to(cuda)
    with _torch_ranks.KernelSpy() as spy:
        got = port_mr.pairwise_similarity(xt, q=1.0, weights=w,
                                          executor=executor)[0]
        got_x2y = port_mr.x2y_similarity(X, Y, q=1.0, wx=wx, wy=wy,
                                         executor=executor)[0]
    errs = spy.max_errs()
    rect = "fused_gather_gram_rect"
    assert set(errs) == ({rect} if executor == "coded"
                         else {"fused_gather_gram", rect}), errs
    want = port_mr.pairwise_similarity(xt, q=1.0, weights=w,
                                       executor="fused")[0]
    want_x2y = port_mr.x2y_similarity(X, Y, q=1.0, wx=wx, wy=wy,
                                      executor="fused")[0]
    assert got.is_cuda and got_x2y.is_cuda
    torch.testing.assert_close(got, want, **FP32)
    torch.testing.assert_close(got_x2y, want_x2y, **FP32)


def test_two_gloo_ranks_on_the_card(cuda):
    """Two gloo ranks spawned on the one card: every launch in each rank
    against its plain version, each rank's matrices against the fused
    ones, and no rank runs nvcc (the libraries are built first)."""
    _build.build_all(("fused_gather_gram", "fused_gather_gram_rect"))
    w, x = _zipf_case()
    skew = _skew_case()
    results = run_local_group(_torch_ranks.cuda_paths, 2, w, x, *skew,
                              timeout_s=120.0)
    xt = torch.from_numpy(x).to(cuda)
    want = port_mr.pairwise_similarity(xt, q=1.0, weights=w,
                                       executor="fused")[0].cpu()
    wx, wy, xx, yy = skew
    want_x2y = port_mr.x2y_similarity(
        torch.from_numpy(xx).to(cuda), torch.from_numpy(yy).to(cuda),
        q=1.0, wx=wx, wy=wy, executor="fused")[0].cpu()
    for res in results:
        assert sum(res["builds"].values()) == 0, res["builds"]
        assert set(res["kernels"]) == {"fused_gather_gram",
                                       "fused_gather_gram_rect"}
        for name in ("sharded", "coded"):
            torch.testing.assert_close(torch.from_numpy(res[name]), want,
                                       **FP32)
        torch.testing.assert_close(torch.from_numpy(res["sharded_x2y"]),
                                   want_x2y, **FP32)


# ------------------------------------------------------ LM prefill kernels

ATTN = dict(rtol=2e-4, atol=2e-4)
ATTN_BF16 = dict(rtol=3e-2, atol=3e-2)


def _normal(rng, shape, dev, dtype):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        dev, dtype)


FLASH_CASES = [
    # B, Sq, Skv, Hq, Hkv, D, causal, window
    (2, 100, 100, 4, 2, 64, True, 0),      # ragged S, GQA
    (1, 128, 128, 2, 2, 128, True, 0),     # one tile exactly
    (1, 200, 200, 4, 1, 256, True, 0),     # MQA, D=256
    (2, 77, 77, 2, 2, 128, True, 16),      # causal sliding window
    (1, 300, 300, 8, 2, 128, True, 100),   # window skips whole kv tiles
    (1, 90, 130, 2, 2, 64, False, 0),      # non-causal, Sq != Skv
    (1, 96, 96, 4, 2, 128, False, 20),     # two-sided window
    (1, 1, 1, 1, 1, 64, True, 0),          # one token
    # the tensor-core kernel's edges: 128-row q tiles, 128-row kv tiles
    (1, 129, 129, 2, 1, 128, True, 0),     # one row past a q tile
    (2, 255, 255, 2, 2, 64, True, 0),      # one row short of two q tiles
    (1, 100, 300, 4, 2, 128, False, 0),    # Skv crosses kv tiles, Sq != Skv
    (1, 200, 260, 2, 1, 64, True, 0),      # causal, Sq != Skv
    (1, 400, 400, 2, 1, 128, True, 200),   # window ends inside a kv tile
    (1, 300, 300, 2, 2, 64, False, 150),   # two-sided, inside a kv tile
    (1, 256, 256, 16, 2, 128, True, 0),    # Hq / Hkv = 8, as in Jamba
    (1, 448, 448, 20, 20, 64, True, 0),    # whisper's decoder: MHA, 20 heads
    (1, 300, 300, 12, 2, 128, True, 0),    # G = 6 as in internvl2; one row
]                                          # past two q tiles


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,causal,window", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain(cuda, B, Sq, Skv, Hq, Hkv, D, causal,
                                    window, dtype):
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(Sq * 7 + Skv + D)
    q = _normal(rng, (B, Sq, Hq, D), cuda, dt)
    k = _normal(rng, (B, Skv, Hkv, D), cuda, dt)
    v = _normal(rng, (B, Skv, Hkv, D), cuda, dt)
    before = _launches("flash_attention")
    got = flash_attention_heads(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert _launches("flash_attention") == before + 1
    want = mha_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == dt and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(),
                               **(ATTN if dtype == "float32" else ATTN_BF16))


def test_flash_kernel_reads_strided_heads(cuda):
    """q, k, v as slices of one packed (B, S, 3, H, D) tensor: the kernel
    reads their strides, the result equals the contiguous inputs'."""
    rng = np.random.default_rng(5)
    qkv = _normal(rng, (2, 150, 3, 4, 128), cuda, torch.float32)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    got = flash_attention_heads(q, k, v, causal=True)
    want = flash_attention_heads(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    one = flash_attention(q[0, :, 1], k[0, :, 1], v[0, :, 1], causal=True)
    torch.testing.assert_close(one, got[0, :, 1], rtol=0, atol=0)


def test_flash_bf16_kernel_reads_strided_heads(cuda):
    """bf16 q, k, v as slices of one packed (B, S, 3, H, D) tensor: the
    tensor maps see non-contiguous strides (multiples of 16 bytes, heads
    nearer than rows); the result equals the contiguous inputs' exactly
    and the plain version's within tolerance."""
    rng = np.random.default_rng(11)
    for D in (64, 128):
        qkv = _normal(rng, (2, 150, 3, 4, D), cuda, torch.bfloat16)
        q, k, v = qkv.unbind(2)
        assert not q.is_contiguous() and q.stride(1) * 2 % 16 == 0
        got = flash_attention_heads(q, k, v, causal=True)
        want = flash_attention_heads(q.contiguous(), k.contiguous(),
                                     v.contiguous(), causal=True)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        torch.testing.assert_close(
            got.float(), mha_ref(q, k, v, causal=True).float(), **ATTN_BF16)


def test_flash_bf16_rows_off_16_bytes_take_the_fma_kernel(cuda):
    """bf16 rows that do not start on a 16-byte boundary cannot be staged
    as vectors for the tensor-core kernel: the FMA kernel runs them, and
    both agree with the plain version."""
    rng = np.random.default_rng(9)
    q, k, v = (_normal(rng, (2, 130, 4, 128), cuda, torch.bfloat16)
               for _ in range(3))
    buf = torch.empty(q.numel() + 4, dtype=q.dtype, device=cuda)
    q_off = buf[4:].view(q.shape)                 # 8 bytes off
    q_off.copy_(q)
    assert q_off.data_ptr() % 16 == 8
    want = mha_ref(q, k, v, causal=True).float()
    fast = flash_attention_heads(q, k, v, causal=True)
    slow = flash_attention_heads(q_off, k, v, causal=True)
    torch.testing.assert_close(fast.float(), want, **ATTN_BF16)
    torch.testing.assert_close(slow.float(), want, **ATTN_BF16)


SSD_CASES = [
    # B, S, H, P, N, chunk
    (2, 300, 3, 64, 128, 128),   # ragged last chunk, the model's widths
    (1, 64, 2, 64, 16, 16),      # the reduced configs' widths
    (1, 7, 2, 32, 8, 8),         # S below the chunk
    (2, 100, 3, 8, 8, 32),
    (1, 129, 2, 64, 128, 128),   # one row into the second chunk
]


def _ssd_inputs(rng, B, S, H, P, N, dev, dtype, decay=None):
    x = _normal(rng, (B, S, H, P), dev, dtype)
    b = _normal(rng, (B, S, H, N), dev, dtype) * N ** -0.5
    c = _normal(rng, (B, S, H, N), dev, dtype) * N ** -0.5
    la = (torch.full((B, S, H), decay) if decay is not None else
          -torch.from_numpy(np.abs(rng.normal(size=(B, S, H)))
                            .astype(np.float32)))
    return x, la.to(dev), b, c


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_matches_plain(cuda, B, S, H, P, N, chunk, dtype):
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(S * 3 + N + P)
    x, la, b, c = _ssd_inputs(rng, B, S, H, P, N, cuda, dt)
    before = _launches("ssd_scan")
    got = ssd_scan_heads(x, la, b, c, chunk=chunk)
    torch.cuda.synchronize()
    assert _launches("ssd_scan") == before + 1
    want = ssd(x, la, b, c, chunk=chunk, impl="chunked")
    assert got.dtype == dt and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(),
                               **(ATTN if dtype == "float32" else ATTN_BF16))


def test_ssd_kernel_carries_state_across_chunks(cuda):
    """Near-zero decay: every chunk's output depends on all earlier ones;
    held against the literal per-step recurrence."""
    rng = np.random.default_rng(0)
    x, la, b, c = _ssd_inputs(rng, 1, 520, 2, 64, 128, cuda, torch.float32,
                              decay=-0.01)
    got = ssd_scan_heads(x, la, b, c, chunk=128)
    want = ssd(x, la, b, c, impl="step")
    torch.testing.assert_close(got, want, **ATTN)
    one = ssd_scan(x[0, :, 1], la[0, :, 1], b[0, :, 1], c[0, :, 1])
    torch.testing.assert_close(one, got[0, :, 1], rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_reads_broadcast_bc(cuda, dtype):
    """One B and one C for all heads, as ``mamba_apply`` passes them: head
    stride 0, not copied; the result equals the materialised inputs'."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(3)
    B, S, H, P, N = 2, 257, 8, 64, 128
    x, la, _, _ = _ssd_inputs(rng, B, S, H, P, N, cuda, dt)
    b1 = _normal(rng, (B, S, N), cuda, dt) * N ** -0.5
    c1 = _normal(rng, (B, S, N), cuda, dt) * N ** -0.5
    bh = b1[:, :, None, :].expand(B, S, H, N)
    ch = c1[:, :, None, :].expand(B, S, H, N)
    assert bh.stride(2) == 0
    got = ssd_scan_heads(x, la, bh, ch)
    want = ssd_scan_heads(x, la, bh.contiguous(), ch.contiguous())
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(
        got.float(), ssd(x, la, bh, ch, impl="chunked").float(),
        **(ATTN if dtype == "float32" else ATTN_BF16))


# the bf16 kernel's contract in chip_smoke.py: one bf16 step of the output
SSD_BF16 = dict(rtol=2e-2, atol=2e-3)


@pytest.mark.parametrize("S", [1, 300, 4096])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", ["few", "many"])
def test_ssd_kernel_head_groups(cuda, S, shared, dtype, heads):
    """Broadcast B / C and per-head B / C (one head per block), with a
    head count that is not a multiple of the head group; S of one row, a
    ragged last chunk and the model's 4096.  With broadcast B / C the bf16
    kernel takes two heads per block unless one ends sooner: at B = 2, 5
    heads take one per block and 2 SMs - 1 heads take two (the same number
    of head-times either way), the last block of each row with one."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(S + 7 * shared)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    B, H, P, N = 2, 5 if heads == "few" else 2 * sms - 1, 64, 128
    x, la, b, c = _ssd_inputs(rng, B, S, H, P, N, cuda, dt)
    if shared:
        b = b[:, :, :1].expand(B, S, H, N)
        c = c[:, :, :1].expand(B, S, H, N)
    before = _launches("ssd_scan")
    got = ssd_scan_heads(x, la, b, c)
    torch.cuda.synchronize()
    assert _launches("ssd_scan") == before + 1
    want = ssd(x, la, b, c, impl="chunked")
    torch.testing.assert_close(
        got.float(), want.float(),
        **(ATTN if dtype == "float32" else SSD_BF16))


@pytest.mark.parametrize("shared", [True, False])
def test_ssd_bf16_rows_off_16_bytes_take_element_loads(cuda, shared):
    """Widths that are not a multiple of 8 elements and an x that starts 2
    bytes past a 16-byte boundary: the bf16 kernel stages them by element
    loads into the same tiles and stores y element by element."""
    rng = np.random.default_rng(11)
    B, S, H, P, N = 1, 150, 3, 36, 20
    wide = _normal(rng, (B, S, H, P + 1), cuda, torch.bfloat16)
    x = wide[..., 1:]                         # unit stride, base off 16
    _, la, b, c = _ssd_inputs(rng, B, S, H, P, N, cuda, torch.bfloat16)
    if shared:
        b = b[:, :, :1].expand(B, S, H, N)
        c = c[:, :, :1].expand(B, S, H, N)
    got = ssd_scan_heads(x, la, b, c, chunk=64)
    want = ssd(x, la, b, c, chunk=64, impl="chunked")
    torch.testing.assert_close(got.float(), want.float(), **SSD_BF16)


def test_ssd_bf16_32k_holds_the_state(cuda):
    """bf16 at the prefill_32k length (256 chunks of 128) on a few heads
    sharing B and C, with a decay slow enough that the state carries
    across many chunks: the fp32 state and its bf16 products do not drift
    from the plain chunked scan."""
    rng = np.random.default_rng(32)
    B, S, H, P, N = 1, 32768, 3, 64, 128
    x, la, b, c = _ssd_inputs(rng, B, S, H, P, N, cuda, torch.bfloat16)
    la = la * 2e-4           # about exp(-0.02) per chunk of 128 steps
    b = b[:, :, :1].expand(B, S, H, N)
    c = c[:, :, :1].expand(B, S, H, N)
    got = ssd_scan_heads(x, la, b, c)
    want = ssd(x, la, b, c, impl="chunked")
    torch.testing.assert_close(got.float(), want.float(), **SSD_BF16)


def test_lm_kernel_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 8, 2, 96), device=cuda)
    with pytest.raises(ValueError, match="head width"):
        flash_attention_heads(q, q, q)
    q = torch.zeros((1, 8, 2, 64), device=cuda)
    with pytest.raises(TypeError):
        flash_attention_heads(q, q.bfloat16(), q.bfloat16())
    x = torch.zeros((1, 8, 2, 64), device=cuda)
    la = torch.zeros((1, 8, 2), device=cuda)
    wide = torch.zeros((1, 8, 2, 256), device=cuda)
    with pytest.raises(ValueError, match="N=256"):
        ssd_scan_heads(x, la, wide, wide)
    with pytest.raises(ValueError, match="chunk=256"):
        ssd_scan_heads(x, la, x, x, chunk=256)


def test_refused_launches_raise(cuda):
    """A grid past the card's limit (B > 65,535 on a grid axis that allows
    no more) is refused; the wrappers raise instead of returning garbage,
    and count no launch."""
    q = torch.zeros((65536, 1, 1, 64), device=cuda)
    before = _build.launch_counts()
    with pytest.raises(RuntimeError, match="flash_attention launch failed"):
        flash_attention_heads(q, q, q)
    x = torch.zeros((65536, 1, 1, 64), device=cuda)
    la = torch.zeros((65536, 1, 1), device=cuda)
    with pytest.raises(RuntimeError, match="ssd_scan launch failed"):
        ssd_scan_heads(x, la, x, x)
    assert _build.launch_counts() == before


def _small_lm(cuda, use_pallas, dtype="float32"):
    # the reduced Jamba with 64-wide heads: the kernel is built for 64, 128
    # and 256 (the reduced configs' 16 runs only on the plain route)
    cfg = dataclasses.replace(get_config("jamba-1.5-large-398b-smoke"),
                              head_dim=64)
    flags = RuntimeFlags(param_dtype=dtype, compute_dtype=dtype,
                         use_pallas=use_pallas)
    return cfg, build_model(cfg, flags, device=cuda, seed=0)


def test_lm_prefill_goes_through_both_kernels(cuda):
    cfg, model = _small_lm(cuda, True)
    _, plain = _small_lm(cuda, False)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 150))).to(cuda)
    _build.reset_launch_counts()
    got, _, _ = model({"tokens": tokens})
    torch.cuda.synchronize()
    kinds = [k["mixer"] for k in cfg.layer_kinds()]
    counts = _build.launch_counts()
    assert counts.get("flash_attention", 0) == kinds.count("attn")
    assert counts.get("ssd_scan", 0) == kinds.count("mamba")
    want, _, _ = plain({"tokens": tokens})
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)


def test_batched_server_on_the_card(cuda):
    cfg, model = _small_lm(cuda, True, "bfloat16")
    rng = np.random.default_rng(0)
    server = BatchedServer(model, batch_slots=2, max_len=32)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab_size, n)
                    .astype(np.int32), max_new_tokens=4)
            for i, n in enumerate((3, 7, 5))]
    for r in reqs:
        server.submit(r)
    server.run()
    assert all(r.done and len(r.out) == 4 for r in reqs)
    assert all(0 <= t < cfg.padded_vocab() for r in reqs for t in r.out)


def _frontend_lm(arch, dev, use_pallas):
    """A reduced encoder-decoder / vision config with 64-wide heads (the
    kernel's smallest width; the reduced configs' 16 runs only on the
    plain route), fp32, the same weights on every device (seed 0 on the
    CPU, copied), and a batch with the stub frontend's embeddings."""
    cfg = dataclasses.replace(get_config(arch), head_dim=64)
    flags = RuntimeFlags(param_dtype="float32", compute_dtype="float32",
                         use_pallas=use_pallas)
    model = build_model(cfg, flags, device="cpu", seed=0)
    if dev != "cpu":
        model = model.to(dev)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 150)))}
    if cfg.frontend == "audio":
        batch["audio_embeds"] = torch.from_numpy(rng.normal(
            size=(2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    else:
        batch["image_embeds"] = torch.from_numpy(rng.normal(
            size=(2, cfg.num_frontend_tokens, cfg.d_model)).astype(
                np.float32))
    return cfg, model, {k: v.to(dev) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ["whisper-large-v3-smoke",
                                  "internvl2-26b-smoke"])
def test_frontend_prefill_on_the_card_matches_the_cpu(cuda, arch):
    """The kernel-route prefill on the card (flash once per decoder layer;
    the encoder and cross-attention on plain attention) against the CPU
    (plain versions) on the same weights, at the model-level 2e-3."""
    cfg, model, batch = _frontend_lm(arch, cuda, True)
    _, cpu_model, cpu_batch = _frontend_lm(arch, "cpu", True)
    _build.reset_launch_counts()
    got, _, _ = model(batch)
    torch.cuda.synchronize()
    assert _build.launch_counts() == {"flash_attention": cfg.num_layers}
    want, _, _ = cpu_model(cpu_batch)
    assert got.shape == want.shape == (2, 150, cfg.padded_vocab())
    torch.testing.assert_close(got.cpu(), want, rtol=2e-3, atol=2e-3)


# ------------------------------------------------------------------ training

def test_kernel_wrappers_refuse_autograd_on_the_card(cuda):
    """Neither LM kernel has a backward: with autograd on and an operand
    that requires grad, the wrappers raise before any launch instead of
    cutting the gradient."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((1, 32, 2, 64), generator=g, device=cuda)
               for _ in range(3))
    x = torch.randn((1, 32, 2, 64), generator=g, device=cuda)
    b = torch.randn((1, 32, 2, 16), generator=g, device=cuda)
    la = -torch.rand((1, 32, 2), generator=g, device=cuda)
    before = _build.launch_counts()
    with pytest.raises(RuntimeError, match=r"use_pallas=False"):
        flash_attention_heads(q.requires_grad_(True), k, v)
    with pytest.raises(RuntimeError, match=r"use_pallas=False"):
        ssd_scan_heads(x.requires_grad_(True), la, b, b)
    assert _build.launch_counts() == before


@pytest.mark.parametrize("arch", ["whisper-large-v3-smoke",
                                  "internvl2-26b-smoke"])
def test_frontend_loss_on_the_kernel_route_raises_on_the_card(cuda, arch):
    """Autograd through the kernel route refuses on the card, before any
    launch, with the encoder and the frontend's embeds in the batch."""
    _, model, batch = _frontend_lm(arch, cuda, True)
    model.requires_grad_(True)
    batch["targets"] = batch["tokens"]
    before = _build.launch_counts()
    with pytest.raises(RuntimeError, match=r"use_pallas=False"):
        model.loss(batch)
    assert _build.launch_counts() == before


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b-smoke",
                                  "gemma3-4b-smoke", "mamba2-370m-smoke"])
def test_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """One fp32 train step (remat 'full', microbatch 2) from the same
    weights on both devices, at the reference's parameter tolerance."""
    from repro_torch.train import AdamWConfig, init_state, make_train_step
    cfg = get_config(arch)
    flags = RuntimeFlags(param_dtype="float32", compute_dtype="float32",
                         use_pallas=False, remat="full")
    opt = AdamWConfig(warmup_steps=0, peak_lr=1e-3)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 32)),
             "targets": rng.integers(0, cfg.vocab_size, (4, 32)),
             "mask": (rng.random((4, 32)) > 0.2).astype(np.float32)}
    models = {d: build_model(cfg, flags, device=d) for d in ("cpu", cuda)}
    states = {d: init_state(m, opt) for d, m in models.items()}
    models[cuda].load_state_dict(models["cpu"].state_dict())
    out = {d: make_train_step(m, opt, microbatch=2)(states[d], batch)
           for d, m in models.items()}
    (cst, cm), (gst, gm) = out["cpu"], out[cuda]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(gm[k]), float(cm[k]), rtol=2e-3,
                                   atol=2e-4)
    for part in ("params", "m", "v"):
        got = gst["params"] if part == "params" else gst["opt"][part]
        want = cst["params"] if part == "params" else cst["opt"][part]
        for n, w in want.items():
            torch.testing.assert_close(got[n].detach().cpu(), w.detach(),
                                       rtol=2e-3, atol=2e-4)


def test_memory_counter_matches_the_allocator(cuda):
    """The dry run's live-storage counter (``launch.op_analysis``) on a
    small bf16 train step on the card (remat 'full', the backward on
    autograd's device thread) against the caching allocator: its peak
    within 5% of ``max_memory_allocated``'s high-water above the
    arguments, after a warm-up step that makes cuBLAS's workspaces."""
    from repro_torch.launch.dryrun import cell_step
    from repro_torch.launch.op_analysis import count_ops
    from repro_torch.launch.specs import default_flags
    cfg = get_config("stablelm-1.6b-smoke")
    run, _ = cell_step(cfg, "train_4k", default_flags(cfg, "train_4k"),
                       seq_batch=(512, 8), device=cuda)
    run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _, st = count_ops(run, device="cuda")
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - base
    assert abs(st.live_peak - measured) <= 0.05 * measured, \
        (st.live_peak, measured)


def _scratch_case(name: str, contiguous: bool, dev):
    """``(op, args)``: one op of the counter's scratch table on operands of
    the plain attention's size (8 x 4 x 512 x 512 fp32) or the Mamba
    conv's (4 x 2048 x 1027 bf16), contiguous or not."""
    aten = torch.ops.aten
    if name.startswith("convolution"):
        D, S = 2048, 1024
        x = torch.randn(4, S + 3, D, device=dev, dtype=torch.bfloat16)
        x = x.transpose(1, 2).contiguous() if contiguous else x.transpose(1, 2)
        w = torch.randn(D, 1, 4, device=dev, dtype=torch.bfloat16)
        conv = (x, w, None, [1], [0], [1], False, [0], D)
        if name == "convolution":
            return aten.convolution.default, conv
        go = torch.randn(4, D, S, device=dev, dtype=torch.bfloat16)
        return aten.convolution_backward.default, (
            go, *conv[:2], None, *conv[3:], [True, True, False])
    c = torch.randn(8, 4, 512, 512, device=dev)
    x = c if contiguous else torch.randn(8, 512, 4, 512,
                                         device=dev).transpose(1, 2)
    return {
        "_softmax": (aten._softmax.default, (x, -1, False)),
        "_log_softmax": (aten._log_softmax.default, (x, -1, False)),
        "_softmax_backward_data": (aten._softmax_backward_data.default, (
            x, torch.softmax(c, -1), -1, torch.float32)),
        "_log_softmax_backward_data": (
            aten._log_softmax_backward_data.default,
            (x, torch.log_softmax(c, -1), -1, torch.float32)),
        "logsumexp": (aten.logsumexp.default, (x, [-1], False)),
    }[name]


@pytest.mark.parametrize("contiguous", [True, False])
@pytest.mark.parametrize("name", [
    "_softmax", "_log_softmax", "_softmax_backward_data",
    "_log_softmax_backward_data", "logsumexp", "convolution",
    "convolution_backward"])
def test_kernel_scratch_matches_the_allocator(cuda, name, contiguous):
    """The scratch the dry run's counter adds while an op runs
    (``op_analysis._SCRATCH``) against the caching allocator's high-water
    during the op above its start and its end, within 1% of the operand
    (logsumexp's row maxima, 0.2%, are not modelled)."""
    from repro_torch.launch.op_analysis import _SCRATCH, _dense
    op, args = _scratch_case(name, contiguous, cuda)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = op(*args)
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    scratch = torch.cuda.max_memory_allocated() - max(before, after)
    del out
    want = _SCRATCH[name](args)
    assert abs(scratch - want) <= 0.01 * _dense(args[0]), (scratch, want)


def test_checkpoint_restores_onto_the_card(cuda, tmp_path):
    """A state saved from the CPU restores onto the card bit for bit, bf16
    included."""
    from repro_torch.train import CheckpointManager
    state = {"params": {"w": torch.randn(8, 8),
                        "b": torch.randn(8).to(torch.bfloat16)},
             "step": torch.tensor(3, dtype=torch.int32)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, state)
    restored, manifest = mgr.restore(device=cuda)
    assert manifest["step"] == 3
    for k in ("w", "b"):
        t = restored["params"][k]
        assert t.device.type == "cuda" and t.dtype == state["params"][k].dtype
        assert torch.equal(t.cpu(), state["params"][k])
    assert int(restored["step"]) == 3


# ------------------------------------------- kernels on a mesh's local heads
@pytest.fixture
def one_rank_mesh(cuda, tmp_path):
    """A one-rank NCCL group (file store) and its 1 x 1 ('data', 'model')
    mesh."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), device_type="cuda")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_under_local_map_on_a_one_rank_mesh(one_rank_mesh, dtype):
    """``per_head`` hands each kernel plain local tensors (never a DTensor)
    and returns a DTensor placed as the query; the launch counts rise by
    one per call."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.models.lm import distribute_tensor
    from repro_torch.parallel.local import per_head
    mesh = one_rank_mesh
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(2, 128, 8, 64, device="cuda", generator=g).to(dtype)
    k = torch.randn(2, 128, 2, 64, device="cuda", generator=g).to(dtype)
    v = torch.randn(2, 128, 2, 64, device="cuda", generator=g).to(dtype)
    pl = (Shard(0), Shard(2))
    qd, kd, vd = (distribute_tensor(t, mesh, pl) for t in (q, k, v))
    seen = []
    real = flash_ops.flash_attention_heads

    def spy(*a, **kw):
        seen.append([type(t) for t in a])
        return real(*a, **kw)
    flash_ops.flash_attention_heads = spy
    _build.reset_launch_counts()
    try:
        out = per_head(flash_ops.mha, qd, kd, vd, causal=True,
                       use_kernel=True)
    finally:
        flash_ops.flash_attention_heads = real
    assert isinstance(out, DTensor) and tuple(out.placements) == pl
    assert seen == [[torch.Tensor] * 3]
    assert _build.launch_counts().get("flash_attention") == 1
    tol = dict(rtol=2e-4, atol=2e-4) if dtype == torch.float32 \
        else dict(rtol=3e-2, atol=3e-2)
    torch.testing.assert_close(out.to_local().float(), mha_ref(
        q, k, v, causal=True).float(), **tol)
    x = torch.randn(2, 256, 4, 64, device="cuda", generator=g).to(dtype)
    la = -torch.rand(2, 256, 4, device="cuda", generator=g)
    b = torch.randn(2, 256, 1, 16, device="cuda", generator=g).to(dtype)
    b = b.expand(2, 256, 4, 16)
    c = b.clone()
    xd = distribute_tensor(x, mesh, pl)
    lad = distribute_tensor(la, mesh, pl)
    bd, cd = (distribute_tensor(t, mesh, (Shard(0), Replicate()))
              for t in (b, c))
    y = per_head(ssd, xd, lad, bd, cd, use_kernel=True)
    assert _build.launch_counts().get("ssd_scan") == 1
    want = ssd(x, la, b, c, use_kernel=False, impl="chunked")
    torch.testing.assert_close(y.to_local().float(), want.float(),
                               **(dict(rtol=2e-4, atol=2e-4)
                                  if dtype == torch.float32 else
                                  dict(rtol=3e-2, atol=3e-2)))


@pytest.mark.parametrize("H,Hkv,ranks", [(8, 2, 2), (6, 2, 3), (48, 1, 16),
                                         (4, 4, 2)])
def test_flash_on_local_heads_reads_the_global_kv_head(cuda, H, Hkv, ranks):
    """The KV heads ``per_head`` selects for model-rank r's query heads
    (global heads r·H/ranks ..) when the KV heads are replicated: the
    kernel on them equals the global attention's slice — the GQA offset
    of a split query against whole KV heads."""
    from repro_torch.parallel.local import _head_select
    g = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn(1, 96, H, 64, device="cuda", generator=g)
    k = torch.randn(1, 96, Hkv, 64, device="cuda", generator=g)
    v = torch.randn(1, 96, Hkv, 64, device="cuda", generator=g)
    want = mha_ref(q, k, v, causal=True)
    h_loc, G = H // ranks, H // Hkv
    for r in range(ranks):
        need = (r * h_loc + torch.arange(h_loc)) // G
        sel = _head_select(need, 2)
        got = flash_attention_heads(q[:, :, r * h_loc:(r + 1) * h_loc],
                                    sel(k), sel(v), causal=True)
        torch.testing.assert_close(
            got, want[:, :, r * h_loc:(r + 1) * h_loc], rtol=2e-4,
            atol=2e-4)
