"""The port's ``fused_gather_gram`` (plain version on the CPU) against the
JAX package's Pallas kernel in interpret mode, its materializing oracle and
its streamed twin, at the reference's own cases and tolerances: fp32 1e-5
(``tests/test_fused_executor.py``), bf16 2e-2.

The CUDA kernel itself runs only on the card: see ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.pairwise.fused_gather_gram import (
    fused_gather_gram as jax_fused_gather_gram,
)
from repro.kernels.pairwise.fused_gather_gram import (
    fused_gather_gram_ref as jax_fused_gather_gram_ref,
)
from repro.kernels.pairwise.fused_gather_gram import (
    fused_gather_gram_streamed as jax_fused_gather_gram_streamed,
)
from repro_torch.kernels import _build
from repro_torch.kernels.pairwise import fused_gather_gram as fgg_mod
from repro_torch.kernels.pairwise.fused_gather_gram import (
    fused_gather_gram,
    fused_gather_gram_ref,
)


def _inputs(seed, R, L, m, d, p_valid=0.7):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, d)).astype(np.float32)
    idx = rng.integers(0, m, (R, L)).astype(np.int32)
    mask = rng.uniform(size=(R, L)) < p_valid
    return x, idx, mask


def _port(x, idx, mask, dtype=torch.float32):
    return fused_gather_gram(torch.from_numpy(x).to(dtype),
                             torch.from_numpy(idx), torch.from_numpy(mask))


@pytest.mark.parametrize("R,L,m,d,bl", [
    (3, 5, 17, 8, 8),          # single tile, ragged width
    (5, 16, 37, 16, 8),        # two row tiles
    (4, 24, 50, 12, 8),        # three row tiles
    (1, 1, 2, 4, 8),           # minimal
])
def test_plain_matches_pallas_interpret(R, L, m, d, bl):
    x, idx, mask = _inputs(R * 100 + L, R, L, m, d)
    ref = jax_fused_gather_gram(jnp.asarray(x), jnp.asarray(idx),
                                jnp.asarray(mask), bl=bl, interpret=True)
    got = _port(x, idx, mask)
    assert got.dtype == torch.float32 and got.shape == (R, L, L)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("L,bl", [(5, 8), (20, 8), (37, 16)])
def test_plain_matches_streamed_and_ref(L, bl):
    x, idx, mask = _inputs(L, 6, L, 29, 8, p_valid=0.6)
    args = (jnp.asarray(x), jnp.asarray(idx), jnp.asarray(mask))
    streamed = jax_fused_gather_gram_streamed(*args, bl=bl)
    ref = jax_fused_gather_gram_ref(*args)
    got = _port(x, idx, mask).numpy()
    np.testing.assert_allclose(got, np.asarray(streamed), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_bf16_table_matches_pallas_interpret():
    x, idx, mask = _inputs(0, 4, 18, 31, 16)
    ref = jax_fused_gather_gram(jnp.asarray(x, jnp.bfloat16),
                                jnp.asarray(idx), jnp.asarray(mask), bl=16,
                                interpret=True)
    got = _port(x, idx, mask, torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_all_masked_rows_are_zero():
    x, idx, _ = _inputs(1, 3, 6, 11, 4)
    mask = np.zeros((3, 6), bool)
    mask[1, :4] = True                         # rows 0 and 2 all-masked
    got = _port(x, idx, mask).numpy()
    assert np.abs(got[[0, 2]]).max() == 0.0
    ref = jax_fused_gather_gram_ref(jnp.asarray(x), jnp.asarray(idx),
                                    jnp.asarray(mask))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert np.abs(got[1, 4:]).max() == 0.0 and np.abs(got[1, :, 4:]).max() \
        == 0.0


@pytest.mark.parametrize("L", [1, 7])
def test_zero_reducers_give_empty_blocks(L):
    x = torch.ones((5, 3))
    got = fused_gather_gram(x, torch.zeros((0, L), dtype=torch.int32),
                            torch.zeros((0, L), dtype=torch.bool))
    assert got.shape == (0, L, L) and got.dtype == torch.float32


def test_cpu_wrapper_is_the_plain_version_and_launches_nothing():
    x, idx, mask = _inputs(5, 4, 9, 13, 6)
    before = fgg_mod.launch_count()
    got = _port(x, idx, mask)
    plain = fused_gather_gram_ref(torch.from_numpy(x), torch.from_numpy(idx),
                                  torch.from_numpy(mask))
    assert torch.equal(got, plain)
    assert fgg_mod.launch_count() == before


def test_non_cuda_device_raises():
    x = torch.empty((4, 3), device="meta")
    idx = torch.zeros((2, 2), dtype=torch.int32, device="meta")
    mask = torch.ones((2, 2), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_gather_gram(x, idx, mask)


def test_shape_mismatch_raises():
    with pytest.raises(ValueError):
        fused_gather_gram(torch.ones((4, 3)),
                          torch.zeros((2, 3), dtype=torch.int32),
                          torch.ones((2, 4), dtype=torch.bool))


@pytest.mark.parametrize("L,T", [(1, 1), (2, 2), (3, 4), (4, 4), (5, 8),
                                 (16, 16), (17, 32), (32, 32), (37, 32),
                                 (130, 32)])
def test_tile_width(L, T):
    assert fgg_mod.tile_width(L) == T


@pytest.mark.parametrize("R,L", [(7, 3), (5, 32), (4, 37), (3, 130)])
def test_gather_bytes_counts_the_kernels_staged_rows(R, L):
    """``gather_bytes`` against the kernel's schedule walked item by item:
    tile pairs it <= jt, one staged side on the diagonal, two off it, and
    only valid slots read from the table."""
    rng = np.random.default_rng(R * L)
    mask = rng.uniform(size=(R, L)) < 0.6
    d, item = 24, 4
    T = fgg_mod.tile_width(L)
    n_t = -(-L // T)
    rows = 0
    for r in range(R):
        for it in range(n_t):
            for jt in range(it, n_t):
                sides = (it,) if it == jt else (it, jt)
                for tile in sides:
                    slots = range(tile * T, min(L, tile * T + T))
                    rows += sum(bool(mask[r, s]) for s in slots)
    assert fgg_mod.gather_bytes(mask, d, item) == rows * d * item
    assert fgg_mod.gather_bytes(torch.from_numpy(mask), d, item) == \
        rows * d * item


# ---------------------------------------------------------------------------
# the rect kernel's host helpers and semantics: tile choice, gather bytes,
# masked slots beside non-finite rows
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("Lx,Ly,tiles", [
    (1, 1, (1, 1)), (8, 1, (8, 1)), (39, 2, (32, 2)), (2, 2, (2, 2)),
    (1, 3, (1, 4)), (3, 3, (4, 4)), (16, 32, (16, 32)), (41, 16, (32, 16)),
    (5, 17, (8, 32)), (130, 70, (32, 32)),
])
def test_rect_tile_widths(Lx, Ly, tiles):
    assert fgg_mod.rect_tile_widths(Lx, Ly) == tiles


def test_rect_tile_widths_follow_the_kernel_source():
    """The Python mirror of the kernel's dispatch reads the same TMIN /
    TMAX as ``csrc/fused_gather_gram_rect.cu``."""
    import re
    src = (_build.CSRC_DIR / "fused_gather_gram_rect.cu").read_text()
    tmin = int(re.search(r"constexpr int TMIN = (\d+);", src).group(1))
    tmax = int(re.search(r"constexpr int TMAX = (\d+);", src).group(1))
    assert (fgg_mod.RECT_TMIN, fgg_mod.RECT_TMAX) == (tmin, tmax)
    with pytest.raises(ValueError):
        fgg_mod.rect_tile_widths(0, 3)


@pytest.mark.parametrize("R,Lx,Ly", [(4, 3, 2), (3, 8, 1), (2, 39, 2),
                                     (3, 16, 32), (2, 41, 5)])
def test_rect_plain_masked_slot_is_a_zero_row_beside_non_finite_rows(
        R, Lx, Ly):
    """The semantics the rect kernel shares with the plain version and the
    JAX reference: a masked slot stands for a zero row, so its entries are
    zero beside finite rows and NaN beside an Inf or NaN row (0 * Inf);
    a valid pair with an Inf row is Inf or NaN by the other row's signs."""
    import jax
    from repro.kernels.pairwise.fused_gather_gram import (
        fused_gather_gram_rect_ref as jax_rect_ref,
    )
    rng = np.random.default_rng(R * Lx + Ly)
    mx, my, d = 30, 20, 7
    x = rng.normal(size=(mx, d)).astype(np.float32)
    y = rng.normal(size=(my, d)).astype(np.float32)
    x[3, 2], y[5, 0] = np.inf, np.nan
    xidx = rng.integers(0, mx, (R, Lx)).astype(np.int32)
    yidx = rng.integers(0, my, (R, Ly)).astype(np.int32)
    xmask = rng.uniform(size=(R, Lx)) < 0.6
    ymask = rng.uniform(size=(R, Ly)) < 0.6
    xidx[0, 0], xmask[0, 0] = 3, True          # a valid Inf row
    ymask[0, -1] = False                       # ... beside a masked slot
    yidx[-1, 0], ymask[-1, 0] = 5, True        # a valid NaN row
    xmask[-1, -1] = False
    # the reference multiplies a masked slot's row by 0, the port never
    # reads it: point masked slots at a finite row so both see zero rows
    xidx[~xmask], yidx[~ymask] = 0, 0
    args = (x, y, xidx, xmask, yidx, ymask)
    got = fgg_mod.fused_gather_gram_rect(
        *(torch.from_numpy(a) for a in args)).numpy()
    want = np.asarray(jax.jit(jax_rect_ref)(*(jnp.asarray(a) for a in args)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.isnan(got[0, 0, -1]) and np.isnan(got[-1, -1, 0])
    finite = np.isfinite(x[np.where(xmask, xidx, 0)]).all(-1)[:, :, None] & \
        np.isfinite(y[np.where(ymask, yidx, 0)]).all(-1)[:, None, :]
    masked = ~(xmask[:, :, None] & ymask[:, None, :])
    assert (got[masked & finite] == 0).all()


@pytest.mark.parametrize("R,Lx,Ly", [(7, 3, 1), (5, 39, 2), (4, 16, 32),
                                     (3, 41, 37), (2, 130, 5), (6, 8, 2),
                                     (9, 2, 2), (3, 16, 38), (4, 41, 16),
                                     (2, 32, 38), (5, 1, 3)])
def test_rect_gather_bytes_counts_the_kernels_staged_rows(R, Lx, Ly):
    """``rect_gather_bytes`` against the kernel's schedule walked item by
    item: every tile pair (it, jt) reads the rows of the valid slots among
    slots ``[it TM, it TM + TM)`` on the X side and ``[jt TN, jt TN + TN)``
    on the Y side; masked slots are zero-filled and read nothing."""
    rng = np.random.default_rng(R * Lx + Ly)
    xmask = rng.uniform(size=(R, Lx)) < 0.6
    ymask = rng.uniform(size=(R, Ly)) < 0.6
    d, item = 24, 2
    TM, TN = fgg_mod.rect_tile_widths(Lx, Ly)
    n_tm, n_tn = -(-Lx // TM), -(-Ly // TN)
    rows = 0
    for r in range(R):
        for it in range(n_tm):
            for jt in range(n_tn):
                rows += int(xmask[r, it * TM:it * TM + TM].sum())
                rows += int(ymask[r, jt * TN:jt * TN + TN].sum())
    assert fgg_mod.rect_gather_bytes(xmask, ymask, d, item) == \
        rows * d * item
    assert fgg_mod.rect_gather_bytes(torch.from_numpy(xmask),
                                     torch.from_numpy(ymask), d, item) == \
        rows * d * item
