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
