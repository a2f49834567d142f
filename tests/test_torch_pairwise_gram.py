"""The port's ``pairwise_gram`` (plain version on the CPU) and the
``use_kernel=True`` path against the JAX package.

``pairwise_gram`` against ``repro.kernels.pairwise.pairwise.pairwise_gram``
in interpret mode (masked tail tiles, K padding) and the reference oracle
``ref.py``; ``ops.pairwise_kernel`` / ``pairwise`` against the reference's
metric finish; ``pairwise_similarity(use_kernel=True)`` on dense and
bucketed against the reference's, including cosine, which on this path
clips at ``1e-18`` (``ops._finish``), not ``+1e-9``.  fp32 at 1e-5, bf16
at 2e-2.  The kernel itself runs only on the card: see
``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.mapreduce as ref_mr
import repro_torch.mapreduce as port_mr
from repro.kernels.pairwise import ops as ref_ops
from repro.kernels.pairwise.pairwise import pairwise_gram as jax_gram
from repro.kernels.pairwise.ref import pairwise_ref as jax_pairwise_ref
from repro_torch.kernels import _build
from repro_torch.kernels.pairwise import ops
from repro_torch.kernels.pairwise import pairwise as pairwise_mod
from repro_torch.kernels.pairwise.pairwise import (
    pairwise_gram,
    pairwise_gram_batched,
    same_operand,
)
from repro_torch.kernels.pairwise.ref import pairwise_gram_ref, pairwise_ref
from repro_torch.mapreduce.allpairs import block_similarity

TOL = dict(rtol=1e-5, atol=1e-5)
METRICS = ["dot", "l2", "cosine"]


def _xy(seed, M, N, K):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(M, K)).astype(np.float32),
            rng.normal(size=(N, K)).astype(np.float32))


@pytest.mark.parametrize("M,N,K,bm,bn,bk", [
    (16, 16, 128, 8, 8, 128),       # exact tiles
    (13, 21, 200, 8, 8, 128),       # masked M/N tails, padded K
    (1, 5, 3, 8, 8, 128),           # one row, tiny K
    (37, 2, 256, 16, 8, 128),       # the width-37 / width-2 shapes
])
def test_plain_matches_pallas_interpret(M, N, K, bm, bn, bk):
    x, y = _xy(M * 7 + N, M, N, K)
    want = jax_gram(jnp.asarray(x), jnp.asarray(y), bm=bm, bn=bn, bk=bk,
                    interpret=True)
    got = pairwise_gram(torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == (M, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        pairwise_gram_ref(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
        np.asarray(want), **TOL)


def test_bf16_matches_pallas_interpret():
    x, y = _xy(3, 12, 9, 64)
    want = jax_gram(jnp.asarray(x, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16),
                    bm=16, bn=16, bk=128, interpret=True)
    got = pairwise_gram(torch.from_numpy(x).bfloat16(),
                        torch.from_numpy(y).bfloat16())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("metric", METRICS)
def test_pairwise_kernel_and_oracle_match_reference(metric):
    x, _ = _xy(5, 11, 1, 7)
    x[4] = 0.0                                   # a zero row: cosine clips
    want = ref_ops.pairwise_kernel(jnp.asarray(x), metric=metric,
                                   interpret=True)
    t = torch.from_numpy(x)
    for got in (ops.pairwise_kernel(t, metric=metric),
                ops.pairwise(t, metric=metric, use_kernel=True),
                ops.pairwise(t, metric=metric),
                pairwise_ref(t, metric=metric)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        pairwise_ref(t, metric=metric).numpy(),
        np.asarray(jax_pairwise_ref(jnp.asarray(x), metric=metric)), **TOL)


def test_vmap_runs_one_batched_product_and_launches_nothing_on_cpu():
    rng = np.random.default_rng(6)
    blocks = torch.from_numpy(rng.normal(size=(9, 5, 4)).astype(np.float32))
    before = _build.launch_counts()
    got = torch.func.vmap(lambda b: pairwise_gram(b, b))(blocks)
    assert _build.launch_counts() == before
    torch.testing.assert_close(got, torch.bmm(blocks, blocks.mT), **TOL)
    y = blocks[0]                              # unbatched second operand
    got = torch.func.vmap(lambda b: pairwise_gram(b, y))(blocks)
    torch.testing.assert_close(got, blocks @ y.T, **TOL)
    torch.testing.assert_close(pairwise_gram_batched(blocks, blocks),
                               torch.bmm(blocks, blocks.mT), **TOL)


def test_wrappers_reject_bad_shapes():
    x = torch.ones((4, 3))
    with pytest.raises(ValueError):
        pairwise_gram(x, torch.ones((4, 2)))
    with pytest.raises(ValueError):
        pairwise_gram_batched(x, x)
    with pytest.raises(ValueError, match="unsupported device"):
        pairwise_gram_batched(torch.empty((2, 3, 4), device="meta"),
                              torch.empty((2, 3, 4), device="meta"))


@pytest.mark.parametrize("metric", METRICS)
def test_block_similarity_use_kernel_matches_reference(metric):
    from repro.mapreduce.allpairs import block_similarity as ref_block_sim
    x, _ = _xy(8, 9, 1, 5)
    mask = np.array([1, 1, 0, 1, 1, 1, 0, 1, 1], bool)
    x[~mask] = 0.0
    want = ref_block_sim(jnp.asarray(x), jnp.asarray(mask), metric=metric,
                         use_kernel=True)
    got = block_similarity(torch.from_numpy(x), torch.from_numpy(mask),
                           metric=metric, use_kernel=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("executor", ["dense", "bucketed"])
def test_use_kernel_pairwise_similarity_matches_reference(executor, metric):
    rng = np.random.default_rng(9)
    m = 26
    w = np.clip(rng.zipf(1.7, m) / 24.0, 0.02, 0.45)
    x = rng.normal(size=(m, 6)).astype(np.float32)
    ref, _, _ = ref_mr.pairwise_similarity(
        jnp.asarray(x), q=1.0, weights=w, metric=metric, use_kernel=True,
        executor=executor)
    got, plan, _ = port_mr.pairwise_similarity(
        x, q=1.0, weights=w, metric=metric, use_kernel=True,
        executor=executor, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    plain, _, _ = port_mr.pairwise_similarity(
        x, q=1.0, weights=w, metric=metric, executor=executor, device="cpu")
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


def test_use_kernel_cosine_pins_the_clip_epsilon():
    """A reducer block with a zero row: the kernel path divides by
    sqrt(max(n2, 1e-18)) and gives 0 for that row's pairs, the plain path
    by sqrt(n2 + 1e-9); both match their own reference path."""
    from repro.mapreduce.allpairs import block_similarity as ref_block_sim
    x = np.array([[1e-6, 0.0], [0.0, 2e-6], [3.0, 4.0]], np.float32)
    mask = np.ones(3, bool)
    for use_kernel in (True, False):
        want = ref_block_sim(jnp.asarray(x), jnp.asarray(mask),
                             metric="cosine", use_kernel=use_kernel)
        got = block_similarity(torch.from_numpy(x), torch.from_numpy(mask),
                               metric="cosine", use_kernel=use_kernel)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-7)
    kernel = block_similarity(torch.from_numpy(x), torch.from_numpy(mask),
                              metric="cosine", use_kernel=True)
    plain = block_similarity(torch.from_numpy(x), torch.from_numpy(mask),
                             metric="cosine", use_kernel=False)
    assert abs(float(kernel[0, 0]) - 1.0) < 1e-5        # clip: exact ratio
    assert float(plain[0, 0]) < 1e-3                    # +1e-9 dominates


def test_same_operand_detects_one_tensor_in_two_views():
    """The wrapper's self-Gram test: one storage, offset, dtype, shape and
    strides — also two view objects made alike — and nothing else."""
    x = torch.randn(6, 5, 8)
    assert same_operand(x, x)
    assert same_operand(x, x[:])                        # a second view object
    assert same_operand(x.movedim(0, 0), x.movedim(0, 0))
    e = torch.randn(5, 8)
    assert same_operand(e.expand(6, 5, 8), e.expand(6, 5, 8))
    assert not same_operand(x, x.clone())               # equal values, a copy
    assert not same_operand(x, x[1:])                   # other offset, shape
    assert not same_operand(x[:, :4], x[:, 1:])         # other offset
    assert not same_operand(x.transpose(1, 2),          # other strides
                            x.view(6, 8, 5))
    assert not same_operand(x, x.view(torch.int32))     # other dtype


def test_vmap_rule_hands_the_kernel_one_operand(monkeypatch):
    """Under vmap, ``pairwise_gram(b, b)`` reaches the batched wrapper as
    two views that ``same_operand`` takes for one (the kernel's self-Gram
    route); ``pairwise_gram(w, b)`` does not."""
    seen = []
    real = pairwise_mod.pairwise_gram_batched

    def spy(x, y):
        seen.append(same_operand(x, y))
        return real(x, y)
    monkeypatch.setattr(pairwise_mod, "pairwise_gram_batched", spy)
    xs = torch.randn(7, 4, 16)
    got = torch.func.vmap(lambda b: pairwise_gram(b, b))(xs)
    torch.testing.assert_close(got, pairwise_gram_ref(xs, xs))
    w = torch.randn(4, 16)
    torch.func.vmap(lambda b: pairwise_gram(w, b))(xs)
    assert seen == [True, False]
