"""The port's attention (plain version on the CPU) against the JAX package.

``flash_attention`` / ``flash_attention_heads`` (the wrappers, which run
``mha_ref`` on CPU tensors), ``attention_ref`` and ``mha`` against the
reference's Pallas kernel in interpret mode (``flash_attention(
interpret=True)``), its oracle ``attention_ref`` and ``mha(use_kernel=True,
interpret=True)``, on the cases of ``tests/test_kernels.py``: ragged S,
sliding windows, non-causal, GQA, bf16.  Tolerances are the reference's
own: 2e-4 in fp32, 3e-2 in bf16.  The CUDA kernel itself runs only on the
card: see ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash.flash_attention import flash_attention as jax_flash
from repro.kernels.flash.ops import mha as jax_mha
from repro.kernels.flash.ref import attention_ref as jax_ref
from repro_torch.kernels import _build
from repro_torch.kernels.flash.flash_attention import (
    flash_attention,
    flash_attention_heads,
)
from repro_torch.kernels.flash.ops import mha
from repro_torch.kernels.flash.ref import attention_ref, mha_ref

FP32 = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=3e-2, atol=3e-2)


def _rnd(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _both(a, dtype="float32"):
    return (jnp.asarray(a, dtype=getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


SHAPES = [(16, 16, 8), (64, 64, 16), (128, 128, 64), (100, 100, 32),
          (33, 65, 16)]


# causal only where positions align (Sq == Skv), as in the reference's cases
@pytest.mark.parametrize("sq,skv,d,causal", [
    (*shape, causal) for shape in SHAPES for causal in (True, False)
    if not causal or shape[0] == shape[1]])
def test_one_head_matches_reference_kernel(sq, skv, d, causal):
    rng = np.random.default_rng(sq + skv + d)
    (qj, qt), (kj, kt), (vj, vt) = (_both(_rnd(rng, (s, d)))
                                    for s in (sq, skv, skv))
    want = jax_flash(qj, kj, vj, causal=causal, interpret=True, bq=32, bk=32)
    got = flash_attention(qt, kt, vt, causal=causal)
    _close(got, want, FP32)
    _close(attention_ref(qt, kt, vt, causal=causal),
           jax_ref(qj, kj, vj, causal=causal), FP32)


@pytest.mark.parametrize("window", [4, 16, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_sliding_window(window, causal):
    """Causal windows keep i - j < w; two-sided ones also j - i < w."""
    rng = np.random.default_rng(window)
    s, d = 96, 16
    (qj, qt), (kj, kt), (vj, vt) = (_both(_rnd(rng, (s, d)))
                                    for _ in range(3))
    want = jax_flash(qj, kj, vj, causal=causal, window=window,
                     interpret=True, bq=32, bk=32)
    _close(flash_attention(qt, kt, vt, causal=causal, window=window), want,
           FP32)
    _close(attention_ref(qt, kt, vt, causal=causal, window=window),
           jax_ref(qj, kj, vj, causal=causal, window=window), FP32)


def test_bf16():
    rng = np.random.default_rng(3)
    s, d = 64, 32
    (qj, qt), (kj, kt), (vj, vt) = (_both(_rnd(rng, (s, d)), "bfloat16")
                                    for _ in range(3))
    want = jax_flash(qj, kj, vj, causal=True, interpret=True)
    got = flash_attention(qt, kt, vt, causal=True)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16)


@pytest.mark.parametrize("hq,hkv,window", [(8, 2, 0), (4, 4, 0), (6, 1, 8),
                                           (8, 2, 5)])
def test_gqa_mha_matches_reference(hq, hkv, window):
    """Query head h reads KV head h // (Hq / Hkv), as the reference's
    ``jnp.repeat`` broadcast does; both reference routes agree with both
    port routes."""
    rng = np.random.default_rng(11 + hq + window)
    B, S, D = 2, 40, 16
    (qj, qt) = _both(_rnd(rng, (B, S, hq, D)))
    (kj, kt), (vj, vt) = (_both(_rnd(rng, (B, S, hkv, D))) for _ in range(2))
    want = jax_mha(qj, kj, vj, causal=True, window=window, use_kernel=True,
                   interpret=True, bq=16, bk=16)
    plain = jax_mha(qj, kj, vj, causal=True, window=window, use_kernel=False)
    for use_kernel in (True, False):
        got = mha(qt, kt, vt, causal=True, window=window,
                  use_kernel=use_kernel)
        _close(got, want, FP32)
        _close(got, plain, FP32)


def test_wrapper_runs_the_plain_version_on_the_cpu():
    """On CPU tensors the wrapper is the plain version, exactly, and counts
    no kernel launch."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(_rnd(rng, (2, 20, 4, 8)))
    k = torch.from_numpy(_rnd(rng, (2, 24, 2, 8)))
    v = torch.from_numpy(_rnd(rng, (2, 24, 2, 8)))
    before = _build.launch_counts()
    got = flash_attention_heads(q, k, v, causal=False)
    assert _build.launch_counts() == before
    torch.testing.assert_close(got, mha_ref(q, k, v, causal=False),
                               rtol=0, atol=0)


def test_wrapper_rejects_bad_shapes():
    q = torch.zeros((1, 4, 3, 8))
    kv = torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError, match="do not divide"):
        flash_attention_heads(q, kv, kv)
    with pytest.raises(ValueError, match="want q"):
        flash_attention_heads(q[0], kv, kv)
    with pytest.raises(ValueError, match="want q"):
        flash_attention(q[0, :, 0], kv, kv)
