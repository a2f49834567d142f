"""The port's SSD scans (plain versions on the CPU) against the JAX package.

``ssd_scan`` / ``ssd_scan_heads`` (the wrappers, which run
``ssd_scan_chunked`` on CPU tensors), ``ssd_scan_ref``,
``ssd_scan_chunked`` and the batched ``ssd`` against the reference's
Pallas kernel in interpret mode (``ssd_scan(interpret=True)``), its oracles
and ``ssd(use_kernel=True, interpret=True)``, on the cases of
``tests/test_kernels.py``: ragged S, the state carried across chunks,
S below the chunk, the batched wrapper; plus bf16 and the broadcast B / C
views ``mamba_apply`` passes.  Tolerances are the reference's own: 2e-4 in
fp32, 3e-2 in bf16.  The CUDA kernel itself runs only on the card: see
``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd.ops import ssd as jax_ssd
from repro.kernels.ssd.ref import ssd_scan_chunked as jax_chunked
from repro.kernels.ssd.ref import ssd_scan_ref as jax_ref
from repro.kernels.ssd.ssd import ssd_scan as jax_scan
from repro_torch.kernels import _build
from repro_torch.kernels.ssd.ops import ssd
from repro_torch.kernels.ssd.ref import ssd_scan_chunked, ssd_scan_ref
from repro_torch.kernels.ssd.ssd import ssd_scan, ssd_scan_heads

FP32 = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=3e-2, atol=3e-2)


def _inputs(rng, lead, s, p, n, decay=None):
    x = rng.normal(size=(*lead, s, p)).astype(np.float32)
    b = rng.normal(size=(*lead, s, n)).astype(np.float32)
    c = rng.normal(size=(*lead, s, n)).astype(np.float32)
    la = (np.full((*lead, s), decay, np.float32) if decay is not None else
          -np.abs(rng.normal(size=(*lead, s))).astype(np.float32))
    return x, la, b, c


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("s,p,n,chunk", [
    (32, 8, 4, 8), (64, 16, 16, 16), (100, 8, 8, 32), (128, 32, 16, 128),
    (7, 4, 4, 8),
])
def test_one_head_matches_reference_kernel(s, p, n, chunk):
    rng = np.random.default_rng(s + p + n)
    x, la, b, c = _inputs(rng, (), s, p, n)
    want = jax_scan(jnp.asarray(x), jnp.asarray(la), jnp.asarray(b),
                    jnp.asarray(c), chunk=chunk, interpret=True)
    xt, lat, bt, ct = _t(x, la, b, c)
    _close(ssd_scan(xt, lat, bt, ct, chunk=chunk), want, FP32)
    _close(ssd_scan_chunked(xt, lat, bt, ct, chunk=chunk),
           jax_chunked(x, la, b, c, chunk=chunk), FP32)
    _close(ssd_scan_ref(xt, lat, bt, ct), jax_ref(x, la, b, c), FP32)


def test_state_carry_across_chunks():
    """Nearly no decay: long memory, so the carried state matters."""
    rng = np.random.default_rng(0)
    x, la, b, c = _inputs(rng, (), 64, 8, 8, decay=-0.01)
    want = jax_ref(x, la, b, c)
    xt, lat, bt, ct = _t(x, la, b, c)
    _close(ssd_scan(xt, lat, bt, ct, chunk=16), want, FP32)
    np.testing.assert_allclose(
        np.asarray(jax_scan(x, la, b, c, chunk=16, interpret=True)),
        np.asarray(want), **FP32)


@pytest.mark.parametrize("impl", ["step", "chunked"])
def test_batched_wrapper(impl):
    rng = np.random.default_rng(1)
    B, S, H, P, N = 2, 24, 3, 8, 4
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    b = rng.normal(size=(B, S, H, N)).astype(np.float32)
    c = rng.normal(size=(B, S, H, N)).astype(np.float32)
    la = -np.abs(rng.normal(size=(B, S, H))).astype(np.float32)
    want = jax_ssd(x, la, b, c, chunk=8, use_kernel=True, interpret=True)
    plain = jax_ssd(x, la, b, c, use_kernel=False, impl=impl)
    xt, lat, bt, ct = _t(x, la, b, c)
    for use_kernel in (True, False):
        got = ssd(xt, lat, bt, ct, chunk=8, use_kernel=use_kernel, impl=impl)
        _close(got, want, FP32)
        _close(got, plain, FP32)


def test_bf16():
    rng = np.random.default_rng(4)
    x, la, b, c = _inputs(rng, (), 50, 16, 8)
    want = jax_scan(jnp.asarray(x, jnp.bfloat16), jnp.asarray(la),
                    jnp.asarray(b, jnp.bfloat16),
                    jnp.asarray(c, jnp.bfloat16), chunk=16, interpret=True)
    xt, bt, ct = _t(x, b, c, dtype=torch.bfloat16)
    got = ssd_scan(xt, torch.from_numpy(la), bt, ct, chunk=16)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16)


def test_broadcast_b_and_c_views():
    """``mamba_apply`` hands one B and one C to every head as stride-0
    views; the wrapper takes them as they are and gives the result of the
    materialised inputs."""
    rng = np.random.default_rng(6)
    B, S, H, P, N = 2, 40, 4, 8, 6
    x = torch.from_numpy(rng.normal(size=(B, S, H, P)).astype(np.float32))
    la = -torch.from_numpy(np.abs(rng.normal(size=(B, S, H)))
                           .astype(np.float32))
    b1, c1 = (torch.from_numpy(rng.normal(size=(B, S, N)).astype(np.float32))
              for _ in range(2))
    bh = b1[:, :, None, :].expand(B, S, H, N)
    ch = c1[:, :, None, :].expand(B, S, H, N)
    got = ssd_scan_heads(x, la, bh, ch, chunk=16)
    want = ssd_scan_heads(x, la, bh.contiguous(), ch.contiguous(), chunk=16)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    ref = jax_ssd(x.numpy(), la.numpy(), bh.numpy(), ch.numpy(),
                  use_kernel=False)
    _close(got, ref, FP32)


def test_wrapper_runs_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(8)
    x, la, b, c = _t(*_inputs(rng, (2, 3), 20, 8, 4))
    x, la, b, c = (x.transpose(1, 2), la.transpose(1, 2), b.transpose(1, 2),
                   c.transpose(1, 2))
    before = _build.launch_counts()
    got = ssd_scan_heads(x, la, b, c, chunk=8)
    assert _build.launch_counts() == before
    want = ssd_scan_chunked(x.transpose(1, 2), la.transpose(1, 2),
                            b.transpose(1, 2), c.transpose(1, 2), chunk=8)
    torch.testing.assert_close(got, want.transpose(1, 2), rtol=0, atol=0)


def test_wrapper_rejects_bad_shapes():
    x = torch.zeros((1, 8, 2, 4))
    with pytest.raises(ValueError, match="want x"):
        ssd_scan_heads(x, torch.zeros((1, 8, 3)), x, x)
    with pytest.raises(ValueError, match="chunk"):
        ssd_scan_heads(x, torch.zeros((1, 8, 2)), x, x, chunk=0)
    with pytest.raises(ValueError, match="impl"):
        ssd(x, torch.zeros((1, 8, 2)), x, x, impl="scan")
