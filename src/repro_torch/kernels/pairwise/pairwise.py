"""Tiled ``X · Yᵀ`` with fp32 accumulation: the reducer's Gram block on the
``use_kernel=True`` path.

Port of ``repro.kernels.pairwise.pairwise`` (the Pallas TPU kernel
``pairwise_gram`` / ``_gram_kernel``).  The reference runs its kernel once
per reducer, under ``vmap`` over the reducer axis; here the per-reducer
call is a ``torch.library`` custom operator whose vmap rule makes ONE
batched launch for the whole reducer axis (``torch.func.vmap`` cannot pass
a batched tensor to a ``ctypes`` launch: it has no data pointer of its
own).  So the dense executor launches once per request and the bucketed one
once per bucket.

``pairwise_gram_batched`` is the wrapper: on CUDA tensors it launches the
hand-written kernel in ``csrc/pairwise_gram.cu`` (built for ``sm_90a`` at
first use; see that file for its bound and design) or raises; on CPU
tensors it runs ``pairwise_gram_ref``, the plain PyTorch version
(``ref.py``).  There is no fallback from the card to the plain version.
fp32 products are plain FMA on the card, never TF32.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .fused_gather_gram import _cuda_operands, _device_of, _stream
from .ref import pairwise_gram_ref

__all__ = ["pairwise_gram", "pairwise_gram_batched", "pairwise_gram_ref",
           "same_operand"]

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = [_P, _P, _I, _P, _LL, _I, _I, _I, _I, _P]


def same_operand(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Whether ``x`` and ``y`` are one tensor: the same storage, offset,
    dtype, shape and strides (two views made alike count, as the vmap rule
    makes them for ``pairwise_gram(b, b)``)."""
    return x is y or (
        x.device == y.device and x.dtype == y.dtype
        and x.shape == y.shape and x.stride() == y.stride()
        and x.storage_offset() == y.storage_offset()
        and x.untyped_storage().data_ptr() == y.untyped_storage().data_ptr())


def pairwise_gram_batched(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``(B, M, K)``, ``(B, N, K)`` -> ``(B, M, N)`` fp32 with
    ``out[b] = x[b] · y[b]ᵀ``.

    CPU tensors run the plain version; CUDA tensors (fp32 or bf16, one
    dtype, one device) launch the kernel once or raise.  Non-contiguous
    operands are made contiguous first.  When ``y`` is ``x``
    (:func:`same_operand`) the kernel takes the self-Gram route: one
    pointer, each block row read once for both sides."""
    if (x.dim() != 3 or y.dim() != 3 or x.shape[0] != y.shape[0]
            or x.shape[2] != y.shape[2]):
        raise ValueError(f"want x (B, M, K), y (B, N, K); got "
                         f"{tuple(x.shape)}, {tuple(y.shape)}")
    if _device_of(x) == "cpu":
        return pairwise_gram_ref(x, y)
    self_gram = same_operand(x, y)
    x = x.contiguous()
    y = x if self_gram else y.contiguous()
    _cuda_operands([x, y], [])
    B, M, K = x.shape
    N = y.shape[1]
    out = torch.empty((B, M, N), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    if K == 0:
        return out.zero_()
    with torch.cuda.device(x.device):
        _build.launch(
            "pairwise_gram", _ARGS,
            (x.data_ptr(), None if self_gram else y.data_ptr(),
             int(x.dtype == torch.bfloat16), out.data_ptr(), B, M, N, K,
             int(self_gram), _stream(x)),
            what=f"B={B}, M={M}, N={N}, K={K}, self_gram={self_gram}")
    return out


@torch.library.custom_op("repro_torch::pairwise_gram", mutates_args=())
def _pairwise_gram_op(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return pairwise_gram_batched(x[None], y[None])[0]


@_pairwise_gram_op.register_fake
def _(x, y):
    return x.new_empty((x.shape[0], y.shape[0]), dtype=torch.float32)


def _pairwise_gram_vmap(info, in_dims, x, y):
    """One batched launch for the whole vmapped axis."""
    def batch_first(t, dim):
        if dim is None:
            return t.expand(info.batch_size, *t.shape)
        return t.movedim(dim, 0)
    xd, yd = in_dims
    return pairwise_gram_batched(batch_first(x, xd), batch_first(y, yd)), 0


_pairwise_gram_op.register_vmap(_pairwise_gram_vmap)


def pairwise_gram(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``(M, K)``, ``(N, K)`` -> ``(M, N)`` = ``x · yᵀ`` in fp32 (the
    reference's signature).  Under ``torch.func.vmap`` the whole batch is
    one kernel launch (or one plain batched product on the CPU)."""
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"want x (M, K), y (N, K); got {tuple(x.shape)}, "
                         f"{tuple(y.shape)}")
    return _pairwise_gram_op(x, y)
