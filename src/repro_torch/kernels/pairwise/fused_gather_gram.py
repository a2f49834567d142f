"""Fused gather+Gram: the shuffle streams straight into each reducer's block.

Port of ``repro.kernels.pairwise.fused_gather_gram`` (the Pallas TPU kernel
``fused_gather_gram`` / ``_fused_kernel``).  For every reducer ``r`` of a
capacity bucket it computes the masked Gram block
``out[r] = X[idx_r] · X[idx_r]ᵀ`` of shape ``(L, L)`` in fp32, zeroing
masked slots at gather time; the gathered ``(R, L, d)`` block is never
written out.

``fused_gather_gram`` is the wrapper: on a CUDA table it launches the
hand-written kernel in ``csrc/fused_gather_gram.cu`` (built for ``sm_90a``
at first use, see that file for its bound and design) or raises; on a CPU
table it runs ``fused_gather_gram_ref``, the plain PyTorch version.  There
is no fallback from the card to the plain version.

Precision: the reference multiplies fp32 with fp32 accumulation and is held
at 1e-5.  The kernel uses plain fp32 FMA, never TF32, and the plain version
runs its ``torch.bmm`` with ``torch.backends.cuda.matmul.allow_tf32 = False``
so that both stay within that bound on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

__all__ = ["fused_gather_gram", "fused_gather_gram_ref", "launch_count",
           "reset_launch_count"]

_LAUNCHES = 0


def launch_count() -> int:
    """Kernel launches made by :func:`fused_gather_gram` in this process."""
    return _LAUNCHES


def reset_launch_count() -> None:
    global _LAUNCHES
    _LAUNCHES = 0


def fused_gather_gram_ref(x: torch.Tensor, idx: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """Plain version: gather -> mask -> batched Gram in fp32."""
    g = x.index_select(0, idx.reshape(-1).long()).reshape(
        *idx.shape, x.shape[1])
    g = (g * mask.to(x.dtype)[..., None]).float()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False   # the 1e-5 fp32 contract
    try:
        return torch.bmm(g, g.transpose(1, 2))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (every pointer and
    the stream as ``c_void_p``, so none is cut to 32 bits)."""
    lib = _build.load("fused_gather_gram")
    fn = lib.fused_gather_gram_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.fused_gather_gram_error_string.argtypes = [ctypes.c_int]
    lib.fused_gather_gram_error_string.restype = ctypes.c_char_p
    return lib


def fused_gather_gram(x: torch.Tensor, idx: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """``(m, d)`` table, ``(R, L)`` int32 idx, ``(R, L)`` bool mask ->
    ``(R, L, L)`` fp32 masked per-reducer Gram blocks.

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (fp32 or bf16 table, contiguous, all on one device) or raise.  Valid
    slots must index rows of ``x``: the plain version raises otherwise, and
    the kernel, which cannot raise without a sync, gives NaN for every
    entry such a slot touches (it never reads outside the table)."""
    global _LAUNCHES
    if idx.dim() != 2 or mask.shape != idx.shape or x.dim() != 2:
        raise ValueError(f"want x (m, d), idx/mask (R, L); got "
                         f"{tuple(x.shape)}, {tuple(idx.shape)}, "
                         f"{tuple(mask.shape)}")
    if x.device.type == "cpu":
        return fused_gather_gram_ref(x, idx, mask)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if idx.device != x.device or mask.device != x.device:
        raise ValueError("x, idx and mask must lie on one device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"table dtype {x.dtype}: want float32 or bfloat16")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx dtype {idx.dtype}: want int32")
    if mask.dtype == torch.bool:
        mask = mask.view(torch.uint8)
    elif mask.dtype != torch.uint8:
        raise TypeError(f"mask dtype {mask.dtype}: want bool or uint8")
    if not (x.is_contiguous() and idx.is_contiguous()
            and mask.is_contiguous()):
        raise ValueError("x, idx and mask must be contiguous")
    if x.shape[0] > torch.iinfo(torch.int32).max:
        raise ValueError(f"table rows {x.shape[0]} overflow int32 indices")
    R, L = idx.shape
    out = torch.empty((R, L, L), dtype=torch.float32, device=x.device)
    if R == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_gather_gram_launch(
            x.data_ptr(), int(x.dtype == torch.bfloat16), idx.data_ptr(),
            mask.data_ptr(), out.data_ptr(), R, L, x.shape[1], x.shape[0],
            stream)
    if err:
        msg = lib.fused_gather_gram_error_string(err).decode()
        raise RuntimeError(
            f"fused_gather_gram launch failed (R={R}, L={L}, "
            f"d={x.shape[1]}): {msg}")
    _LAUNCHES += 1
    return out
