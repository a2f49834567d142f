"""Mamba-2 SSD chunked scan: one launch for every head of a layer.

Port of ``repro.kernels.ssd.ssd`` (the Pallas TPU kernel ``ssd_scan`` /
``_ssd_kernel``): for each head the recurrence ``h_t = a_t h_{t-1} +
B_t x_tᵀ``, ``y_t = C_t · h_t`` with ``a_t = exp(log_a_t)``, evaluated in
chunks of ``chunk`` steps with the ``(N, P)`` fp32 state carried across
them; ``y`` has x's dtype.

``ssd_scan_heads`` is the wrapper over the model's ``(B, S, H, *)`` layout:
on CUDA tensors it launches the hand-written kernel in ``csrc/ssd_scan.cu``
once (built for ``sm_90a`` at first use; see that file for its bound and
design) or raises; on CPU tensors it runs ``ssd_scan_chunked``, the plain
version.  There is no fallback from the card to the plain version.  ``b``
and ``c`` may be broadcast views over the head axis (stride 0): the kernel
reads them through their strides, so nothing is copied per head.
Forward only, like the reference: with autograd on and an operand that
requires grad the wrapper raises on either device.  ``ssd_scan`` keeps
the reference's one-head signature on top of it.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..pairwise.fused_gather_gram import _device_of, _stream, \
    refuse_autograd
from .ref import ssd_scan_chunked

__all__ = ["ssd_scan", "ssd_scan_heads", "MAX_CHUNK", "MAX_N", "MAX_P"]

MAX_CHUNK, MAX_N, MAX_P = 128, 128, 64   # the kernel's shared-memory tiles
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _P]


def ssd_scan_heads(x: torch.Tensor, log_a: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, *, chunk: int = 128) -> torch.Tensor:
    """``x (B, S, H, P)``, ``log_a (B, S, H)`` (≤ 0), ``b``/``c (B, S, H,
    N)`` -> ``y (B, S, H, P)`` in x's dtype.

    CPU tensors run the plain version; CUDA tensors (x, b, c of one dtype,
    fp32 or bf16; N ≤ 128, P ≤ 64, chunk ≤ 128) launch the kernel once or
    raise.  Either raises under autograd: there is no backward."""
    refuse_autograd("ssd_scan_heads", x, log_a, b, c)
    if (x.dim() != 4 or log_a.shape != x.shape[:3] or b.dim() != 4
            or b.shape[:3] != x.shape[:3] or c.shape != b.shape):
        raise ValueError(f"want x (B, S, H, P), log_a (B, S, H), b/c (B, S, "
                         f"H, N); got {tuple(x.shape)}, "
                         f"{tuple(log_a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    if chunk < 1:
        raise ValueError(f"chunk {chunk}: want >= 1")
    if _device_of(x) == "cpu":
        y = ssd_scan_chunked(x.transpose(1, 2), log_a.transpose(1, 2),
                             b.transpose(1, 2), c.transpose(1, 2),
                             chunk=chunk)
        return y.transpose(1, 2)
    B, S, H, P = x.shape
    N = b.shape[3]
    if any(t.device != x.device for t in (log_a, b, c)):
        raise ValueError("all operands must lie on one device")
    if x.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != x.dtype for t in (b, c)):
        raise TypeError(f"x, b, c dtypes {x.dtype}, {b.dtype}, {c.dtype}: "
                        "want float32 or bfloat16, one dtype for all")
    if N > MAX_N or P > MAX_P or chunk > MAX_CHUNK:
        raise ValueError(f"N={N}, P={P}, chunk={chunk}: the kernel takes "
                         f"N <= {MAX_N}, P <= {MAX_P}, chunk <= {MAX_CHUNK}")
    x, b, c = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, b, c))
    log_a = log_a.float()
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 15)(
        *x.stride()[:3], *log_a.stride(), *b.stride()[:3], *c.stride()[:3],
        *out.stride()[:3])
    with torch.cuda.device(x.device):
        _build.launch(
            "ssd_scan", _ARGS,
            (x.data_ptr(), log_a.data_ptr(), b.data_ptr(), c.data_ptr(),
             out.data_ptr(), int(x.dtype == torch.bfloat16),
             ctypes.addressof(strides), B, S, H, N, P, chunk, _stream(x)),
            what=f"B={B}, S={S}, H={H}, N={N}, P={P}, chunk={chunk}")
    return out


def ssd_scan(x: torch.Tensor, log_a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, *, chunk: int = 128) -> torch.Tensor:
    """One head, the reference's signature: ``x (S, P)``, ``log_a (S,)``,
    ``b``/``c (S, N)`` -> ``y (S, P)``."""
    if x.dim() != 2 or log_a.shape != x.shape[:1] or b.dim() != 2 \
            or c.shape != b.shape or b.shape[0] != x.shape[0]:
        raise ValueError(f"want x (S, P), log_a (S,), b/c (S, N); got "
                         f"{tuple(x.shape)}, {tuple(log_a.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}")
    return ssd_scan_heads(x[None, :, None], log_a[None, :, None],
                          b[None, :, None], c[None, :, None],
                          chunk=chunk)[0, :, 0]
