"""Flash attention forward: one launch for every head of a layer.

Port of ``repro.kernels.flash.flash_attention`` (the Pallas TPU kernel
``flash_attention`` / ``_flash_kernel``): online-softmax attention with
causal, sliding-window (``window > 0``, two-sided when not causal) and
padded-key masks, fp32 scores and accumulator, output in q's dtype.

``flash_attention_heads`` is the wrapper over the model's ``(B, S, H, D)``
layout with grouped KV heads: on CUDA tensors it launches the hand-written
kernel in ``csrc/flash_attention.cu`` once (built for ``sm_90a`` at first
use; see that file for its bound and design: bf16 with D of 64 or 128,
rows on 16-byte boundaries and non-zero strides that are multiples of 16
bytes runs on the tensor cores, through TMA and wgmma; everything else in
fp32 FMA) or raises; on CPU tensors it
runs ``mha_ref``, the plain version.  There is no fallback from the card to
the plain version.  ``flash_attention`` keeps the reference's one-head
signature on top of it.  Forward only, like the reference: with autograd
on and an operand that requires grad the wrapper raises on either device.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..pairwise.fused_gather_gram import _device_of, _stream, \
    refuse_autograd
from .ref import mha_ref

__all__ = ["flash_attention", "flash_attention_heads", "HEAD_DIMS"]

HEAD_DIMS = (64, 128, 256)        # the head widths the kernel is built for
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P]


def _cuda_operands(tensors):
    """One CUDA device and one dtype (fp32 or bf16), last axis contiguous;
    other strides are passed to the kernel as they are."""
    dev, dt = tensors[0].device, tensors[0].dtype
    if any(t.device != dev for t in tensors):
        raise ValueError("all operands must lie on one device")
    if dt not in (torch.float32, torch.bfloat16) or any(
            t.dtype != dt for t in tensors):
        raise TypeError(f"dtypes {[t.dtype for t in tensors]}: want float32 "
                        "or bfloat16, one dtype for all")
    return [t if t.stride(-1) == 1 else t.contiguous() for t in tensors]


def flash_attention_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          scale: float | None = None) -> torch.Tensor:
    """``(B, Sq, Hq, D)`` queries, ``(B, Skv, Hkv, D)`` keys and values ->
    ``(B, Sq, Hq, D)`` in q's dtype; query head ``h`` attends to KV head
    ``h // (Hq / Hkv)``.

    CPU tensors run the plain version; CUDA tensors (fp32 or bf16, one
    dtype, D in ``HEAD_DIMS``) launch the kernel once or raise.  Either
    raises under autograd: there is no backward."""
    refuse_autograd("flash_attention_heads", q, k, v)
    if (q.dim() != 4 or k.dim() != 4 or v.shape != k.shape
            or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]):
        raise ValueError(f"want q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{Hkv} KV heads do not divide {Hq} query heads")
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    if _device_of(q) == "cpu":
        return mha_ref(q, k, v, causal=causal, window=window, scale=scale)
    q, k, v = _cuda_operands([q, k, v])
    if D not in HEAD_DIMS:
        raise ValueError(f"head width {D}: the kernel is built for "
                         f"{HEAD_DIMS}")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        _build.launch(
            "flash_attention", _ARGS,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             int(q.dtype == torch.bfloat16), ctypes.addressof(strides), B,
             Sq, Skv, Hq, Hkv, D, int(causal), int(window), float(scale),
             _stream(q)),
            what=f"B={B}, Sq={Sq}, Skv={Skv}, Hq={Hq}, Hkv={Hkv}, D={D}")
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """One head, the reference's signature: ``(Sq, d)``, ``(Skv, d)`` x2 ->
    ``(Sq, d)``."""
    if q.dim() != 2 or k.dim() != 2 or v.shape != k.shape:
        raise ValueError(f"want q (Sq, d), k/v (Skv, d); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    return flash_attention_heads(q[None, :, None], k[None, :, None],
                                 v[None, :, None], causal=causal,
                                 window=window, scale=scale)[0, :, 0]
