"""Plain PyTorch attention (port of ``repro.kernels.flash.ref``).

``attention_ref`` is the reference's one-head oracle; it also takes leading
batch axes, ``(..., Sq, d)``.  ``mha_ref`` is the multi-head / GQA form
over ``(B, S, H, D)`` — the reference's ``mha(use_kernel=False)`` — and the
plain version the ``flash_attention_heads`` wrapper runs on CPU tensors.
Scores and softmax are fp32 (TF32 off); the output has q's dtype.
"""

from __future__ import annotations

import torch

from ..pairwise.fused_gather_gram import ieee_fp32

__all__ = ["attention_ref", "mha_ref"]

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  scale: float | None = None) -> torch.Tensor:
    """``(..., Sq, d)``, ``(..., Skv, d)`` x2 -> ``(..., Sq, d)``."""
    Sq, d = q.shape[-2:]
    Skv = k.shape[-2]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    with ieee_fp32():
        s = (q.float() @ k.float().transpose(-1, -2)) * scale
    rows = torch.arange(Sq, device=q.device)[:, None]
    cols = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window > 0:
        mask &= (rows - cols) < window
        if not causal:
            mask &= (cols - rows) < window
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    with ieee_fp32():
        return (p @ v.float()).to(q.dtype)


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, window: int = 0,
            scale: float | None = None) -> torch.Tensor:
    """``(B, Sq, Hq, D)``, ``(B, Skv, Hkv, D)`` x2 -> ``(B, Sq, Hq, D)``,
    each KV head repeated over its ``Hq / Hkv`` query heads."""
    hq, hkv = q.shape[2], k.shape[2]
    if hq % hkv:
        raise ValueError(f"{hkv} KV heads do not divide {hq} query heads")
    if hkv != hq:
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
    out = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal, window=window,
                        scale=scale)
    return out.transpose(1, 2)
