"""Multi-head / GQA attention over the kernel or the plain oracle (port of
``repro.kernels.flash.ops``).

``mha``: ``(B, Sq, Hq, D)`` x ``(B, Skv, Hkv, D)`` -> ``(B, Sq, Hq, D)``.
With ``use_kernel=True`` it is one ``flash_attention_heads`` call, which
reads KV head ``h // (Hq / Hkv)`` in place instead of repeating KV heads
(the reference's ``jnp.repeat``); otherwise the plain ``mha_ref``.
"""

from __future__ import annotations

import torch

from .flash_attention import flash_attention_heads
from .ref import mha_ref

__all__ = ["mha"]


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: int = 0,
        use_kernel: bool = False) -> torch.Tensor:
    if use_kernel:
        return flash_attention_heads(q, k, v, causal=causal, window=window)
    return mha_ref(q, k, v, causal=causal, window=window)
