"""Plain PyTorch oracle for the pairwise kernel (port of
``repro.kernels.pairwise.ref``).

``pairwise_gram_ref`` is also the plain version the ``pairwise_gram``
wrapper runs on CPU tensors; it takes ``(M, K)`` or batched ``(B, M, K)``
operands and multiplies in full fp32 (TF32 off).
"""

from __future__ import annotations

import torch

from .fused_gather_gram import ieee_fp32

__all__ = ["pairwise_gram_ref", "pairwise_ref"]


def pairwise_gram_ref(x: torch.Tensor, y: torch.Tensor,
                      out_dtype=torch.float32) -> torch.Tensor:
    with ieee_fp32():
        return (x.float() @ y.float().transpose(-1, -2)).to(out_dtype)


def pairwise_ref(x: torch.Tensor, metric: str = "dot") -> torch.Tensor:
    g = pairwise_gram_ref(x, x)
    if metric == "dot":
        return g
    n2 = torch.diagonal(g)
    if metric == "l2":
        return n2[:, None] + n2[None, :] - 2.0 * g
    if metric == "cosine":
        nrm = torch.sqrt(torch.clip(n2, 1e-18))
        return g / (nrm[:, None] * nrm[None, :])
    raise ValueError(metric)
