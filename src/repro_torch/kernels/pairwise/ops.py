"""The pairwise kernel with metric post-processing (port of
``repro.kernels.pairwise.ops``).

``pairwise_kernel`` runs ``pairwise_gram`` (the hand-written kernel on a
CUDA tensor, its plain version on a CPU one) and finishes the metric from
the Gram values: norms are the diagonal, and cosine divides by
``sqrt(clip(n2, 1e-18))`` as the reference's ``_finish`` does (the
non-kernel ``block_similarity`` path uses ``sqrt(n2 + 1e-9)``).
``pairwise`` picks the kernel or the plain oracle, as in the reference.
"""

from __future__ import annotations

import torch

from .pairwise import pairwise_gram
from .ref import pairwise_ref

__all__ = ["pairwise", "pairwise_kernel"]


def _finish(g: torch.Tensor, metric: str) -> torch.Tensor:
    if metric == "dot":
        return g
    n2 = torch.diagonal(g)
    if metric == "l2":
        return n2[:, None] + n2[None, :] - 2.0 * g
    if metric == "cosine":
        nrm = torch.sqrt(torch.clip(n2, 1e-18))
        return g / (nrm[:, None] * nrm[None, :])
    raise ValueError(metric)


def pairwise_kernel(x: torch.Tensor, *, metric: str = "dot") -> torch.Tensor:
    """All-pairs similarity of the rows of ``x`` through the kernel."""
    return _finish(pairwise_gram(x, x), metric)


def pairwise(x: torch.Tensor, *, metric: str = "dot",
             use_kernel: bool = False) -> torch.Tensor:
    if use_kernel:
        return pairwise_kernel(x, metric=metric)
    return pairwise_ref(x, metric=metric)
