"""Batched / multi-head SSD over the kernel or the plain scans (port of
``repro.kernels.ssd.ops``).

``ssd``: ``x (B, S, H, P)``, ``log_a (B, S, H)``, ``b``/``c (B, S, H, N)``
-> ``(B, S, H, P)``.  ``use_kernel=True`` is one ``ssd_scan_heads`` call;
otherwise ``impl`` picks the plain scan as in the reference: ``"step"``
(the literal recurrence) or ``"chunked"``.
"""

from __future__ import annotations

import torch

from .ref import ssd_scan_chunked, ssd_scan_ref
from .ssd import ssd_scan_heads

__all__ = ["ssd"]


def ssd(x: torch.Tensor, log_a: torch.Tensor, b: torch.Tensor,
        c: torch.Tensor, *, chunk: int = 128, use_kernel: bool = False,
        impl: str = "step") -> torch.Tensor:
    if use_kernel:
        return ssd_scan_heads(x, log_a, b, c, chunk=chunk)
    xt, lat, bt, ct = (x.transpose(1, 2), log_a.transpose(1, 2),
                       b.transpose(1, 2), c.transpose(1, 2))
    if impl == "chunked":
        y = ssd_scan_chunked(xt, lat, bt, ct, chunk=chunk)
    elif impl == "step":
        y = ssd_scan_ref(xt, lat, bt, ct)
    else:
        raise ValueError(f"impl {impl!r}: want 'step' or 'chunked'")
    return y.transpose(1, 2)
