"""Plain PyTorch SSD scans (port of ``repro.kernels.ssd.ref``).

``ssd_scan_ref``     — the literal per-step recurrence (ground truth).
``ssd_scan_chunked`` — the chunked formulation, the same math as the
                       kernel: a masked decay-weighted ``(Q, Q)`` product
                       inside each chunk plus the ``(N, P)`` state carried
                       across chunks.  It is the plain version the
                       ``ssd_scan_heads`` wrapper runs on CPU tensors.

Both take one head, ``x (S, P)``, ``log_a (S,)``, ``b``/``c (S, N)``, as the
reference does, or any leading batch axes in front of those; the math is
fp32 (TF32 off) and ``y`` has x's dtype.  On meta tensors (the LM dry
run) each runs its loop body (``_ref_step``, ``_chunk_step``) once and
counts it once per position or chunk (``launch.op_analysis.meta_repeat``);
what comes before and after the loop runs once, as it does on a card.
"""

from __future__ import annotations

import torch

from ...launch.op_analysis import meta_repeat
from ..pairwise.fused_gather_gram import ieee_fp32

__all__ = ["ssd_scan_ref", "ssd_scan_chunked"]


def ssd_scan_ref(x: torch.Tensor, log_a: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t x_tᵀ ;  y_t = c_t · h_t."""
    S, P = x.shape[-2:]
    if S == 0:
        return x.new_zeros(x.shape)
    N = b.shape[-1]
    xf, laf, bf, cf = x.float(), log_a.float(), b.float(), c.float()
    h = x.new_zeros((*x.shape[:-2], N, P), dtype=torch.float32)
    if x.is_meta and S > 1:
        t0 = (Ellipsis, 0, slice(None))
        return meta_repeat(_ref_step, S, (*x.shape[:-2], S, P), x.dtype,
                           ((Ellipsis,), (Ellipsis, 0), t0, t0, t0),
                           h, laf, bf, xf, cf)
    ys = []
    for t in range(S):
        h, y_t = _ref_step(h, laf[..., t], bf[..., t, :], xf[..., t, :],
                           cf[..., t, :])
        ys.append(y_t)
    return torch.stack(ys, dim=-2).to(x.dtype)


def _ref_step(h, la_t, b_t, x_t, c_t):
    """One position of ``ssd_scan_ref``: ``(h_t, y_t)``."""
    h = torch.exp(la_t)[..., None, None] * h \
        + b_t[..., :, None] * x_t[..., None, :]
    return h, (c_t[..., :, None] * h).sum(-2)


def ssd_scan_chunked(x: torch.Tensor, log_a: torch.Tensor, b: torch.Tensor,
                     c: torch.Tensor, *, chunk: int = 128) -> torch.Tensor:
    """Chunked SSD (same recurrence as ``ssd_scan_ref``)."""
    S, P = x.shape[-2:]
    N = b.shape[-1]
    lead = x.shape[:-2]
    if S == 0:
        return x.new_zeros(x.shape)
    Q = min(chunk, S)
    pad = -S % Q
    xf, bf, cf = x.float(), b.float(), c.float()
    laf = log_a.float()
    if pad:
        xf = torch.nn.functional.pad(xf, (0, 0, 0, pad))
        bf = torch.nn.functional.pad(bf, (0, 0, 0, pad))
        cf = torch.nn.functional.pad(cf, (0, 0, 0, pad))
        laf = torch.nn.functional.pad(laf, (0, pad))
    nc = xf.shape[-2] // Q
    xc = xf.reshape(*lead, nc, Q, P)
    bc = bf.reshape(*lead, nc, Q, N)
    cc = cf.reshape(*lead, nc, Q, N)
    lac = torch.cumsum(laf.reshape(*lead, nc, Q, 1), dim=-2)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    h = x.new_zeros((*lead, N, P), dtype=torch.float32)
    with ieee_fp32():
        if x.is_meta and nc > 1:
            i0 = (Ellipsis, 0, slice(None), slice(None))
            y = meta_repeat(_chunk_step, nc, (*lead, nc, Q, P), x.dtype,
                            ((Ellipsis,), i0, i0, i0, i0, (Ellipsis,)),
                            h, xc, bc, cc, lac, tri)
        else:
            ys = []
            for i in range(nc):
                h, y_i = _chunk_step(h, xc[..., i, :, :], bc[..., i, :, :],
                                     cc[..., i, :, :], lac[..., i, :, :],
                                     tri)
                ys.append(y_i)
            y = torch.stack(ys, dim=-3)
    y = y.reshape(*lead, nc * Q, P)
    return y[..., :S, :].to(x.dtype)


def _chunk_step(h, xq, bq, cq, la, tri):
    """One chunk of ``ssd_scan_chunked``: ``(h after it, its y)``."""
    decay = torch.exp(la - la.transpose(-1, -2))
    g = torch.where(tri, (cq @ bq.transpose(-1, -2)) * decay, 0.0)
    y = g @ xq + (cq * torch.exp(la)) @ h               # intra + inter
    la_end = la[..., -1:, :]
    h = torch.exp(la_end) * h \
        + bq.transpose(-1, -2) @ (xq * torch.exp(la_end - la))
    return h, y
