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
run) each runs its loop body once and counts it once per position or
chunk (``launch.op_analysis.meta_repeat``).
"""

from __future__ import annotations

import torch

from ..pairwise.fused_gather_gram import ieee_fp32

__all__ = ["ssd_scan_ref", "ssd_scan_chunked"]


def ssd_scan_ref(x: torch.Tensor, log_a: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t x_tᵀ ;  y_t = c_t · h_t."""
    S, P = x.shape[-2:]
    if x.is_meta and S > 1:
        return _meta(ssd_scan_ref, S, 1, x, log_a, b, c)
    N = b.shape[-1]
    xf, laf, bf, cf = x.float(), log_a.float(), b.float(), c.float()
    h = x.new_zeros((*x.shape[:-2], N, P), dtype=torch.float32)
    ys = []
    for t in range(S):
        h = torch.exp(laf[..., t])[..., None, None] * h \
            + bf[..., t, :, None] * xf[..., t, None, :]
        ys.append((cf[..., t, :, None] * h).sum(-2))
    if not ys:
        return x.new_zeros(x.shape)
    return torch.stack(ys, dim=-2).to(x.dtype)


def _meta(fn, n: int, width: int, x, log_a, b, c):
    """``fn`` over ``n`` runs of ``width`` positions, on meta tensors: one
    run, counted ``n`` times."""
    from ...launch.op_analysis import meta_repeat
    seq = (Ellipsis, slice(0, width), slice(None))
    return meta_repeat(fn, n, x.shape, (seq, (Ellipsis, slice(0, width)),
                                        seq, seq), x, log_a, b, c)


def ssd_scan_chunked(x: torch.Tensor, log_a: torch.Tensor, b: torch.Tensor,
                     c: torch.Tensor, *, chunk: int = 128) -> torch.Tensor:
    """Chunked SSD (same recurrence as ``ssd_scan_ref``)."""
    S, P = x.shape[-2:]
    if x.is_meta and S > chunk:
        return _meta(lambda *a: ssd_scan_chunked(*a, chunk=chunk),
                     -(-S // chunk), chunk, x, log_a, b, c)
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
    ys = []
    with ieee_fp32():
        for i in range(nc):
            xq, bq, cq, la = (xc[..., i, :, :], bc[..., i, :, :],
                              cc[..., i, :, :], lac[..., i, :, :])
            decay = torch.exp(la - la.transpose(-1, -2))
            g = torch.where(tri, (cq @ bq.transpose(-1, -2)) * decay, 0.0)
            ys.append(g @ xq + (cq * torch.exp(la)) @ h)    # intra + inter
            la_end = la[..., -1:, :]
            h = torch.exp(la_end) * h \
                + bq.transpose(-1, -2) @ (xq * torch.exp(la_end - la))
    y = torch.stack(ys, dim=-3).reshape(*lead, nc * Q, P)
    return y[..., :S, :].to(x.dtype)
