"""Mixture-of-Experts layer with capacity-constrained sparse dispatch (port
of ``repro.models.moe``).

The reference's GShard semantics, per group (batch row):

  1. top-k routing over the router softmax, gates renormalised;
  2. a STABLE argsort of the (token, expert) assignments by expert; the
     position within the expert's segment enforces the capacity
     ``C = max(1, int(cf * S * k / E))`` and overflow drops;
  3. one gather builds the (B, E, C, d) expert batches -> batched expert
     FFN -> weighted scatter-add combines results.

The reference drops overflow with ``.at[dest].set(mode="drop")`` at
``dest = E * C``; here that slot is a real last column of an ``E * C + 1``
buffer that is sliced away.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.pairwise.fused_gather_gram import ieee_fp32
from .layers import _ein

__all__ = ["moe_shapes", "moe_apply"]


def moe_shapes(d_model: int, d_ff: int, num_experts: int, dtype) -> dict:
    s_in, s_out = d_model ** -0.5, d_ff ** -0.5
    E = num_experts
    return {"router": ((d_model, E), torch.float32, s_in),
            "wi_gate": ((E, d_model, d_ff), dtype, s_in),
            "wi_up": ((E, d_model, d_ff), dtype, s_in),
            "wo": ((E, d_ff, d_model), dtype, s_out)}


def moe_apply(params, x: torch.Tensor, *, top_k: int,
              capacity_factor: float):
    """x (B, S, d) -> (B, S, d); aux losses returned as dict."""
    B, S, d = x.shape
    E = params["router"].shape[1]
    C = max(1, int(capacity_factor * S * top_k / E))

    with ieee_fp32():
        logits = x.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)                  # (B, S, E)
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)  # (B, S, k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    # load-balance auxiliary loss (Switch-style)
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(gate_idx[..., 0], E).float().mean(dim=(0, 1))
    aux = {"load_balance": E * torch.sum(me * ce)}

    # per group: (A,) expert ids -> slot tables (E*C,)
    A = S * top_k
    flat_e = gate_idx.reshape(B, A)
    flat_g = gate_vals.reshape(B, A)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = flat_e.gather(1, order)
    counts = F.one_hot(flat_e, E).sum(dim=1)               # (B, E)
    starts = torch.cumsum(counts, dim=-1) - counts
    pos = (torch.arange(A, device=x.device)[None, :]
           - starts.gather(1, sorted_e))
    dest = torch.where(pos < C, sorted_e * C + pos, E * C)  # E*C: dropped
    slot_src = torch.full((B, E * C + 1), S, dtype=torch.long,
                          device=x.device).scatter_(1, dest, order // top_k)
    slot_gate = torch.zeros((B, E * C + 1), dtype=torch.float32,
                            device=x.device).scatter_(
                                1, dest, flat_g.gather(1, order))
    slot_src, slot_gate = slot_src[:, :E * C], slot_gate[:, :E * C]

    x_pad = torch.cat([x, x.new_zeros((B, 1, d))], dim=1)
    rows = torch.arange(B, device=x.device)[:, None]
    xe = x_pad[rows, slot_src].reshape(B, E, C, d)          # the shuffle

    h = _ein("becd,edf->becf", xe, params["wi_gate"])
    u = _ein("becd,edf->becf", xe, params["wi_up"])
    ye = _ein("becf,efd->becd", F.silu(h) * u, params["wo"])  # (B, E, C, d)
    y_slots = ye.reshape(B, E * C, d) * slot_gate[..., None].to(ye.dtype)

    flat = (slot_src + rows * (S + 1)).reshape(-1)
    y = torch.zeros((B * (S + 1), d), dtype=y_slots.dtype,
                    device=x.device).index_add_(0, flat,
                                                y_slots.reshape(-1, d))
    return y.reshape(B, S + 1, d)[:, :S].to(x.dtype), aux
