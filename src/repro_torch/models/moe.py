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

On a mesh the dispatch, the shuffle and the combine run on each rank's
own batch rows (``parallel.local.per_row``): capacity is per batch row,
so that is exact.  The expert batches are pinned to ``('batch',
'experts', None, 'act_embed')`` as in the reference, so experts split
over 'model' (EP) compute only their own slots; each rank combines the
slots of its own experts and the sum over 'model' is the constraint on
the output.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.pairwise.fused_gather_gram import ieee_fp32
from ..parallel.local import batch_placements, gathered, global_offset, \
    is_dtensor, map_local, per_row
from ..parallel.sharding import shard_constraint
from .layers import _ein

__all__ = ["moe_shapes", "moe_apply", "MOE_AXES"]

MOE_AXES = {"router": ("embed", None),
            "wi_gate": ("experts", "embed", "mlp"),
            "wi_up": ("experts", "embed", "mlp"),
            "wo": ("experts", "mlp", "embed")}


def moe_shapes(d_model: int, d_ff: int, num_experts: int, dtype) -> dict:
    s_in, s_out = d_model ** -0.5, d_ff ** -0.5
    E = num_experts
    return {"router": ((d_model, E), torch.float32, s_in),
            "wi_gate": ((E, d_model, d_ff), dtype, s_in),
            "wi_up": ((E, d_model, d_ff), dtype, s_in),
            "wo": ((E, d_ff, d_model), dtype, s_out)}


def _dispatch(gate_idx, gate_vals, E: int, C: int, S: int):
    """Per group (batch row): the (B, S, k) choices -> slot tables
    ``slot_src`` (B, E*C), the token each slot takes (``S``: none), and
    ``slot_gate`` (B, E*C), its gate."""
    B, _, top_k = gate_idx.shape
    A = S * top_k
    flat_e = gate_idx.reshape(B, A)
    flat_g = gate_vals.reshape(B, A)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = flat_e.gather(1, order)
    counts = F.one_hot(flat_e, E).sum(dim=1)               # (B, E)
    starts = torch.cumsum(counts, dim=-1) - counts
    pos = (torch.arange(A, device=gate_idx.device)[None, :]
           - starts.gather(1, sorted_e))
    dest = torch.where(pos < C, sorted_e * C + pos, E * C)  # E*C: dropped
    slot_src = torch.full((B, E * C + 1), S, dtype=torch.long,
                          device=gate_idx.device).scatter_(
                              1, dest, order // top_k)
    slot_gate = torch.zeros((B, E * C + 1), dtype=torch.float32,
                            device=gate_idx.device).scatter_(
                                1, dest, flat_g.gather(1, order))
    return slot_src[:, :E * C], slot_gate[:, :E * C]


def _shuffle(x, slot_src, E: int, C: int):
    """(B, S, d) tokens -> (B, E, C, d) expert batches (zero rows where a
    slot is empty)."""
    B, S, d = x.shape
    x_pad = torch.cat([x, x.new_zeros((B, 1, d))], dim=1)
    rows = torch.arange(B, device=x.device)[:, None]
    return x_pad[rows, slot_src].reshape(B, E, C, d)


def _combine(ye, slot_src, slot_gate, S: int, e0: int = 0):
    """(B, E', C, d) expert outputs of experts ``e0 .. e0 + E' - 1`` ->
    their gated sum per token (B, S, d)."""
    B, Eh, C, d = ye.shape
    src = slot_src[:, e0 * C:(e0 + Eh) * C]
    gate = slot_gate[:, e0 * C:(e0 + Eh) * C]
    y_slots = ye.reshape(B, Eh * C, d) * gate[..., None].to(ye.dtype)
    rows = torch.arange(B, device=ye.device)[:, None]
    flat = (src + rows * (S + 1)).reshape(-1)
    y = torch.zeros((B * (S + 1), d), dtype=y_slots.dtype,
                    device=ye.device).index_add_(0, flat,
                                                 y_slots.reshape(-1, d))
    return y.reshape(B, S + 1, d)[:, :S]


def _combine_sharded(ye, slot_src, slot_gate, S: int):
    """:func:`_combine` on each rank's own rows and experts: a mesh dim
    that splits experts, or holds a partial sum of them, gives a partial
    sum of the output."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    rows = batch_placements(ye)
    ye_pl = tuple(r if r == Shard(0) else
                  p if p in (Shard(1), Partial()) else Replicate()
                  for r, p in zip(rows, ye.placements))
    out_pl = tuple(r if r == Shard(0) else
                   Partial() if p in (Shard(1), Partial()) else Replicate()
                   for r, p in zip(rows, ye_pl))
    if tuple(ye.placements) != ye_pl:
        ye = ye.redistribute(ye.device_mesh, ye_pl)
    e0 = global_offset(ye)[1][1]
    return per_row(lambda yl, src, gate: _combine(yl, src, gate, S, e0),
                   ye, (ye, ye_pl), slot_src, slot_gate,
                   out_placements=out_pl)


def _expert_mm(x, w):
    """``einsum('becd,edf->becf', x, w)``: the batched expert product.  On
    DTensors it runs on the local shards (DTensor's own einsum backward
    views non-contiguous local shards here and fails).  Per mesh dim: rows
    split stay split (the weight whole), experts split on both, the
    contraction split on both gives a partial sum, the output features
    split on the weight give a split output."""
    if not is_dtensor(x):
        return _ein("becd,edf->becf", x, w)
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    w = gathered(w)
    if any(isinstance(p, Partial) for p in x.placements):
        x = x.redistribute(mesh, [Replicate() if isinstance(p, Partial)
                                  else p for p in x.placements])
    x_pl, w_pl, out_pl = [], [], []
    for px, pw in zip(x.placements, w.placements):
        if px == Shard(0):
            pl = (Shard(0), Replicate(), Shard(0))
        elif px == Shard(1) or pw == Shard(0):
            pl = (Shard(1), Shard(0), Shard(1))
        elif px == Shard(3) or pw == Shard(1):
            pl = (Shard(3), Shard(1), Partial())
        elif pw == Shard(2):
            pl = (Replicate(), Shard(2), Shard(3))
        else:
            pl = (Replicate(),) * 3
        x_pl.append(pl[0])
        w_pl.append(pl[1])
        out_pl.append(pl[2])
    if list(x.placements) != x_pl:
        x = x.redistribute(mesh, x_pl)
    if list(w.placements) != w_pl:
        w = w.redistribute(mesh, w_pl)
    return map_local(lambda xl, wl: _ein("becd,edf->becf", xl, wl), mesh,
                     (tuple(x_pl), tuple(w_pl)), tuple(out_pl))(x, w)


def moe_apply(params, x: torch.Tensor, *, top_k: int,
              capacity_factor: float, rules=None):
    """x (B, S, d) -> (B, S, d); aux losses returned as dict."""
    B, S, d = x.shape
    E = params["router"].shape[1]
    C = max(1, int(capacity_factor * S * top_k / E))

    with ieee_fp32():
        logits = x.float() @ gathered(params["router"])
    probs = torch.softmax(logits, dim=-1)                  # (B, S, E)
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)  # (B, S, k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    # load-balance auxiliary loss (Switch-style)
    me = probs.mean(dim=(0, 1))
    first = per_row(lambda g: F.one_hot(g[..., 0], E).float(), gate_idx,
                    gate_idx)
    ce = first.mean(dim=(0, 1))
    aux = {"load_balance": E * torch.sum(me * ce)}

    slot_src, slot_gate = per_row(
        lambda gi, gv: _dispatch(gi, gv, E, C, S), gate_idx, gate_idx,
        gate_vals, out_placements=None if not is_dtensor(gate_idx) else
        (batch_placements(gate_idx),) * 2)
    xe = per_row(lambda xl, src: _shuffle(xl, src, E, C), x, x, slot_src)
    xe = shard_constraint(xe, rules, "batch", "experts", None, "act_embed")

    h = _expert_mm(xe, params["wi_gate"])                   # becd,edf
    u = _expert_mm(xe, params["wi_up"])
    h = shard_constraint(F.silu(h) * u, rules, "batch", "experts", None,
                         "act_mlp")
    ye = _expert_mm(h, params["wo"])                # becf,efd -> (B,E,C,d)
    if is_dtensor(ye):
        y = _combine_sharded(ye, slot_src, slot_gate, S)
    else:
        y = _combine(ye, slot_src, slot_gate, S)
    y = shard_constraint(y, rules, "batch", None, "act_embed")
    return y.to(x.dtype), aux
