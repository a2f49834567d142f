"""Mamba-2 (SSD) mixer: conv frontend + selective state-space scan (port
of ``repro.models.mamba``).

Scalar decay per head, multi-head state (N, P).  The prefill scan runs
through ``ssd`` — the hand-written kernel on CUDA tensors (its plain
version on CPU tensors) when the kernel route is on, else the reference's
plain scans.  Decode carries (conv window, ssm state) instead of a KV cache
— O(1) per step.  Projections stay separate (x, z, B, C, dt) as in the
reference, so weights carry across as copies.

On a mesh the depthwise convolution runs on each rank's own rows and
channels, and the scan kernel on each rank's own heads
(``parallel.local``); activations are pinned at the reference's points.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.pairwise.fused_gather_gram import ieee_fp32
from ..kernels.ssd import ops as ssd_ops
from ..parallel.local import is_dtensor, per_head, per_row
from ..parallel.sharding import shard_constraint
from .layers import _ein, rms_norm

__all__ = ["mamba_shapes", "mamba_apply", "mamba_init_cache", "MAMBA_AXES"]

MAMBA_AXES = {"w_x": ("embed", "act_mlp"), "w_z": ("embed", "act_mlp"),
              "w_b": ("embed", None), "w_c": ("embed", None),
              "w_dt": ("embed", "ssm_heads"), "conv_x": (None, "act_mlp"),
              "conv_b": (None, None), "conv_c": (None, None),
              "a_log": ("ssm_heads",), "dt_bias": ("ssm_heads",),
              "d_skip": ("ssm_heads",), "norm": ("act_mlp",),
              "w_out": ("act_mlp", "embed")}

CONV_K = 4  # depthwise conv kernel width


def mamba_shapes(d_model: int, ssm_state: int, dtype, *, head_dim: int = 64,
                 expand: int = 2) -> dict:
    d_inner = expand * d_model
    H = d_inner // head_dim
    N = ssm_state
    s = d_model ** -0.5
    f32 = torch.float32
    return {
        "w_x": ((d_model, d_inner), dtype, s),
        "w_z": ((d_model, d_inner), dtype, s),
        "w_b": ((d_model, N), dtype, s),
        "w_c": ((d_model, N), dtype, s),
        "w_dt": ((d_model, H), dtype, s),
        "conv_x": ((CONV_K, d_inner), dtype, 0.5),
        "conv_b": ((CONV_K, N), dtype, 0.5),
        "conv_c": ((CONV_K, N), dtype, 0.5),
        "a_log": ((H,), f32, "zeros"),
        "dt_bias": ((H,), f32, "zeros"),
        "d_skip": ((H,), f32, "ones"),
        "norm": ((d_inner,), f32, "zeros"),
        "w_out": ((d_inner, d_model), dtype, d_inner ** -0.5),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """:func:`_causal_conv_local` on each rank's own rows and channels
    when ``x`` is a DTensor (its channels split as they are, ``w`` and the
    state split to match)."""
    if not is_dtensor(x):
        return _causal_conv_local(x, w, state)
    from torch.distributed.tensor import Replicate, Shard
    x_pl = tuple(p if p in (Shard(0), Shard(2)) else Replicate()
                 for p in x.placements)
    w_pl = tuple(Shard(1) if p == Shard(2) else Replicate() for p in x_pl)
    args = [(x, x_pl), (w, w_pl)]
    if state is not None:
        args.append((state, x_pl))
    return per_row(_causal_conv_local, x, *args,
                   out_placements=(x_pl, x_pl))


def _causal_conv_local(x: torch.Tensor, w: torch.Tensor,
                       state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along seq.  x (B,S,D), w (K,D).

    state (B, K-1, D) holds the trailing inputs for decode; returns
    (silu(y), new_state).  Long sequences use one depthwise conv op, short
    ones / decode steps shifted adds, as the reference does."""
    K = w.shape[0]
    B, S, D = x.shape
    if state is None:
        pad = x.new_zeros((B, K - 1, D))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                       # (B, S+K-1, D)
    if S >= 32:
        with ieee_fp32():
            y = F.conv1d(xp.transpose(1, 2), w.to(x.dtype).t()[:, None, :],
                         groups=D)
        # back to (B, S, D) rows: the scan kernel reads unit-stride rows
        y = y.transpose(1, 2).contiguous()
    else:
        y = sum(xp[:, i:i + S, :] * w[i][None, None, :] for i in range(K))
    return F.silu(y), xp[:, S:, :]


def mamba_apply(params, x: torch.Tensor, meta: dict, rules=None, *,
                cache: Optional[dict] = None, use_kernels: bool = True,
                ssd_impl: str = "step"):
    """x (B, S, d_model) -> (B, S, d_model).  cache: {'conv_*', 'h'}."""
    B, S, _ = x.shape
    d_inner, H, N, P = meta["d_inner"], meta["H"], meta["N"], meta["P"]

    xs = _ein("bsd,de->bse", x, params["w_x"])
    xs = shard_constraint(xs, rules, "batch", None, "act_mlp")
    z = _ein("bsd,de->bse", x, params["w_z"])
    b = _ein("bsd,dn->bsn", x, params["w_b"])
    c = _ein("bsd,dn->bsn", x, params["w_c"])
    dt = _ein("bsd,dh->bsh", x, params["w_dt"])

    cs = cache if cache is not None else {}
    xs, ncx = _causal_conv(xs, params["conv_x"], cs.get("conv_x"))
    b, ncb = _causal_conv(b, params["conv_b"], cs.get("conv_b"))
    c, ncc = _causal_conv(c, params["conv_c"], cs.get("conv_c"))

    dt = F.softplus(dt.float() + params["dt_bias"])       # (B, S, H)
    a = -torch.exp(params["a_log"])                        # (H,) < 0
    log_a = dt * a                                         # (B, S, H) <= 0

    xh = xs.reshape(B, S, H, P)
    xh = shard_constraint(xh, rules, "batch", None, "ssm_heads", None)
    xh_dt = xh * dt[..., None].to(xh.dtype)                # dt-scaled input
    # one B and one C for every head: broadcast views, never copied
    bh = b[:, :, None, :].expand(B, S, H, N)
    ch = c[:, :, None, :].expand(B, S, H, N)

    if cache is None:
        y = per_head(ssd_ops.ssd, xh_dt, log_a, bh, ch,
                     use_kernel=use_kernels, impl=ssd_impl)
        new_h = None
    else:
        # step recurrence for decode (S small)
        h = cache["h"]                                     # (B, H, N, P) fp32
        ys = []
        with ieee_fp32():
            for t in range(S):
                at = torch.exp(log_a[:, t])                # (B, H)
                h = h * at[..., None, None] + torch.einsum(
                    "bhn,bhp->bhnp", bh[:, t].float(), xh_dt[:, t].float())
                ys.append(torch.einsum("bhn,bhnp->bhp", ch[:, t].float(), h))
        y = torch.stack(ys, dim=1).to(x.dtype)             # (B, S, H, P)
        new_h = h

    y = y + params["d_skip"][None, None, :, None].to(y.dtype) * xh
    y = y.reshape(B, S, d_inner)
    y = rms_norm(y * F.silu(z), params["norm"], 1e-6)     # gated RMS norm
    out = _ein("bse,ed->bsd", y, params["w_out"])
    out = shard_constraint(out, rules, "batch", None, "act_embed")
    new_cache = (None if cache is None else
                 {"conv_x": ncx, "conv_b": ncb, "conv_c": ncc, "h": new_h})
    return out, new_cache


def mamba_init_cache(batch: int, meta: dict, dtype, device) -> dict:
    return {
        "conv_x": torch.zeros((batch, CONV_K - 1, meta["d_inner"]),
                              dtype=dtype, device=device),
        "conv_b": torch.zeros((batch, CONV_K - 1, meta["N"]), dtype=dtype,
                              device=device),
        "conv_c": torch.zeros((batch, CONV_K - 1, meta["N"]), dtype=dtype,
                              device=device),
        "h": torch.zeros((batch, meta["H"], meta["N"], meta["P"]),
                         dtype=torch.float32, device=device),
    }
