"""X2Y application: skew join of X(A, B) and Y(B, C) on a heavy hitter.

Port of ``repro.mapreduce.skewjoin``.  All X- and Y-tuples sharing the
heavy-hitter B-value must pairwise meet (Example 3 of the paper).  The X2Y
planner packs tuples into bins; each reducer joins one X-bin against one
Y-bin, and execution dispatches through the executor registry like every
other application.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import plan_x2y
from repro_torch.core.schema import MappingSchema

from .engine import _as_tables

__all__ = ["skew_join", "join", "join_block"]


def join_block(xblock: torch.Tensor, xmask: torch.Tensor,
               yblock: torch.Tensor, ymask: torch.Tensor) -> torch.Tensor:
    """Per-reducer cross-product-concat: (Lx, dx), (Lx,), (Ly, dy), (Ly,)
    -> (Lx, Ly, dx + dy) joined payloads; invalid pairs -> 0.

    This is the skew join's reducer for the rectangular executor protocol
    (``run_x2y``).  It is *not* a Gram block (no ``fused_metric`` tag), so
    the fused executor takes its counted rect-bucketed fallback, while
    dispatch still flows through each executor's ``run_x2y``."""
    Lx, Ly = xblock.shape[0], yblock.shape[0]
    gx = xblock[:, None, :].expand(Lx, Ly, xblock.shape[-1])
    gy = yblock[None, :, :].expand(Lx, Ly, yblock.shape[-1])
    joined = torch.cat([gx, gy], dim=-1)
    valid = xmask[:, None] & ymask[None, :]
    return torch.where(valid[:, :, None], joined, 0.0)


def skew_join(
    x_vals,                       # (mx, dx) — A-side payloads for one HH key
    y_vals,                       # (my, dy) — C-side payloads
    *,
    q: float,
    wx=None,
    wy=None,
    schema: Optional[MappingSchema] = None,
    mesh=None,
    executor: str = "dense",
    device=None,
):
    """Join every X row with every Y row through an X2Y mapping schema.

    Returns (pairs (mx, my, dx+dy), schema).  The output is assembled by
    scattering per-reducer cross blocks — each (x, y) pair is produced by
    >= 1 reducer (coverage guarantee), duplicates agree.  ``executor``
    selects a registry executor (or an
    :class:`~repro_torch.mapreduce.executors.Executor` instance) and
    execution dispatches through its ``run_x2y``; outputs are identical
    across executors."""
    from .allpairs import _mesh_pad, _x2y_plan_for
    from .executors import get_executor
    ex = get_executor(executor)
    xt, yt = _as_tables((x_vals, y_vals), device)
    mx, my = xt.shape[0], yt.shape[0]
    pad = _mesh_pad(mesh)
    if schema is None:
        wx_ = np.full(mx, 1.0) if wx is None else np.asarray(wx, float)
        wy_ = np.full(my, 1.0) if wy is None else np.asarray(wy, float)
        schema = plan_x2y(wx_, wy_, q)
    plan = _x2y_plan_for(schema, mx, pad_reducers_to=pad, pad_slots_to=1)
    out = ex.run_x2y((xt, yt), plan, join_block, (mx, my), mesh=mesh,
                     device=xt.device)
    return out, schema


# registry-era name (the similarity apps say "executor", the join docs say
# "join"); both names are the same callable
join = skew_join
