"""The plain reference of an X2Y (bipartite) cell.

Plain PyTorch and NumPy only: nothing here imports the port, the JAX
package or JAX.  From the tables and sizes the harness made it works out
again what a request must return and what the planner must guarantee:

* ``cosine_x2y``: the (mx, my) cosine of every X row against every Y row,
  in float64;
* ``cosine_x2y_tf32``: the same one precision below the configuration's
  float32, in TF32 (operands rounded to TF32's 10-bit mantissa, products
  summed in float32), the control that a check has to fail;
* ``x2y_violations``: the (x, y) pairs that meet at no reducer, and the
  reducers whose distinct inputs' sizes exceed the capacity, counted from
  the schema's bins and reducer lists (X ids ``0..mx-1``, Y ids
  ``mx..mx+my-1``) and the sizes.
"""

from __future__ import annotations

import numpy as np
import torch

from chipbench.reference import (_chunks, _gram_tf32, _overfull, _unit_rows,
                                 reducer_rows, tf32)

__all__ = ["cosine_x2y", "cosine_x2y_tf32", "x2y_violations"]


def cosine_x2y(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(mx, d), (my, d) -> (mx, my) float64 cosine similarity."""
    return _unit_rows(x) @ _unit_rows(y).T


def cosine_x2y_tf32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """:func:`cosine_x2y` in TF32: the cross Gram of the rounded rows over
    the rounded rows' norms, every product exact in float32 and summed in
    float32."""
    nx = tf32(x).square().sum(-1).sqrt()
    ny = tf32(y).square().sum(-1).sqrt()
    return _gram_tf32(x, y) / (nx[:, None] * ny[None, :])


def x2y_violations(bins, reducers, wx, wy, q: float, slack: float) -> dict:
    """X2Y schema over ``len(wx)`` X and ``len(wy)`` Y inputs: (x, y) pairs
    that meet at no reducer, and reducers whose distinct inputs' sizes sum
    above ``q + slack``."""
    wx, wy = np.asarray(wx, np.float64), np.asarray(wy, np.float64)
    mx, my = len(wx), len(wy)
    groups = reducer_rows(bins, reducers)
    met = np.zeros(mx * my, bool)
    for rows in groups:
        n = rows.shape[1]
        for c in _chunks(rows, n * n):
            a, b = c[:, :, None], c[:, None, :]
            met[(a * my + b - mx)[(a < mx) & (b >= mx)]] = True
    return {"uncovered_pairs": int((~met).sum()),
            "overfull_reducers": _overfull(groups, np.concatenate([wx, wy]),
                                           q, slack)}
