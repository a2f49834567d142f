"""The plain reference the benchmark judges the port by.

Plain PyTorch and NumPy only: nothing here imports the port, the JAX
package or JAX.  It works out again, from the tables and sizes the harness
made, what a request must return and what the planner must guarantee:

* ``cosine_a2a``: the similarity matrix in float64 (cosine of every pair;
  the diagonal is 0, no self-pairs);
* ``cosine_a2a_tf32``: the same computed one precision below the
  configuration's float32, in TF32 (operands rounded to TF32's 10-bit
  mantissa, products summed in float32), the control that a check has to
  fail;
* ``a2a_violations``: the schema's pairs that meet at no reducer, and its
  reducers whose load exceeds the capacity, counted from the schema's bins
  and reducer lists and the sizes.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

__all__ = ["cosine_a2a", "cosine_a2a_tf32", "tf32", "max_abs_err",
           "reducer_rows", "a2a_violations"]

# at most this many (reducer, slot, slot) entries are marked at once
_CHUNK = 1 << 24


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    x = x.double()
    return x / x.square().sum(-1, keepdim=True).sqrt()


def cosine_a2a(x: torch.Tensor) -> torch.Tensor:
    """(m, d) -> (m, m) float64 cosine similarity, zero diagonal."""
    u = _unit_rows(x)
    s = u @ u.T
    s.diagonal().zero_()
    return s


def tf32(t: torch.Tensor) -> torch.Tensor:
    """Float32 ``t`` rounded to the nearest TF32 value (10 stored mantissa
    bits, ties to even)."""
    bits = t.float().contiguous().view(torch.int32)
    bits = bits + 0x0FFF + ((bits >> 13) & 1)
    return (bits & ~0x1FFF).view(torch.float32)


def _gram_tf32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """TF32 products summed in float32 (an IEEE float32 product of the
    rounded operands: every product of two TF32 values is exact)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return tf32(x) @ tf32(y).T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def cosine_a2a_tf32(x: torch.Tensor) -> torch.Tensor:
    """:func:`cosine_a2a` in TF32: the Gram of the rounded rows, normalised
    by its own diagonal, zero diagonal."""
    g = _gram_tf32(x, x)
    n = g.diagonal().sqrt()
    s = g / (n[:, None] * n[None, :])
    s.diagonal().zero_()
    return s


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest ``|got - want|``; ``inf`` where a shape differs or an entry
    is not finite."""
    if tuple(got.shape) != tuple(want.shape):
        return math.inf
    d = (got.to(want.device, torch.float64) - want).abs()
    if not bool(torch.isfinite(d).all()):
        return math.inf
    return float(d.max()) if d.numel() else 0.0


def reducer_rows(bins, reducers) -> list:
    """The input ids of every reducer (the union of its bins), as
    ``(R_n, n)`` int64 arrays, one per number ``n`` of ids a reducer
    holds (repeats kept)."""
    blen = np.fromiter((len(b) for b in bins), np.int64, len(bins))
    bptr = np.concatenate([[0], np.cumsum(blen)])
    bflat = np.fromiter(itertools.chain.from_iterable(bins), np.int64,
                        int(bptr[-1]))
    rlen = np.fromiter((len(r) for r in reducers), np.int64, len(reducers))
    rflat = np.fromiter(itertools.chain.from_iterable(reducers), np.int64,
                        int(rlen.sum()))
    sizes = blen[rflat]
    first = np.cumsum(sizes) - sizes
    pos = np.repeat(bptr[rflat] - first, sizes) + np.arange(int(sizes.sum()))
    ids = bflat[pos]
    owner = np.repeat(np.arange(len(reducers)), rlen)
    count = np.bincount(owner, weights=sizes,
                        minlength=len(reducers)).astype(np.int64)
    start = np.cumsum(count) - count
    return [ids[start[count == n][:, None] + np.arange(n)]
            for n in np.unique(count) if n > 0]


def _chunks(rows: np.ndarray, n_per_row: int):
    step = max(1, _CHUNK // max(n_per_row, 1))
    for i in range(0, rows.shape[0], step):
        yield rows[i:i + step]


def _overfull(groups, sizes: np.ndarray, q: float, slack: float) -> int:
    """Reducers whose distinct inputs' sizes sum above ``q + slack``."""
    bad = 0
    for rows in groups:
        srt = np.sort(rows, axis=1)
        w = sizes[srt]
        w[:, 1:] *= srt[:, 1:] != srt[:, :-1]
        bad += int((w.sum(axis=1) > q + slack).sum())
    return bad


def a2a_violations(bins, reducers, sizes, q: float, slack: float) -> dict:
    """A2A schema over ``len(sizes)`` inputs: unordered pairs of distinct
    inputs that meet at no reducer, and reducers over capacity."""
    sizes = np.asarray(sizes, np.float64)
    m = len(sizes)
    groups = reducer_rows(bins, reducers)
    met = np.zeros(m * m, bool)
    for rows in groups:
        n = rows.shape[1]
        for c in _chunks(rows, n * n):
            met[(c[:, :, None] * m + c[:, None, :]).ravel()] = True
    met = met.reshape(m, m)
    met |= met.T
    uncovered = int((~met[np.triu_indices(m, 1)]).sum())
    return {"uncovered_pairs": uncovered,
            "overfull_reducers": _overfull(groups, sizes, q, slack)}
