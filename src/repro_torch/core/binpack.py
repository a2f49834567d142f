"""Bin-packing primitives used by every approximation algorithm in the paper.

First-Fit Decreasing (FFD) and Best-Fit Decreasing (BFD) give the classical
11/9 * OPT + O(1) guarantee the paper leans on (Theorem 10, 18, 26): every bin
except possibly one is at least half full, so ``#bins <= 2 * s / b`` for bin
size ``b`` and total weight ``s``.

``ffd``/``bfd`` are O(n log n): FFD finds the leftmost bin with enough space
by descending a max segment tree over bin spaces, BFD keeps the open-bin
spaces in a sorted list.  Both produce bit-identical bins to the textbook
O(n^2) scans (kept as ``ffd_reference``/``bfd_reference`` for tests and the
packing benchmark) — the planner's estimate phase packs once per candidate
bin size, so packing must not dominate planning time (see DESIGN.md,
"strategy registry").

``pack_prefix`` is the array-native formulation for million-input instances
(DESIGN.md "hierarchical planning"): next-fit decreasing over prefix sums.
One vectorized ``searchsorted`` finds, for every sorted position, where a
bin starting there would end; walking that jump table from position 0
yields the bin boundaries in O(#bins) steps — no per-item Python
iteration.  Adjacent bins always sum past capacity (else they would have
merged), which keeps the half-full count guarantee the paper's theorems
lean on (``#bins <= ceil(2s/b) + 1``), so the hierarchical planner's
composed gap ledger stays a provable constant.
"""

from __future__ import annotations

from bisect import bisect_left, insort
from typing import Sequence

import numpy as np

__all__ = [
    "ffd",
    "bfd",
    "pack",
    "pack_prefix",
    "prefix_bins",
    "num_bins_lower_bound",
    "ffd_reference",
    "bfd_reference",
]

_EPS = 1e-12


def _decreasing_order(weights: np.ndarray) -> np.ndarray:
    # stable sort for reproducibility
    return np.argsort(-weights, kind="stable")


def _check_fits(w: np.ndarray, bin_size: float) -> None:
    if np.any(w > bin_size + _EPS):
        bad = int(np.argmax(w))
        raise ValueError(
            f"item {bad} (w={w[bad]}) does not fit in bin of size {bin_size}")


def ffd(weights: Sequence[float], bin_size: float) -> list[list[int]]:
    """First-Fit Decreasing.  Returns bin -> list of item indices.

    Leftmost-fitting-bin queries run over a max segment tree in which every
    not-yet-opened bin reports a full ``bin_size`` of space, so "open a new
    bin" is the same query as "reuse an old one".  O(n log n) total.
    """
    w = np.asarray(weights, dtype=np.float64)
    _check_fits(w, bin_size)
    n = len(w)
    if n == 0:
        return []
    size = 1
    while size < n:
        size *= 2
    # tree[1] is the root; leaves are tree[size : size + n] (extra leaves
    # beyond n stay at -inf so they are never chosen).
    tree = np.full(2 * size, -np.inf)
    tree[size:size + n] = bin_size
    for node in range(size - 1, 0, -1):
        tree[node] = max(tree[2 * node], tree[2 * node + 1])
    bins: list[list[int]] = []
    for i in _decreasing_order(w):
        need = w[i] - _EPS
        node = 1
        while node < size:  # descend to the leftmost leaf with enough space
            node = 2 * node if tree[2 * node] >= need else 2 * node + 1
        b = node - size
        while b >= len(bins):
            bins.append([])
        bins[b].append(int(i))
        tree[node] -= w[i]
        node //= 2
        while node:
            tree[node] = max(tree[2 * node], tree[2 * node + 1])
            node //= 2
    return [b for b in bins if b]


def bfd(weights: Sequence[float], bin_size: float) -> list[list[int]]:
    """Best-Fit Decreasing: place each item into the fullest bin it fits.

    Open-bin spaces live in a sorted list of ``(space, bin_id)``; best fit is
    the first entry at least the item's size (ties resolve to the lowest bin
    id, matching the sequential scan).
    """
    w = np.asarray(weights, dtype=np.float64)
    _check_fits(w, bin_size)
    bins: list[list[int]] = []
    srt: list[tuple[float, int]] = []      # (space, bin_id), ascending
    for i in _decreasing_order(w):
        j = bisect_left(srt, (w[i] - _EPS, -1))
        if j == len(srt):
            bins.append([int(i)])
            insort(srt, (bin_size - w[i], len(bins) - 1))
        else:
            space, b = srt.pop(j)
            bins[b].append(int(i))
            insort(srt, (space - w[i], b))
    return bins


def ffd_reference(weights: Sequence[float],
                  bin_size: float) -> list[list[int]]:
    """Textbook O(n^2) FFD — oracle for testing the fast implementation."""
    w = np.asarray(weights, dtype=np.float64)
    _check_fits(w, bin_size)
    bins: list[list[int]] = []
    space: list[float] = []
    for i in _decreasing_order(w):
        placed = False
        for b in range(len(bins)):
            if w[i] <= space[b] + _EPS:
                bins[b].append(int(i))
                space[b] -= w[i]
                placed = True
                break
        if not placed:
            bins.append([int(i)])
            space.append(bin_size - w[i])
    return bins


def bfd_reference(weights: Sequence[float],
                  bin_size: float) -> list[list[int]]:
    """Textbook O(n^2) BFD — oracle for testing the fast implementation."""
    w = np.asarray(weights, dtype=np.float64)
    _check_fits(w, bin_size)
    bins: list[list[int]] = []
    space: list[float] = []
    for i in _decreasing_order(w):
        best, best_space = -1, np.inf
        for b in range(len(bins)):
            if w[i] <= space[b] + _EPS and space[b] < best_space:
                best, best_space = b, space[b]
        if best < 0:
            bins.append([int(i)])
            space.append(bin_size - w[i])
        else:
            bins[best].append(int(i))
            space[best] -= w[i]
    return bins


def pack_prefix(weights: Sequence[float], bin_size: float) -> np.ndarray:
    """Array-native sorted-prefix-sum packing: (n,) int64 bin assignment.

    Next-fit decreasing, vectorized.  With ``csum`` the inclusive prefix
    sums of the descending-sorted weights, a single ``searchsorted(csum,
    csum - w + b)`` computes for *every* sorted position the end of the bin
    that would start there; the actual bin boundaries are the orbit of
    position 0 under that jump table, O(#bins) trivially-cheap steps
    instead of FFD's inherently sequential per-item placement.  The first
    item of each bin did not fit in the previous bin, so adjacent bins sum
    past capacity and ``#bins <= ceil(2s / b) + 1`` — the same half-full
    guarantee behind Theorem 10's ``#bins <= 2s/b``.  A million weights
    pack in milliseconds where the segment-tree FFD takes seconds.

    Returns bin ids in original item order; ids are contiguous from 0 in
    descending-weight order.  Empirically FFD packs a few percent tighter;
    the hierarchical planner accounts for the difference in its
    ``gap_inner`` ledger term, which this construction provably bounds.
    """
    w = np.asarray(weights, dtype=np.float64)
    if w.size and bin_size <= 0:
        raise ValueError(f"bin_size must be positive, got {bin_size}")
    _check_fits(w, bin_size)
    n = len(w)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    order = _decreasing_order(w)
    ws = w[order]
    csum = np.cumsum(ws)
    cap = bin_size
    # float cumsum error can push a boundary item over capacity at very
    # large n; shave the measured overshoot off the working capacity and
    # re-split (overshoot is rounding noise, so this converges immediately)
    for _ in range(4):
        ends = np.searchsorted(csum, csum - ws + cap + _EPS, side="right")
        ends = np.maximum(ends, np.arange(1, n + 1))  # always make progress
        bounds = [0]
        pos = 0
        while pos < n:  # orbit walk: one step per *bin*, not per item
            pos = int(ends[pos])
            bounds.append(pos)
        counts = np.diff(np.asarray(bounds, dtype=np.int64))
        bin_of_sorted = np.repeat(
            np.arange(len(counts), dtype=np.int64), counts)
        over = float(np.bincount(bin_of_sorted, weights=ws).max()) - bin_size
        if over <= _EPS:
            break
        cap -= over
    else:  # pragma: no cover - float noise is orders below bin_size
        raise AssertionError("prefix pack failed to fit bins")
    bin_of = np.empty(n, dtype=np.int64)
    bin_of[order] = bin_of_sorted
    return bin_of


def prefix_bins(weights: Sequence[float], bin_size: float) -> list[list[int]]:
    """``pack_prefix`` in the bin -> item-ids format of ``ffd``/``bfd``."""
    w = np.asarray(weights, dtype=np.float64)
    bin_of = pack_prefix(w, bin_size)
    if bin_of.size == 0:
        return []
    order = _decreasing_order(w)
    sorted_bins = bin_of[order]
    cuts = np.flatnonzero(np.diff(sorted_bins)) + 1
    return [g.tolist() for g in np.split(order, cuts)]


def pack(weights: Sequence[float], bin_size: float,
         method: str = "ffd") -> list[list[int]]:
    if method == "ffd":
        return ffd(weights, bin_size)
    if method == "bfd":
        return bfd(weights, bin_size)
    if method == "prefix":
        return prefix_bins(weights, bin_size)
    if method == "best":
        a, b = ffd(weights, bin_size), bfd(weights, bin_size)
        return a if len(a) <= len(b) else b
    raise ValueError(method)


def num_bins_lower_bound(weights: Sequence[float], bin_size: float) -> int:
    s = float(np.sum(np.asarray(weights, dtype=np.float64)))
    return int(np.ceil(s / bin_size - 1e-12))
