"""Faults planted under the timed path, for the test that shows each one
turns ``correct`` false.  The benchmark's own runs plant none.

* ``stale``: the entry returns the previous request's matrix (a request
  whose answer is left unchanged);
* ``half_batch``: every Gram launch leaves the second half of its reducers
  out (their blocks are zeros);
* ``one_answer``: one similarity of the matrix is altered by 1e-3 where the
  entry returns it.
"""

from __future__ import annotations

import contextlib
import functools

__all__ = ["FAULTS", "planted"]

FAULTS = ("stale", "half_batch", "one_answer")
_ENTRIES = ("pairwise_similarity",)
_KERNELS = ("fused_gather_gram",)


def _stale(fn):
    last = []

    @functools.wraps(fn)
    def call(*args, **kwargs):
        sims, plan, schema = fn(*args, **kwargs)
        if last:
            sims, last[0] = last[0], sims
        else:
            last.append(sims)
        return sims, plan, schema
    return call


def _one_answer(fn):
    @functools.wraps(fn)
    def call(*args, **kwargs):
        sims, plan, schema = fn(*args, **kwargs)
        sims[0, 1] += 1e-3
        return sims, plan, schema
    return call


def _half_batch(fn):
    @functools.wraps(fn)
    def call(*args):
        g = fn(*args)
        g[g.shape[0] - g.shape[0] // 2:] = 0.0
        return g
    return call


def _patches(name: str) -> list:
    """``(module, attribute, wrap)`` for fault ``name``."""
    from repro_torch.mapreduce import allpairs, executors
    if name in ("stale", "one_answer"):
        wrap = _stale if name == "stale" else _one_answer
        return [(allpairs, a, wrap) for a in _ENTRIES]
    if name == "half_batch":
        return [(executors, k, _half_batch) for k in _KERNELS]
    raise ValueError(f"unknown fault {name!r} (have {FAULTS})")


@contextlib.contextmanager
def planted(name):
    """The port, in this process, committing fault ``name`` (none for
    ``None``) until the block ends."""
    saved = []
    try:
        for mod, attr, wrap in (_patches(name) if name else []):
            saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, wrap(saved[-1][2]))
        yield
    finally:
        for mod, attr, old in reversed(saved):
            setattr(mod, attr, old)
