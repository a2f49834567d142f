"""Elastic scaling + straggler mitigation (fleet-control plane); a copy of
``repro.train.elastic`` (pure Python).

On a 1000+ node fleet the control plane must (a) notice dead/slow hosts,
(b) rebuild the mesh without them, and (c) restart from the last checkpoint
with state resharded to the new topology.  The *policy* logic here is pure
and unit-tested; a single process exercises it by simulating failures
and restoring checkpoints onto another device (see
tests/test_torch_checkpoint.py).

Design decisions (DESIGN.md §FT):
  * failures drop whole data-parallel replicas — the 'model' axis (TP) is
    intra-pod and treated as an atomic failure domain;
  * step-time EMA per host flags stragglers at > straggler_factor x median;
    persistent stragglers are evicted like failures (checkpoint + rescale);
  * global batch is kept constant by raising per-replica batch when the
    replica count shrinks (synchronous SGD semantics preserved).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

__all__ = ["ElasticPolicy", "StragglerMonitor", "rescale_mesh_shape"]


@dataclasses.dataclass
class ElasticPolicy:
    min_data_parallel: int = 1
    straggler_factor: float = 2.0
    straggler_patience: int = 5       # consecutive slow steps before evict
    heartbeat_timeout_s: float = 60.0


def rescale_mesh_shape(mesh_shape: dict, healthy_replicas: int,
                       policy: ElasticPolicy) -> Optional[dict]:
    """Given the current axis sizes (e.g. {'pod':2,'data':16,'model':16})
    and the number of healthy DP replicas (pod*data), return the new axis
    sizes, or None if below the survivable minimum.

    DP replicas are interchangeable, so we keep 'model' fixed and shrink the
    data axes to the largest feasible factorization."""
    model = mesh_shape.get("model", 1)
    if healthy_replicas < policy.min_data_parallel:
        return None
    if "pod" in mesh_shape:
        pods = mesh_shape["pod"]
        per_pod = mesh_shape["data"]
        # prefer dropping whole pods only when a pod is fully dead;
        # otherwise shrink 'data' to the min healthy count across pods
        new_data = healthy_replicas // pods
        if new_data >= 1:
            return {"pod": pods, "data": new_data, "model": model}
        return {"data": healthy_replicas, "model": model}
    return {"data": healthy_replicas, "model": model}


def scale_batch(global_batch: int, old_replicas: int,
                new_replicas: int) -> int:
    """Per-replica batch that preserves the global batch (rounded up)."""
    per = math.ceil(global_batch / new_replicas)
    return per


class StragglerMonitor:
    """Tracks per-host step-time EMAs; flags persistent stragglers."""

    def __init__(self, num_hosts: int, policy: ElasticPolicy,
                 ema: float = 0.7):
        self.policy = policy
        self.ema = ema
        self.times = [None] * num_hosts
        self.slow_streak = [0] * num_hosts

    def observe(self, host: int, step_time: float) -> None:
        prev = self.times[host]
        self.times[host] = (step_time if prev is None
                            else self.ema * prev + (1 - self.ema) * step_time)

    def median(self) -> float:
        vals = sorted(t for t in self.times if t is not None)
        if not vals:
            return 0.0
        return vals[len(vals) // 2]

    def update_flags(self) -> list[int]:
        """Returns hosts to evict (exceeded patience)."""
        med = self.median()
        evict = []
        for h, t in enumerate(self.times):
            if t is None or med == 0.0:
                continue
            if t > self.policy.straggler_factor * med:
                self.slow_streak[h] += 1
            else:
                self.slow_streak[h] = 0
            if self.slow_streak[h] >= self.policy.straggler_patience:
                evict.append(h)
        return evict
