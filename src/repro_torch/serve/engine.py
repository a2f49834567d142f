"""``PairwiseService``: the paper-workload serving facade, similarity path.

Port of ``repro.serve.engine.PairwiseService`` (``similarity`` only).  All-
pairs similarity queries are planned through the registry planner (plans
memoized by weight profile in ``PLAN_CACHE``) and executed on a private
executor instance, so dispatch telemetry is scoped to the service.  Every
response carries the reference's ``info`` keys: plan provenance, plan-cache
hit, the fused path taken (``"kernel"`` on the card), the upload-cache
counters and the comm-ledger reconciliation.

Later slices: ``some_pairs``, ``x2y``, block serving and the streaming edit
API; ``BatchedServer`` comes with the LM stack.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.obs import LEDGER as _LEDGER
from repro_torch.obs import REGISTRY as _OBS_REGISTRY
from repro_torch.obs import span as _obs_span

__all__ = ["PairwiseService"]


class PairwiseService:
    """Serve all-pairs similarity through planned schemas.

    Each query brings its own input table (and optionally per-input
    sizes); the service plans a mapping schema — repeated weight profiles
    hit ``repro_torch.core.PLAN_CACHE`` and skip planning — and executes it
    on a private instance of a registry executor ("dense" / "bucketed" /
    "fused") on ``device`` (``None`` means CUDA and raises without a card).
    """

    def __init__(self, q: float, *, metric: str = "dot", mesh=None,
                 executor: str = "bucketed", use_kernel: bool = False,
                 tenant: str = "default", device=None):
        from repro_torch.mapreduce import make_executor
        if mesh is not None:
            raise NotImplementedError(
                "sharded execution over a mesh is not ported yet")
        self.q = q
        self.metric = metric
        self.mesh = mesh
        self.device = resolve_device(device)
        self.executor = executor                 # registry name (telemetry)
        self.tenant = str(tenant)                # obs label: per-tenant series
        # a PRIVATE executor instance: dispatch counters are scoped to this
        # service
        self._executor = make_executor(executor)
        self.use_kernel = use_kernel
        self.stats = {
            "requests": 0,
            "reducers": 0,
            "dense_padded_elements": 0,
            "bucketed_padded_elements": 0,
            "plan_cache_hits": 0,
            "fused_kernel": 0,
            "fused_streamed": 0,
            "fused_fallbacks": 0,
            "wall_s": 0.0,
        }

    def executor_stats(self) -> dict:
        """This service's private executor dispatch counters."""
        return self._executor.stats()

    def reset_stats(self) -> None:
        """Zero the accumulated telemetry coherently: ``self.stats`` and the
        private executor's counters reset together.  (The global
        ``PLAN_CACHE`` is shared and read as per-request deltas, so it is
        left untouched.)"""
        for k in self.stats:
            self.stats[k] = 0.0 if isinstance(self.stats[k], float) else 0
        self._executor.reset()

    def _snap(self):
        """Counter snapshot taken around one request (plan cache + this
        service's executor dispatch), so ``_info`` reports deltas."""
        from repro_torch.core import PLAN_CACHE
        ex = self._executor.stats()
        return {"plan_hits": PLAN_CACHE.hits,
                "fused_kernel": ex.get("kernel", 0),
                "fused_streamed": ex.get("streamed", 0),
                "fused_fallbacks": ex.get("fallbacks", 0),
                "ledger_seq": _LEDGER.seq}

    def _comm_info(self, snap: dict) -> Optional[dict]:
        """The comm-ledger reconciliation of the request bracketed by
        ``snap`` (the record labeled with this service's executor)."""
        recs = _LEDGER.records(since_seq=snap.get("ledger_seq", 0))
        mine = [r for r in recs if r.executor == self._executor.name]
        rec = mine[-1] if mine else (recs[-1] if recs else None)
        if rec is None:
            return None
        return {
            "measured_over_predicted": rec.measured_over_predicted,
            "measured_over_lb": rec.measured_over_lb,
            "gathered_bytes": rec.gathered_bytes,
            "predicted_bytes": rec.predicted_bytes,
            "assembled_bytes": rec.assembled_bytes,
            "local_bytes": rec.local_bytes,
            "residual_bytes": rec.residual_bytes,
            "replication": rec.replication,
            "anomaly": rec.anomaly,
        }

    def _info(self, plan, dt: float, snap: dict,
              workload: str = "pairs") -> dict:
        from repro_torch.mapreduce import jit_cache_stats
        after = self._snap()
        delta = {k: after[k] - snap[k] for k in snap}
        self.stats["requests"] += 1
        self.stats["reducers"] += plan.num_reducers
        self.stats["dense_padded_elements"] += plan.dense_padded_elements
        self.stats["bucketed_padded_elements"] += \
            plan.bucketed_padded_elements
        self.stats["plan_cache_hits"] += delta["plan_hits"]
        self.stats["fused_kernel"] += delta["fused_kernel"]
        self.stats["fused_streamed"] += delta["fused_streamed"]
        self.stats["fused_fallbacks"] += delta["fused_fallbacks"]
        self.stats["wall_s"] += dt
        fused_path = None
        if self.executor == "fused":
            fused_path = ("fallback" if delta["fused_fallbacks"]
                          else "kernel" if delta["fused_kernel"]
                          else "streamed")
        info = {
            "algorithm": plan.algorithm,
            "comm_cost": plan.comm_cost,
            "lower_bound": plan.lower_bound,
            "optimality_gap": plan.optimality_gap,
            "reducers": plan.num_reducers,
            "bucket_widths": plan.bucket_widths(),
            "dense_padded_elements": plan.dense_padded_elements,
            "bucketed_padded_elements": plan.bucketed_padded_elements,
            "padding_savings": plan.padding_savings,
            "executor": self.executor,
            "plan_cache_hit": delta["plan_hits"] > 0,
            "fused_path": fused_path,
            "jit_cache": jit_cache_stats(),
            "wall_s": dt,
        }
        comm = self._comm_info(snap)
        if comm is not None:
            info["comm"] = comm
        _OBS_REGISTRY.counter("serve.requests", executor=self.executor,
                              workload=workload, tenant=self.tenant).inc()
        _OBS_REGISTRY.histogram("serve.request_seconds",
                                executor=self.executor, workload=workload,
                                tenant=self.tenant).observe(dt)
        return info

    def similarity(self, x, weights=None):
        """All-pairs similarity for one query table.  Returns (sims, info);
        ``info["wall_s"]`` includes the device's work (synchronized)."""
        from repro_torch.mapreduce.allpairs import pairwise_similarity
        snap = self._snap()
        t0 = time.perf_counter()
        with _obs_span("request", workload="pairs",
                       executor=self.executor, tenant=self.tenant):
            sims, plan, _schema = pairwise_similarity(
                x, q=self.q, weights=weights, metric=self.metric,
                executor=self._executor, use_kernel=self.use_kernel,
                device=self.device)
            if sims.is_cuda:
                torch.cuda.synchronize(sims.device)
        return sims, self._info(plan, time.perf_counter() - t0, snap,
                                workload="pairs")

    @property
    def padding_savings(self) -> float:
        """Aggregate dense/bucketed padded-element ratio across requests."""
        return (self.stats["dense_padded_elements"] /
                max(self.stats["bucketed_padded_elements"], 1))
