"""``PairwiseService``: the paper-workload serving facade.

Port of ``repro.serve.engine.PairwiseService``: all-pairs ``similarity``,
``some_pairs``, rectangular ``x2y``, block serving (``load_block_table`` /
``block``) and a live table under edits (``load_table``, ``add_input``,
``remove_input``, ``update_weight``, ``flush_replan``).  Queries are
planned through the registry planner (all-pairs plans memoized by weight
profile in ``PLAN_CACHE``) and executed on a private executor instance, so
dispatch telemetry is scoped to the service.  Every response carries the
reference's ``info`` keys: plan provenance, plan-cache hit, the fused path
taken (``"kernel"`` on the card), the upload-cache counters and the
comm-ledger reconciliation.

With ``executor='streaming'`` the service serves a *live* table:
``load_table`` plans once through ``repro_torch.stream.IncrementalPlanner``
and cold-builds the pair matrix on the card; each edit repairs the
maintained schema locally and patches the matrix through the streaming
executor, reporting recompute-fraction, dirty-reducer and gap-drift
telemetry.  The live table is kept on the host, as in the reference, and
uploaded with each edit.

``BatchedServer`` is wave-based greedy decoding on top of
``LMModel.decode_step`` (port of the reference's): a wave admits up to B
requests; all slots decode in lock-step sharing the cache write position
(slot s's token at tick t lands at position t of its own cache lane), slots
whose request finishes early idle until the wave drains, and the next wave
starts with a fresh cache.  Steps run eagerly (the reference jits them).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.obs import LEDGER as _LEDGER
from repro_torch.obs import REGISTRY as _OBS_REGISTRY
from repro_torch.obs import span as _obs_span

__all__ = ["Request", "BatchedServer", "PairwiseService"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (P,) int32
    max_new_tokens: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class BatchedServer:
    """Greedy-decoding server over B lock-step slots (wave batching).

    ``device`` is where it runs (``None`` means CUDA and raises without a
    card); the model must already live there."""

    def __init__(self, model, batch_slots: int, max_len: int,
                 eos_id: Optional[int] = None, *, device=None):
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"the model lives on {model.device}, the "
                             f"server runs on {self.device}")
        self.model = model
        self.B = batch_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.queue: list[Request] = []
        self._wave: list[Optional[Request]] = []
        self._pending: list[list[int]] = []
        self._pos = 0
        self.cache = None

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _start_wave(self) -> bool:
        if not self.queue:
            return False
        self._wave = [None] * self.B
        self._pending = [[] for _ in range(self.B)]
        for s in range(self.B):
            if self.queue:
                req = self.queue.pop(0)
                self._wave[s] = req
                self._pending[s] = list(map(int, req.prompt))
        self.cache = self.model.init_cache(self.B, self.max_len)
        self._pos = 0
        return True

    def tick(self) -> int:
        """One lock-step decode; returns number of live requests."""
        live = [s for s, r in enumerate(self._wave)
                if r is not None and not r.done]
        if not live:
            if not self._start_wave():
                return 0
            live = [s for s, r in enumerate(self._wave) if r is not None]
        tokens = np.zeros((self.B, 1), np.int64)
        for s in live:
            if self._pending[s]:
                tokens[s, 0] = self._pending[s][0]
            elif self._wave[s].out:
                tokens[s, 0] = self._wave[s].out[-1]
        logits, self.cache = self.model.decode_step(
            self.cache, {"tokens": torch.from_numpy(tokens).to(self.device),
                         "pos": self._pos})
        nxt = torch.argmax(logits[:, -1, :], dim=-1).cpu().numpy()
        self._pos += 1
        for s in live:
            req = self._wave[s]
            if self._pending[s]:
                self._pending[s].pop(0)
                if not self._pending[s]:
                    req.out.append(int(nxt[s]))   # first generated token
            else:
                req.out.append(int(nxt[s]))
            hit_eos = (self.eos_id is not None and req.out
                       and req.out[-1] == self.eos_id)
            if (len(req.out) >= req.max_new_tokens or hit_eos or
                    self._pos >= self.max_len):
                req.done = True
        return len(live)

    def run(self, max_ticks: int = 100_000) -> None:
        for _ in range(max_ticks):
            if self.tick() == 0 and not self.queue:
                return


class PairwiseService:
    """Serve all-pairs / some-pairs similarity through planned schemas.

    Each query brings its own input table (and optionally per-input
    sizes); the service plans a mapping schema — repeated weight profiles
    hit ``repro_torch.core.PLAN_CACHE`` and skip planning — and executes it
    on a private instance of a registry executor ("dense" / "bucketed" /
    "fused" / "sharded" / "coded" / "streaming") on ``device`` (``None``
    means CUDA and raises without a card).  ``mesh`` is the
    ``torch.distributed`` process group the executors run over: the
    sharded and coded executors partition the plan over it (``None``: the
    default group if one is initialised, else one shard; their responses
    add ``info["sharded"]`` / ``info["coded"]``), the others split every
    bucket's reducer rows over its ranks (``None``: local).
    """

    def __init__(self, q: float, *, metric: str = "dot", mesh=None,
                 executor: str = "bucketed", max_buckets: int = 8,
                 use_kernel: bool = False, tenant: str = "default",
                 device=None):
        from repro_torch.mapreduce import make_executor
        self.q = q
        self.metric = metric
        self.mesh = mesh
        self.device = resolve_device(device)
        self.executor = executor                 # registry name (telemetry)
        self.tenant = str(tenant)                # obs label: per-tenant series
        # a PRIVATE executor instance: dispatch counters are scoped to this
        # service
        self._executor = make_executor(executor)
        self.max_buckets = max_buckets
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
            "edits": 0,
            "dirty_reducers": 0,
            "edit_reducers_total": 0,
            "stream_replans": 0,
            "stream_repacks": 0,
            "stream_swaps": 0,
            "block_requests": 0,
            "wall_s": 0.0,
        }
        self._planner = None                     # streaming: live planner
        self._table: Optional[np.ndarray] = None  # streaming: live rows
        self._block_table: Optional[torch.Tensor] = None  # block serving
        self._block_schema = None
        self._block_sparse = None

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
        ex_stats = self._executor.stats()
        if "num_shards" in ex_stats:             # sharded-executor telemetry
            info["sharded"] = {
                "num_shards": ex_stats["num_shards"],
                "balance_factor": ex_stats["balance_factor"],
                "fallbacks": ex_stats["fallbacks"],
            }
        if "replication" in ex_stats:            # coded-executor telemetry
            info["coded"] = {
                "replication": ex_stats["replication"],
                "local_fraction": ex_stats["local_fraction"],
                "residual_entries": ex_stats["residual_entries"],
            }
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
                mesh=self.mesh, executor=self._executor,
                use_kernel=self.use_kernel, device=self.device)
            if sims.is_cuda:
                torch.cuda.synchronize(sims.device)
        return sims, self._info(plan, time.perf_counter() - t0, snap,
                                workload="pairs")

    def some_pairs(self, x, pairs, weights=None):
        """Similarity restricted to an explicit required-pair set.  Returns
        (sims (m, m), info); the matrix is 0 off the required pairs."""
        from repro_torch.mapreduce.allpairs import some_pairs_similarity
        snap = self._snap()
        t0 = time.perf_counter()
        with _obs_span("request", workload="some_pairs",
                       executor=self.executor, tenant=self.tenant):
            sims, plan, _schema = some_pairs_similarity(
                x, pairs, q=self.q, weights=weights, metric=self.metric,
                mesh=self.mesh, executor=self._executor,
                use_kernel=self.use_kernel, device=self.device)
            if sims.is_cuda:
                torch.cuda.synchronize(sims.device)
        return sims, self._info(plan, time.perf_counter() - t0, snap,
                                workload="some_pairs")

    def x2y(self, x, y, wx=None, wy=None):
        """Cross similarity of an X table against a Y table through the
        Section-10 rectangular (X2Y) schema.  Returns (sims (mx, my),
        info) with the same provenance/telemetry contract as
        :meth:`similarity`; every executor serves it through ``run_x2y``.
        The X2Y plan is not memoized, as in the reference: each request
        plans."""
        from repro_torch.mapreduce.allpairs import x2y_similarity
        snap = self._snap()
        t0 = time.perf_counter()
        with _obs_span("request", workload="x2y",
                       executor=self.executor, tenant=self.tenant):
            sims, plan, _schema = x2y_similarity(
                x, y, q=self.q, wx=wx, wy=wy, metric=self.metric,
                mesh=self.mesh, executor=self._executor,
                use_kernel=self.use_kernel, device=self.device)
            if sims.is_cuda:
                torch.cuda.synchronize(sims.device)
        return sims, self._info(plan, time.perf_counter() - t0, snap,
                                workload="x2y")

    @property
    def padding_savings(self) -> float:
        """Aggregate dense/bucketed padded-element ratio across requests."""
        return (self.stats["dense_padded_elements"] /
                max(self.stats["bucketed_padded_elements"], 1))

    # --------------------------------------------------------- block serving
    def load_block_table(self, x, weights=None, *, c=None):
        """Adopt ``x`` for block-addressed serving (any executor).

        Plans a hierarchical schema (``plan_a2a_hierarchical``: the flat
        registry planner at small m, two-level super-input packing beyond)
        and lowers it to a CSR sparse plan — O(m + assignments) host
        state, never the (m, m) matrix — so the table can be orders of
        magnitude larger than ``similarity`` allows.  The table goes to
        the service's device once, as fp32.  Returns an info dict with the
        plan provenance, including the composed optimality-gap ledger
        (``hierarchy``) when the two-level path ran.  Serve blocks with
        :meth:`block`."""
        from repro_torch.core import plan_a2a_hierarchical
        from repro_torch.mapreduce.allpairs import _sparse_plan_for
        t0 = time.perf_counter()
        self._block_table = torch.as_tensor(x, dtype=torch.float32,
                                            device=self.device)
        m = self._block_table.shape[0]
        w = np.full(m, 1.0) if weights is None \
            else np.asarray(weights, dtype=np.float64)
        self._block_schema = plan_a2a_hierarchical(w, self.q, c=c)
        self._block_sparse = _sparse_plan_for(self._block_schema)
        dt = time.perf_counter() - t0
        self.stats["wall_s"] += dt
        sp = self._block_sparse
        return {
            "executor": self.executor,
            "algorithm": sp.algorithm,
            "m": m,
            "reducers": sp.num_reducers,
            "bins": sp.num_bins,
            "host_entries": sp.host_entries,
            "comm_cost": sp.comm_cost,
            "lower_bound": sp.lower_bound,
            "optimality_gap": sp.optimality_gap,
            "hierarchy": self._block_schema.meta.get("hierarchy"),
            "wall_s": dt,
        }

    def block(self, i0: int, i1: int, j0: int, j1: int):
        """Serve one ``[i0:i1) x [j0:j1)`` sub-block of the pair matrix
        through this service's executor (``Executor.run_block``) — only
        the reducers covering the block run, nothing O(m^2) is built.
        Returns ``(block, info)``; ``info["wall_s"]`` includes the
        device's work (synchronized)."""
        from repro_torch.mapreduce.allpairs import _block_fn_x2y
        if self._block_table is None:
            raise RuntimeError("call load_block_table() first")
        t0 = time.perf_counter()
        with _obs_span("request", workload="block",
                       executor=self.executor, tenant=self.tenant):
            blk = self._executor.run_block(
                self._block_table, self._block_sparse,
                _block_fn_x2y(self.metric), int(i0), int(i1), int(j0),
                int(j1), mesh=self.mesh, use_kernel=self.use_kernel,
                device=self.device)
            if blk.is_cuda:
                torch.cuda.synchronize(blk.device)
        dt = time.perf_counter() - t0
        self.stats["block_requests"] += 1
        self.stats["wall_s"] += dt
        _OBS_REGISTRY.counter(
            "serve.requests", executor=self.executor, workload="block",
            tenant=self.tenant).inc()
        _OBS_REGISTRY.histogram(
            "serve.block_seconds", executor=self.executor,
            tenant=self.tenant).observe(dt)
        return blk, {
            "executor": self.executor,
            "block": (int(i0), int(i1), int(j0), int(j1)),
            "block_calls": self._executor.stats().get("block_calls", 0),
            "wall_s": dt,
        }

    # ------------------------------------------------------------- streaming
    def _reducer_fn(self):
        """The memoized reducer: the streaming executor matches its state
        to the reducer by identity."""
        from repro_torch.mapreduce.allpairs import _block_fn
        return _block_fn(self.metric, self.use_kernel)

    def _require_streaming(self):
        from repro_torch.stream import StreamingExecutor
        assert isinstance(self._executor, StreamingExecutor), (
            f"live-table edits need executor='streaming' "
            f"(this service runs {self.executor!r})")
        return self._executor

    def load_table(self, x, weights=None, *, replan_drift: float = 1.5,
                   max_gap: Optional[float] = 2.0,
                   repack_gap: Optional[float] = None,
                   background: bool = False, warmup: bool = True):
        """Adopt ``x`` as the live table (streaming executor only).

        Plans the initial schema through ``repro_torch.stream.
        IncrementalPlanner``, cold-builds the pair matrix on the fused
        substrate, runs the bounded delta-shape set once (``warmup=True``:
        the first edit then builds and loads nothing new), and returns
        ``(sims, info)``.  Subsequent ``add_input`` / ``remove_input`` /
        ``update_weight`` calls edit this table in place; ``max_gap`` /
        ``repack_gap`` / ``background`` tune the planner's re-plan
        ceiling, soft repack threshold, and double-buffered re-plan (see
        ``repro_torch.stream.StreamPlannerBase``)."""
        from repro_torch.mapreduce.allpairs import _mesh_pad
        from repro_torch.stream import IncrementalPlanner
        ex = self._require_streaming()
        self._table = np.asarray(x, dtype=np.float32)
        m = self._table.shape[0]
        w = np.full(m, 1.0) if weights is None \
            else np.asarray(weights, dtype=np.float64)
        t0 = time.perf_counter()
        self._planner = IncrementalPlanner(
            self.q, w, replan_drift=replan_drift, max_gap=max_gap,
            repack_gap=repack_gap, background=background,
            max_buckets=self.max_buckets,
            # a group splits every bucket's rows over its ranks: pad
            # reducer rows (full plan and delta sub-plans) to its size,
            # exactly like allpairs._plan_for
            pad_reducers_to=_mesh_pad(self.mesh))
        plan = self._planner.plan()
        xt = torch.as_tensor(self._table, device=self.device)
        with _obs_span("request", workload="load_table",
                       executor=self.executor, tenant=self.tenant):
            sims = ex.run_pairs(xt, plan, self._reducer_fn(), m,
                                mesh=self.mesh, use_kernel=self.use_kernel,
                                device=self.device)
            if sims.is_cuda:
                torch.cuda.synchronize(sims.device)
        warmed = 0
        if warmup:
            warmed = ex.warm_delta_shapes(
                xt, self._planner.delta_shapes(), self._reducer_fn(),
                mesh=self.mesh, device=self.device)
        dt = time.perf_counter() - t0
        self.stats["requests"] += 1
        self.stats["reducers"] += plan.num_reducers
        self.stats["wall_s"] += dt
        info = {
            "executor": self.executor,
            "algorithm": self._planner.algorithm,
            "reducers": plan.num_reducers,
            "comm_cost": self._planner.comm_cost,
            "lower_bound": self._planner.lower_bound,
            "optimality_gap": self._planner.optimality_gap,
            "achievable_gap": self._planner.achievable_gap,
            "warmed_shapes": warmed,
            "wall_s": dt,
        }
        return sims, info

    def flush_replan(self) -> bool:
        """Block until any in-flight background re-plan lands (planning
        state only — served pair values are plan-independent).  Returns
        True if a fresh schema was adopted."""
        assert self._planner is not None, "call load_table() first"
        return self._planner.flush_replan()

    def _edit(self, op: str, *args):
        ex = self._require_streaming()
        assert self._planner is not None, "call load_table() first"
        before = dict(self._planner.stats)
        ledger_seq = _LEDGER.seq
        t0 = time.perf_counter()
        with _obs_span("edit", kind=op, executor=self.executor,
                       tenant=self.tenant):
            delta = getattr(self._planner, op)(*args)
            sims = ex.apply_delta(
                self._table, delta, self._reducer_fn(),
                self._table.shape[0], plan_provider=self._planner.plan,
                mesh=self.mesh, use_kernel=self.use_kernel,
                device=self.device)
            if sims.is_cuda:
                torch.cuda.synchronize(sims.device)
        dt = time.perf_counter() - t0
        pstats = self._planner.stats
        self.stats["edits"] += 1
        self.stats["dirty_reducers"] += int(len(delta.dirty_rows))
        self.stats["edit_reducers_total"] += int(delta.num_reducers)
        self.stats["stream_replans"] += \
            pstats["replans"] - before["replans"]
        self.stats["stream_repacks"] += \
            pstats["repacks"] - before["repacks"]
        self.stats["stream_swaps"] += pstats["swaps"] - before["swaps"]
        self.stats["wall_s"] += dt
        info = {
            "executor": self.executor,
            "kind": delta.kind,
            "input_id": int(delta.input_id),
            "dirty_reducers": int(len(delta.dirty_rows)),
            "num_reducers": int(delta.num_reducers),
            "recompute_fraction": float(delta.recompute_fraction),
            "full_replan": bool(delta.full_replan),
            "replan": bool(delta.meta.get("replan", False)),
            "replan_pending": bool(delta.meta.get("replan_pending",
                                                  False)),
            "swap": bool(delta.meta.get("swap", False)),
            "repack": pstats["repacks"] > before["repacks"],
            "comm_cost": float(delta.comm_cost),
            "delta_comm_rows": float(delta.delta_comm_rows()),
            "lower_bound": float(delta.lower_bound),
            "optimality_gap": delta.optimality_gap,
            "achievable_gap": float(self._planner.achievable_gap),
            "gap_drift": float(delta.gap_drift),
            "algorithm": self._planner.algorithm,
            "wall_s": dt,
        }
        comm = self._comm_info({"ledger_seq": ledger_seq})
        if comm is not None:
            info["comm"] = comm
        _OBS_REGISTRY.counter(
            "serve.edits", executor=self.executor, kind=op,
            tenant=self.tenant).inc()
        _OBS_REGISTRY.histogram(
            "serve.edit_seconds", executor=self.executor, kind=op,
            tenant=self.tenant).observe(dt)
        return sims, info

    def add_input(self, row, weight: float = 1.0):
        """Append one feature row to the live table.  Returns
        ``(sims, info)``: the patched matrix (new input's row/column
        filled) and the edit's delta telemetry."""
        from repro_torch.core.schema import InfeasibleError
        row = np.asarray(row, dtype=np.float32).reshape(1, -1)
        assert self._table is not None, "call load_table() first"
        assert row.shape[1] == self._table.shape[1], (
            row.shape, self._table.shape)
        self._table = np.concatenate([self._table, row])
        try:
            return self._edit("insert", float(weight))
        except InfeasibleError:
            # the planner rolled its insert back too — pop the row so the
            # table and the maintained schema stay in lockstep (any other
            # exception leaves the committed input in both)
            self._table = self._table[:-1]
            raise

    def remove_input(self, i: int):
        """Tombstone input ``i``: its row/column of the served matrix is
        zeroed; no reducer recomputes (surviving pair values are
        unchanged)."""
        return self._edit("delete", int(i))

    def update_weight(self, i: int, weight: float):
        """Change input ``i``'s planning size.  Feature rows are untouched
        so the matrix never changes — only the maintained schema (bin
        moves, possibly a gap-drift re-plan) and its telemetry do."""
        return self._edit("reweight", int(i), float(weight))
