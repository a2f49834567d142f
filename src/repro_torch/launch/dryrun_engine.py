"""Dry run of the paper's own workload on the card: the A2A all-pairs engine,
planner schema vs naive replication (port of
``repro.launch.dryrun_engine``).

The reference lowers each executor's program on a 16x16 device mesh and
reads FLOPs, HBM bytes and collective bytes from the compiled XLA text.
Eager PyTorch has no program to lower, so each stage here RUNS the
executor over the caller's process group (one warm run, then one measured
run) and fills the same record:

* fields the reference takes from the plan (``reducers``, ``slots``,
  ``padded_elements``, ``schema_comm_cost_rows``, ``bucket_widths``,
  ``padding_savings``, ``fused_model``, the schema byte scales, the
  partition report, the streaming delta's planner fields, the coded
  model frontier) keep the reference's values;
* fields the reference reads from the HLO (``flops_per_device``,
  ``hbm_bytes_per_device``, ``t_*``, ``delta_hbm_bytes``,
  ``full_hbm_bytes``, ``per_shard_hbm_bytes``) come from the work models
  of ``repro_torch.launch.roofline`` on the row blocks this rank launches,
  and the collective bytes (``collective_bytes_per_device``,
  ``measured_assembly_bytes_per_shard``) from the obs counters over the
  measured run;
* on the card every record adds ``device_ms`` (CUDA events around the
  measured run) and ``peak_alloc_bytes`` (the allocator's peak above what
  was allocated when the run began, after
  ``torch.cuda.reset_peak_memory_stats``); both are ``None`` on the CPU.
  ``measured_by`` says, field by field, ``model`` or ``counter``.

Tables are bf16 (the reference lowers with ``dtype=jnp.bfloat16``), made
on the device from seed 0.  Each stage runs inside an obs span (``_traced``)
so a dry run exports a per-stage Chrome trace beside its JSON.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun_engine \\
        [--m 1024] [--d 2048] [--q 32] [--zipf] [--device cpu] [--out F]

``main`` runs every stage on a process group of one rank (the default
group when one is initialised) and writes only to ``--out`` (default
``build/dryrun/engine_a2a.json``), never to ``benchmarks/results/dryrun/``.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import functools
import json
import os
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import compat
from repro_torch._device import resolve_device
from repro_torch.core import naive_pairs, plan_a2a
from repro_torch.kernels.pairwise.fused_gather_gram import (
    fused_traffic_model,
    gather_bytes,
)
from repro_torch.launch.roofline import (
    H100_SXM,
    HW,
    Stats,
    collective_bytes_since,
    collective_snapshot,
    gathered_work,
    work_model,
)
from repro_torch.mapreduce.allpairs import _block_fn
from repro_torch.mapreduce.engine import ReducerBucket, build_plan, rank_rows
from repro_torch.mapreduce.executors import choose_replication, make_executor
from repro_torch.obs import span as _obs_span

__all__ = ["analyze", "analyze_bucketed", "analyze_fused",
           "analyze_streaming", "analyze_sharded", "analyze_coded",
           "profile", "engine_rows", "report_lines", "main"]

REPO = Path(__file__).resolve().parents[3]
DEFAULT_OUT = REPO / "build" / "dryrun" / "engine_a2a.json"
# the reference's sweep artifacts: a directory there makes
# tests/test_deliverables.py want every arch x shape cell
FORBIDDEN_OUT = REPO / "benchmarks" / "results" / "dryrun"

# the measured record's fields and where each comes from
_MEASURED_BY = {
    "flops_per_device": "model", "hbm_bytes_per_device": "model",
    "collective_bytes_per_device": "counter", "t_compute": "model",
    "t_memory": "model", "t_collective": "counter", "device_ms": "counter",
    "peak_alloc_bytes": "counter"}


def _traced(fn):
    """Wrap an ``analyze_*`` stage in an obs span so a dry run exports a
    per-stage Chrome trace alongside its JSON report."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with _obs_span(fn.__name__, stage="dryrun"):
            return fn(*args, **kwargs)
    return wrapper


def _table(m: int, d: int, device, dtype=torch.bfloat16) -> torch.Tensor:
    """The ``(m, d)`` table, made on ``device`` from seed 0 (the same on
    every rank)."""
    gen = torch.Generator(device=device).manual_seed(0)
    return torch.randn((m, d), generator=gen, device=device,
                       dtype=torch.float32).to(dtype)


def _measure(fn, device, num_ranks: int) -> dict:
    """Run ``fn`` once warm, then once measured: CUDA-event ms and the
    allocator's peak above the run's start on a card (``None`` on the
    CPU), and the collectives' moved bytes from the obs counters."""
    fn()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    snap = collective_snapshot()
    fn()
    coll = collective_bytes_since(snap, num_ranks)
    device_ms = peak = None
    if cuda:
        end.record()
        end.synchronize()
        device_ms = start.elapsed_time(end)
        peak = torch.cuda.max_memory_allocated(device) - base
    return {"device_ms": device_ms, "peak_alloc_bytes": peak,
            "collective": coll}


def _rank_buckets(buckets, S: int, rank: int) -> list:
    """This rank's row block of every bucket (what it launches)."""
    out = []
    for b in buckets:
        r = rank_rows(b.R, S, rank)
        out.append(ReducerBucket(
            width=b.width, rows=b.rows[r], idx=b.idx[r], mask=b.mask[r],
            ywidth=b.ywidth,
            yidx=None if b.yidx is None else b.yidx[r],
            ymask=None if b.ymask is None else b.ymask[r]))
    return out


def _dense_bucket(plan) -> ReducerBucket:
    """The dense plan as one bucket of its global width."""
    return ReducerBucket(width=plan.L, rows=np.arange(plan.R),
                         idx=plan.idx, mask=plan.mask)


def _stats(work: dict, meas: dict) -> Stats:
    coll = meas["collective"]
    return Stats(flops=float(work["ops"]), hbm_bytes=float(work["bytes"]),
                 collective_bytes=coll["total"],
                 collective_ops=coll["ops"],
                 collective_by_kind={k: coll[k] for k in
                                     ("all-gather", "all-to-all")})


def _stats_rec(plan, name, stats, padded_elements, meas, hw: HW,
               extra=None):
    rec = {
        "name": name,
        "reducers": plan.num_reducers,
        "slots": int(plan.mask.sum()),
        "padded_elements": int(padded_elements),
        "schema_comm_cost_rows": float(plan.comm_cost),
        "flops_per_device": stats.flops,
        "hbm_bytes_per_device": stats.hbm_bytes,
        "collective_bytes_per_device": stats.collective_bytes,
        "t_compute": stats.flops / hw.peak_flops,
        "t_memory": stats.hbm_bytes / hw.hbm_bw,
        "t_collective": stats.collective_bytes / hw.link_bw,
        "device_ms": meas["device_ms"],
        "peak_alloc_bytes": meas["peak_alloc_bytes"],
        "collective_tensor_bytes": meas["collective"]["tensor_bytes"],
        "hw": hw.name,
        "measured_by": dict(_MEASURED_BY),
    }
    if extra:
        rec.update(extra)
    return rec


def _setup(m, d, mesh, device, hw):
    """``(device, S, rank, table, hw)`` of a stage that splits reducer
    rows over ``mesh``."""
    device = resolve_device(device)
    _group, S, rank = compat.reducer_group(mesh)
    return device, S, rank, _table(m, d, device), \
        (hw or HW.for_device(device))


@_traced
def analyze(plan, m, d, mesh, name, *, device=None, hw: Optional[HW] = None):
    """Dense path: one gather padded to the global max slot count, this
    rank's rows of it (the reference's one dense program)."""
    device, S, rank, x, hw = _setup(m, d, mesh, device, hw)
    fn = _block_fn("dot", False)
    ex = make_executor("dense")
    meas = _measure(lambda: ex.run(x, plan, fn, mesh=mesh, device=device),
                    device, S)
    isz = x.element_size()
    work = gathered_work(_rank_buckets([_dense_bucket(plan)], S, rank), m,
                         d, isz, out_itemsize=isz)
    return _stats_rec(plan, name, _stats(work, meas),
                      plan.dense_padded_elements, meas, hw)


@_traced
def analyze_bucketed(plan, m, d, mesh, name, *, device=None,
                     hw: Optional[HW] = None):
    """Bucketed path: one gather + product per capacity bucket; terms are
    summed over the buckets (they run back to back)."""
    device, S, rank, x, hw = _setup(m, d, mesh, device, hw)
    fn = _block_fn("dot", False)
    ex = make_executor("bucketed")
    meas = _measure(lambda: ex.run(x, plan, fn, mesh=mesh,
                                   combine="buckets", device=device),
                    device, S)
    isz = x.element_size()
    mine = _rank_buckets(plan.buckets, S, rank)
    work = gathered_work(mine, m, d, isz, out_itemsize=isz)
    return _stats_rec(
        plan, name, _stats(work, meas), plan.bucketed_padded_elements, meas,
        hw, extra={"bucket_widths": plan.bucket_widths(),
                   "padding_savings": float(plan.padding_savings),
                   "gathered_bytes_max_bucket": max(
                       (b.R * b.width * d * isz for b in mine), default=0)})


@_traced
def analyze_fused(plan, m, d, mesh, name, bucketed_rec=None, *,
                  device=None, hw: Optional[HW] = None):
    """Fused path: one ``fused_gather_gram`` launch per capacity bucket on
    this rank's rows, the gathered block never written out.  Reports the
    HBM bytes it saves over the bucketed executor (models) and, on the
    card, the peak allocation it saves, next to the schema's communication
    cost and lower bound.  ``fused_model`` is the reference's model of its
    TPU kernel; ``gather_bytes`` the table bytes this port's kernel
    stages."""
    device, S, rank, x, hw = _setup(m, d, mesh, device, hw)
    ex = make_executor("fused")
    meas = _measure(lambda: ex.run(x, plan, _block_fn("dot", False),
                                   mesh=mesh, combine="buckets",
                                   device=device), device, S)
    itemsize = x.element_size()                      # bf16 table rows
    mine = _rank_buckets(plan.buckets, S, rank)
    stats = _stats(work_model(mine, m, d, itemsize), meas)
    extra = {
        "bucket_widths": plan.bucket_widths(),
        "padding_savings": float(plan.padding_savings),
        "fused_model": fused_traffic_model(plan.buckets, d, itemsize),
        "gather_bytes": sum(gather_bytes(b.mask, d, itemsize)
                            for b in mine),
        # schema-level shuffle volume for scale: shipped rows x row bytes
        "schema_comm_bytes": float(plan.comm_cost) * d * itemsize,
        "schema_lower_bound_bytes": (
            float(plan.lower_bound) * d * itemsize
            if plan.lower_bound else None),
    }
    if bucketed_rec is not None:
        saved = bucketed_rec["hbm_bytes_per_device"] - stats.hbm_bytes
        extra["saved_hbm_bytes_per_device_vs_bucketed"] = saved
        extra["saved_hbm_vs_schema_comm"] = (
            saved * S / max(extra["schema_comm_bytes"], 1))
        if meas["peak_alloc_bytes"] is not None:
            extra["saved_peak_alloc_bytes_vs_bucketed"] = (
                bucketed_rec["peak_alloc_bytes"] - meas["peak_alloc_bytes"])
    rec = _stats_rec(plan, name, stats, plan.bucketed_padded_elements, meas,
                     hw, extra=extra)
    rec["measured_by"]["saved_hbm_bytes_per_device_vs_bucketed"] = "model"
    return rec


@_traced
def analyze_streaming(w, q, m, d, name, *, device=None,
                      hw: Optional[HW] = None):
    """Streaming path: what one single-input edit executes.

    Builds an ``IncrementalPlanner`` on the profile, applies one insert,
    and runs what each side would execute (locally, as the reference
    lowers on one host): the bucketed gather + product over the delta's
    dirty-reducer sub-plan vs over the full post-edit plan.  Reports their
    modelled HBM bytes and, on the card, their times, next to the
    schema-level ledger: delta comm bytes (dirty reducers' shipped rows),
    full re-plan comm bytes, and the instance's lower bound — the static
    planner pays the middle number on every edit, the streaming planner
    the first."""
    from repro_torch.stream import IncrementalPlanner

    device = resolve_device(device)
    hw = hw or HW.for_device(device)
    ip = IncrementalPlanner(q, w, check=False)
    delta = ip.insert(float(np.median(w)))
    plan = ip.plan()
    target = (delta.sub_plan if delta.sub_plan is not None
              and not delta.full_replan else plan)
    x = _table(m + 1, d, device)
    itemsize = x.element_size()                      # bf16 table rows
    ex = make_executor("bucketed")
    fn = _block_fn("dot", False)

    def run(p):
        meas = _measure(lambda: ex.run(x, p, fn, combine="buckets",
                                       device=device), device, 1)
        work = gathered_work(p.buckets, m + 1, d, itemsize,
                             out_itemsize=itemsize)
        return work, meas
    delta_work, delta_meas = run(target)
    full_work, full_meas = run(plan)
    lb = float(delta.lower_bound)
    rec = {
        "name": name,
        "edit": delta.kind,
        "reducers": int(delta.num_reducers),
        "dirty_reducers": int(len(delta.dirty_rows)),
        "recompute_fraction": float(delta.recompute_fraction),
        "gap_drift": float(delta.gap_drift),
        "delta_hbm_bytes": float(delta_work["bytes"]),
        "full_hbm_bytes": float(full_work["bytes"]),
        "delta_comm_bytes": float(delta.delta_comm_rows()) * d * itemsize,
        "replan_comm_bytes": float(delta.comm_cost) * d * itemsize,
        "schema_lower_bound_bytes": lb * d * itemsize,
        "device_ms": delta_meas["device_ms"],
        "peak_alloc_bytes": delta_meas["peak_alloc_bytes"],
        "full_device_ms": full_meas["device_ms"],
        "full_peak_alloc_bytes": full_meas["peak_alloc_bytes"],
        "hw": hw.name,
        "measured_by": {"delta_hbm_bytes": "model",
                        "full_hbm_bytes": "model", "device_ms": "counter",
                        "peak_alloc_bytes": "counter",
                        "full_device_ms": "counter",
                        "full_peak_alloc_bytes": "counter"},
    }
    rec["delta_vs_replan_bytes"] = (
        rec["delta_comm_bytes"] / max(rec["replan_comm_bytes"], 1e-12))
    return rec


def _group_buckets(groups, rank: int) -> list:
    """This rank's slice of stacked shard groups as buckets (square
    groups ``(idx, mask, rows)``, rect ``(xi, xm, yi, ym, rows)``)."""
    out = []
    for g in groups:
        idx, mask = g[0][rank], g[1][rank]
        kw = {}
        if len(g) >= 5:
            kw = dict(ywidth=g[2].shape[2], yidx=g[2][rank],
                      ymask=g[3][rank])
        out.append(ReducerBucket(width=idx.shape[1], rows=g[-1][rank],
                                 idx=idx, mask=mask, **kw))
    return out


@_traced
def analyze_sharded(plan, m, d, mesh, name, *, device=None,
                    hw: Optional[HW] = None):
    """Sharded path: reducers LPT-balanced over the group, each rank's
    fused kernel over its own stacked groups, then the ONE cross-rank
    all-gather that assembles the (m, m) matrix.  Reports this rank's
    modelled HBM bytes next to the schema lower bound's per-shard share
    (``lower_bound * d * itemsize / S``), and the all-gather's bytes from
    the counters."""
    device = resolve_device(device)
    hw = hw or HW.for_device(device)
    ex = make_executor("sharded")
    _group, S, rank = compat.shard_group(mesh)
    part = ex.partition(plan, S)
    x = _table(m, d, device)
    meas = _measure(lambda: ex.run_pairs(x, plan, _block_fn("dot", False),
                                         m, mesh=mesh, device=device),
                    device, S)
    itemsize = x.element_size()                      # bf16 table rows
    mine = _group_buckets(ex._groups_for(plan, part), rank)
    stats = _stats(work_model(mine, m, d, itemsize), meas)
    lb_rows = float(plan.lower_bound) if plan.lower_bound else None
    rep = part.report()
    extra = {
        "num_shards": S,
        "balance_factor": rep["balance_factor"],
        "shipped_rows_per_shard_max": int(max(rep["shipped_rows"])),
        "shipped_rows_per_shard_mean": float(np.mean(rep["shipped_rows"])),
        "padded_elements_per_shard_max": int(
            max(rep["padded_elements_per_shard"])),
        # per-shard modelled bytes vs the schema lower bound's share
        "per_shard_hbm_bytes": stats.hbm_bytes,
        "schema_lb_bytes_per_shard": (
            lb_rows * d * itemsize / S if lb_rows else None),
        "per_shard_hbm_vs_lb": (
            stats.hbm_bytes / (lb_rows * d * itemsize / S)
            if lb_rows else None),
    }
    rec = _stats_rec(plan, name, stats, plan.bucketed_padded_elements, meas,
                     hw, extra=extra)
    rec["measured_by"]["per_shard_hbm_bytes"] = "model"
    return rec


@_traced
def analyze_coded(plan, m, d, name, mesh=None, *, device=None,
                  hw: Optional[HW] = None):
    """Coded path: the replication x communication sweep over the group.

    Runs the coded executor at every replication rate ``r`` of the model
    frontier (``choose_replication``) and emits the Pareto frontier:
    the measured per-shard assembly bytes (the all-to-all's, from the
    counters, in the reference's ring accounting) fall with r while the
    input-shipping term ``r x comm_cost`` rises, and every point's total
    stays above the lower bound.  The model frontier keeps the reference's
    bf16 row bytes (``itemsize`` 2); the exchange moves fp32 Gram entries,
    so each point adds ``model_assembly_bytes_per_shard_fp32``, the same
    model at 4 bytes, which the measured bytes equal."""
    device = resolve_device(device)
    hw = hw or HW.for_device(device)
    _group, S, rank = compat.shard_group(mesh)
    itemsize = 2                                     # bf16 table rows
    lb_rows = float(plan.lower_bound) if plan.lower_bound else None
    lb_bytes = lb_rows * d * itemsize if lb_rows else None
    shipped_bytes = float(plan.comm_cost) * d * itemsize
    best_r, model_frontier = choose_replication(
        plan, S, m, d, itemsize=itemsize)
    x = _table(m, d, device)
    frac = (S - 1) / S if S > 1 else 0.0
    frontier = []
    for rec in model_frontier:
        r = rec["replication"]
        ex = make_executor("coded", replication=r)
        meas = _measure(lambda: ex.run_pairs(
            x, plan, _block_fn("dot", False), m, mesh=mesh, device=device),
            device, S)
        measured = meas["collective"]["all-to-all"]
        frontier.append({
            "replication": r,
            "measured_assembly_bytes_per_shard": measured,
            "model_assembly_bytes_per_shard":
                rec["assembly_bytes_per_shard"],
            "model_assembly_bytes_per_shard_fp32": int(
                S * rec["lane_max"] * 4 * frac),
            "local_fraction": rec["local_fraction"],
            "shipped_bytes": rec["shipped_bytes"],
            "total_comm_bytes": rec["shipped_bytes"] + S * measured,
            "ge_lower_bound": (
                rec["shipped_bytes"] + S * measured >= lb_bytes
                if lb_bytes else None),
            "device_ms": meas["device_ms"],
            "peak_alloc_bytes": meas["peak_alloc_bytes"],
            "measured_by": {"measured_assembly_bytes_per_shard": "counter",
                            "model_assembly_bytes_per_shard": "model",
                            "device_ms": "counter",
                            "peak_alloc_bytes": "counter"},
        })
    times = [p["device_ms"] for p in frontier]
    return {
        "name": name,
        "reducers": plan.num_reducers,
        "num_shards": S,
        "rank": rank,
        "best_replication": best_r,
        "schema_comm_bytes": shipped_bytes,
        "schema_lower_bound_bytes": lb_bytes,
        "pareto_frontier": frontier,
        "device_ms": None if None in times else sum(times),
        "peak_alloc_bytes": (None if times[0] is None else
                             max(p["peak_alloc_bytes"] for p in frontier)),
        "hw": hw.name,
    }


def profile(m: int, q: float, zipf: bool) -> np.ndarray:
    """The reference's input sizes: Zipf a=1.6 / 16 clipped to
    [0.05, 0.45 q] from seed 0, or all 1."""
    if zipf:
        rng = np.random.default_rng(0)
        return np.clip(rng.zipf(1.6, m) / 16.0, 0.05, q * 0.45)
    return np.ones(m)


def engine_rows(w, q, m, d, mesh, *, device=None, hw=None) -> tuple:
    """The planner's dense, bucketed, fused and sharded rows and the naive
    all-pairs row over ``mesh`` (plans padded to its size), each with its
    ratios to the naive row, as the reference's ``main`` builds them.
    Returns ``(rows, schema, plan_opt, plan_nv)``."""
    S = compat.shard_group(mesh)[1]
    schema = plan_a2a(w, q)
    plan_opt = build_plan(schema, pad_reducers_to=S)
    plan_nv = build_plan(naive_pairs(w, q), pad_reducers_to=S)
    kw = dict(device=device, hw=hw)
    bucketed_rec = analyze_bucketed(plan_opt, m, d, mesh,
                                    f"planner-bucketed[{schema.algorithm}]",
                                    **kw)
    rows = [
        analyze(plan_opt, m, d, mesh, f"planner[{schema.algorithm}]", **kw),
        bucketed_rec,
        analyze_fused(plan_opt, m, d, mesh,
                      f"planner-fused[{schema.algorithm}]",
                      bucketed_rec=bucketed_rec, **kw),
        analyze_sharded(plan_opt, m, d, mesh,
                        f"planner-sharded[{schema.algorithm}]", **kw),
        analyze(plan_nv, m, d, mesh, "naive-all-pairs", **kw),
    ]
    base = rows[-1]
    for r in rows:
        r["shuffle_bytes_vs_naive"] = (
            r["hbm_bytes_per_device"] / max(base["hbm_bytes_per_device"], 1))
        r["comm_cost_vs_naive"] = (
            r["schema_comm_cost_rows"] / base["schema_comm_cost_rows"])
    return rows, schema, plan_opt, plan_nv


def _ms(v) -> str:
    return "n/a" if v is None else f"{v:.3f}"


def _mb(v) -> str:
    return "n/a" if v is None else f"{v / 1e6:.1f}"


def report_lines(rows) -> list:
    """The reference's printed lines for every row, each with its device
    ms and peak allocation (MB) added."""
    out = []
    for r in rows:
        if "pareto_frontier" in r:
            out.append(
                f"{r['name']:40s} shards={r['num_shards']} "
                f"knee r={r['best_replication']} "
                f"(LB {(r['schema_lower_bound_bytes'] or 0)/1e6:.2f} MB)")
            for p in r["pareto_frontier"]:
                out.append(
                    f"{'':40s} r={p['replication']:2d} assembly "
                    f"{p['measured_assembly_bytes_per_shard']/1e6:.2f} "
                    f"MB/shard, shipped {p['shipped_bytes']/1e6:.2f} MB, "
                    f"total {p['total_comm_bytes']/1e6:.2f} MB "
                    f">=LB:{p['ge_lower_bound']} device_ms="
                    f"{_ms(p['device_ms'])} peak_alloc_MB="
                    f"{_mb(p['peak_alloc_bytes'])}")
            continue
        if "dirty_reducers" in r:
            out.append(
                f"{r['name']:40s} dirty={r['dirty_reducers']:5d}"
                f"/{r['reducers']:8d} "
                f"(recompute {r['recompute_fraction']:.3f}) "
                f"delta model {r['delta_hbm_bytes']/1e6:.1f} MB vs full "
                f"{r['full_hbm_bytes']/1e6:.1f} MB device_ms="
                f"{_ms(r['device_ms'])} (full {_ms(r['full_device_ms'])}) "
                f"peak_alloc_MB={_mb(r['peak_alloc_bytes'])}")
            out.append(
                f"{'':40s} delta comm {r['delta_comm_bytes']/1e6:.2f} MB vs "
                f"re-plan {r['replan_comm_bytes']/1e6:.2f} MB "
                f"({r['delta_vs_replan_bytes']:.3f}x) vs lower bound "
                f"{r['schema_lower_bound_bytes']/1e6:.2f} MB")
            continue
        out.append(
            f"{r['name']:40s} reducers={r['reducers']:8d} "
            f"gather_rows={r['slots']:9d} "
            f"padded={r['padded_elements']:10d} "
            f"t_m={r['t_memory']:.4f}s t_x={r['t_collective']:.4f}s "
            f"bytes_vs_naive={r['shuffle_bytes_vs_naive']:.3f} "
            f"(schema comm ratio {r['comm_cost_vs_naive']:.3f}) "
            f"device_ms={_ms(r['device_ms'])} "
            f"peak_alloc_MB={_mb(r['peak_alloc_bytes'])}")
        if "saved_hbm_bytes_per_device_vs_bucketed" in r:
            mdl = r["fused_model"]
            out.append(
                f"{'':40s} fused saves "
                f"{r['saved_hbm_bytes_per_device_vs_bucketed']/1e6:.1f} "
                f"MB/device HBM vs bucketed "
                f"({r['saved_hbm_vs_schema_comm']:.2f}x the schema's "
                f"comm volume of {r['schema_comm_bytes']/1e6:.1f} MB; "
                f"kernel model: {mdl['saved_bytes']/1e6:.1f} MB global "
                f"gather round-trip removed)")
        if "num_shards" in r:
            lb = r["schema_lb_bytes_per_shard"]
            out.append(
                f"{'':40s} sharded over {r['num_shards']} shards: "
                f"LPT balance {r['balance_factor']:.3f}, "
                f"per-shard model {r['per_shard_hbm_bytes']/1e6:.1f} MB vs "
                f"lower-bound share {(lb or 0)/1e6:.1f} MB"
                + (f" ({r['per_shard_hbm_vs_lb']:.2f}x)" if lb else ""))
    return out


@contextlib.contextmanager
def _one_rank_group(device):
    """The default group if one is initialised, else a group of this one
    process (NCCL on a card, gloo on the CPU; a file store in a temporary
    directory, so no port is opened) for the duration."""
    if dist.is_initialized():
        yield dist.group.WORLD
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1, timeout=datetime.timedelta(seconds=120))
        try:
            yield dist.group.WORLD
        finally:
            dist.destroy_process_group()


def _check_out(path: Path) -> Path:
    path = path.resolve()
    if path == FORBIDDEN_OUT or FORBIDDEN_OUT in path.parents:
        raise ValueError(f"{path}: the dry run does not write under "
                         f"{FORBIDDEN_OUT}")
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--m", type=int, default=1024)
    ap.add_argument("--d", type=int, default=2048)
    ap.add_argument("--q", type=float, default=32.0)
    ap.add_argument("--zipf", action="store_true",
                    help="Zipf-skewed input sizes (bucketed-executor case)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--out", type=Path, default=DEFAULT_OUT,
                    help=f"JSON report (default {DEFAULT_OUT})")
    args = ap.parse_args(argv)
    out = _check_out(args.out)
    device = resolve_device(args.device)
    # on a card its own peaks; a CPU run reports the terms for the H100
    # that the port targets
    hw = HW.for_device(device) if device.type == "cuda" else H100_SXM
    w = profile(args.m, args.q, args.zipf)
    kw = dict(device=device, hw=hw)
    with _one_rank_group(device) as group:
        rows, schema, plan_opt, _ = engine_rows(w, args.q, args.m, args.d,
                                                group, **kw)
        rows.append(analyze_coded(plan_opt, args.m, args.d,
                                  f"coded-frontier[{schema.algorithm}]",
                                  group, **kw))
    rows.append(analyze_streaming(w, args.q, args.m, args.d,
                                  "streaming-delta[insert]", **kw))
    for line in report_lines(rows):
        print(line)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
