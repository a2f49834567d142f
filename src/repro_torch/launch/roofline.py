"""Roofline terms of the port's work on an NVIDIA card.

The reference reads FLOPs and bytes from compiled XLA text
(``repro.launch.roofline`` / ``hlo_analysis``); eager PyTorch has no such
program, so here the terms come from work models over a plan's buckets
(what a kernel or runner must do on the shapes it is given) and from the
obs collective counters (what the collectives moved).

  ``HW``            the card's data-sheet peaks (``HW.for_device``).
  ``bound``         the least time for a work dict on the card: the larger
                    of its operations over the peak rate and its bytes over
                    the memory rate.
  work models       ``{"ops", "bytes"}`` of one launch or one request:
                    ``bucket_work`` / ``work_model`` (``fused_gather_gram``),
                    ``rect_bucket_work`` / ``rect_work``
                    (``fused_gather_gram_rect``), ``pairwise_bucket_work`` /
                    ``pairwise_work`` (``pairwise_gram`` on pre-gathered
                    blocks) and ``gathered_work`` (a runner that writes the
                    gathered blocks out, then multiplies them).
  ``Stats``         flops / HBM bytes / collective bytes of one stage, and
                    ``combine_stats`` to sum several (the reference's
                    ``combine_hlo_stats``).
  ``collective_snapshot`` / ``collective_bytes_since`` — per-rank moved
                    bytes by collective from the ``collective.bytes{op}``
                    counters, in the reference's ring accounting (all-gather
                    and all-to-all move their result bytes x (S-1)/S).
  ``model_flops``, ``RooflineReport``, ``analyze_step`` — the LM dry run's
                    row (``launch.dryrun``): the reference's report, its
                    terms from ``launch.op_analysis``'s per-device counts of
                    one step on the card's peaks (``HW``), never a TPU's.

A plan-level model takes a plan (or a sequence of buckets, such as one
rank's row blocks) plus ``(m, d, itemsize)``: ``m`` table rows (both
tables' rows for the rectangular models) of ``d`` elements of ``itemsize``
bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.obs import REGISTRY as _REGISTRY

__all__ = ["HW", "H100_SXM", "PEAK_FP32_CUDA_CORES", "PEAK_BF16_TENSOR",
           "PEAK_HBM", "bound", "bucket_work", "work_model",
           "rect_bucket_work", "rect_work", "pairwise_bucket_work",
           "pairwise_work", "gathered_work", "Stats", "combine_stats",
           "collective_snapshot", "collective_bytes_since", "model_flops",
           "RooflineReport", "analyze_step"]


@dataclasses.dataclass(frozen=True)
class HW:
    """A card's data-sheet peaks: ``peak_flops`` dense bf16 on tensor
    cores (the reference's ``peak_flops``), ``peak_fp32_flops`` fp32 on
    CUDA cores, ``hbm_bw`` B/s, ``link_bw`` B/s per direction between
    cards."""

    name: str
    peak_flops: float
    peak_fp32_flops: float
    hbm_bw: float
    link_bw: float

    @classmethod
    def for_device(cls, device=None) -> "HW":
        """The peaks of the card ``device`` names (``None``: the current
        CUDA device).  A card without an entry raises: one card's numbers
        never stand in for another's."""
        import torch
        dev = torch.device("cuda" if device is None else device)
        if dev.type != "cuda":
            raise ValueError(f"{dev} is not a CUDA card: pass an HW")
        name = torch.cuda.get_device_properties(dev).name
        if name not in _CARDS:
            raise ValueError(f"no data-sheet peaks for {name!r} (known: "
                             f"{sorted(_CARDS)})")
        return _CARDS[name]


# NVIDIA H100 SXM5 80 GB data sheet, dense, at 700 W
H100_SXM = HW(name="NVIDIA H100 80GB HBM3", peak_flops=989e12,
              peak_fp32_flops=67e12, hbm_bw=3.35e12, link_bw=450e9)
_CARDS = {H100_SXM.name: H100_SXM}

PEAK_FP32_CUDA_CORES = H100_SXM.peak_fp32_flops
PEAK_BF16_TENSOR = H100_SXM.peak_flops
PEAK_HBM = H100_SXM.hbm_bw


def bound(work: dict, peak_ops: float,
          hbm_bw: float = PEAK_HBM) -> tuple:
    """``(ms, "operations" | "bytes")``: the least time the card takes for
    ``work`` — the larger of its operations at ``peak_ops`` and its bytes
    at ``hbm_bw`` — and which of the two it is."""
    t_ops = work["ops"] / peak_ops * 1e3
    t_bytes = work["bytes"] / hbm_bw * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def _buckets(plan):
    return getattr(plan, "buckets", plan)


def _sum(works) -> dict:
    works = list(works)
    return {k: sum(w[k] for w in works) for k in ("ops", "bytes")}


def bucket_work(b, d: int) -> dict:
    """Operations and bytes one bucket's fused_gather_gram launch needs:
    products over the valid pairs i <= j only (the Gram block is
    symmetric: n (n + 1) / 2 dot products of d multiply-adds for n valid
    slots); idx (int32) and mask (uint8) read once, every (R, L, L) fp32
    output entry written once (the table is counted once per request, in
    ``work_model``)."""
    n = np.asarray(b.mask).sum(axis=1).astype(np.int64)
    return {"ops": d * int((n * (n + 1)).sum()),
            "bytes": b.R * b.width * 5 + b.R * b.width * b.width * 4}


def work_model(plan, m: int, d: int, itemsize: int) -> dict:
    """The same over one request's launches, with the table read once."""
    works = _sum(bucket_work(b, d) for b in _buckets(plan))
    return {"ops": works["ops"], "bytes": m * d * itemsize + works["bytes"]}


def rect_bucket_work(b, d: int) -> dict:
    """Operations and bytes one bucket's rect launch needs: products over
    valid (x, y) pairs only, 2 d per pair; idx (int32) and mask (uint8) of
    both sides read once, every (R, Lx, Ly) fp32 output entry written once
    (the tables are counted once per request, in ``rect_work``)."""
    nx = np.asarray(b.mask).sum(axis=1).astype(np.int64)
    ny = np.asarray(b.ymask).sum(axis=1).astype(np.int64)
    return {"ops": 2 * d * int((nx * ny).sum()),
            "bytes": b.R * (b.width + b.ywidth) * 5
            + b.R * b.width * b.ywidth * 4}


def rect_work(plan, m: int, d: int, itemsize: int) -> dict:
    """The same over one request's rect launches: both tables (``m`` rows
    together) read once."""
    works = _sum(rect_bucket_work(b, d) for b in _buckets(plan))
    return {"ops": works["ops"], "bytes": m * d * itemsize + works["bytes"]}


def pairwise_bucket_work(b, d: int, itemsize: int) -> dict:
    """Operations and bytes of one bucket's pairwise_gram launch on the
    self-Gram route: the gathered (R, L, d) blocks with themselves, the
    symmetric products i <= j only (L (L + 1) / 2 dot products of d
    multiply-adds per block); the blocks are read once and the (R, L, L)
    fp32 output is written once."""
    return {"ops": b.R * b.width * (b.width + 1) * d,
            "bytes": b.R * b.width * d * itemsize
            + b.R * b.width * b.width * 4}


def pairwise_work(plan, d: int, itemsize: int) -> dict:
    """The same over every bucket of one request (the blocks are already
    gathered, so no table term)."""
    return _sum(pairwise_bucket_work(b, d, itemsize) for b in _buckets(plan))


def gathered_work(plan, m: int, d: int, itemsize: int,
                  out_itemsize: int = 4) -> dict:
    """Operations and bytes of a runner that materializes the gather (the
    dense and bucketed executors): per bucket idx and mask read, the
    (R, L, d) block written by the gather and read back by the product,
    the full L x L product of every block (2 L^2 d per reducer, as a
    batched matrix product computes it) and its (R, L, L) output of
    ``out_itemsize`` bytes written; the table read once."""
    ops = nbytes = 0
    for b in _buckets(plan):
        ops += 2 * b.R * b.width * b.width * d
        nbytes += (b.R * b.width * 5 + 2 * b.R * b.width * d * itemsize
                   + b.R * b.width * b.width * out_itemsize)
    return {"ops": ops, "bytes": m * d * itemsize + nbytes}


@dataclasses.dataclass
class Stats:
    """One stage's terms on one rank (the reference's ``HloStats`` fields
    that its dry run reads)."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_ops: int = 0
    collective_by_kind: dict = dataclasses.field(default_factory=dict)


def combine_stats(stats_list) -> Stats:
    """Sum per-rank stats over several runs of one stage (the bucketed
    path's buckets run back to back)."""
    out = Stats()
    for s in stats_list:
        out.flops += s.flops
        out.hbm_bytes += s.hbm_bytes
        out.collective_bytes += s.collective_bytes
        out.collective_ops += s.collective_ops
        for k, v in s.collective_by_kind.items():
            out.collective_by_kind[k] = out.collective_by_kind.get(k, 0) + v
    return out


_OPS = {"all_gather": "all-gather", "all_to_all": "all-to-all"}


def collective_snapshot() -> dict:
    """The ``collective.bytes`` / ``collective.calls`` counters per op,
    now."""
    return {op: (_REGISTRY.counter_total("collective.bytes", op=op),
                 _REGISTRY.counter_total("collective.calls", op=op))
            for op in _OPS}


def collective_bytes_since(snapshot: dict, num_ranks: int) -> dict:
    """What this rank's collectives moved since ``snapshot`` over a group
    of ``num_ranks``, in the reference's ring accounting: an all-gather and
    an all-to-all each move their result bytes x (S-1)/S (the counters
    hold the result bytes of an all-gather and the equal-sized send bytes
    of an all-to-all).  Keys as the reference's ``collective_bytes``
    (``all-gather``, ``all-to-all``, ``ops``, ``total``), plus
    ``tensor_bytes``: the counted bytes themselves."""
    now = collective_snapshot()
    frac = (num_ranks - 1) / num_ranks if num_ranks > 1 else 0.0
    out = {"ops": 0, "tensor_bytes": 0.0}
    for op, kind in _OPS.items():
        nbytes = now[op][0] - snapshot[op][0]
        out[kind] = nbytes * frac
        out["tensor_bytes"] += nbytes
        out["ops"] += int(now[op][1] - snapshot[op][1])
    out["total"] = sum(out[k] for k in _OPS.values())
    return out


# ------------------------------------------------------------ LM dry run

def model_flops(cfg, shape_name: str) -> float:
    """Global useful FLOPs per step: 6 N_active D (train), 2 N D (prefill),
    2 N B (decode step); no attention term (the reference's)."""
    from ..configs.base import SHAPES
    seq, batch, kind = SHAPES[shape_name]
    n_active = cfg.active_param_count()
    if kind == "train":
        base = 6.0 * n_active * seq * batch
    elif kind == "prefill":
        base = 2.0 * n_active * seq * batch
    else:
        base = 2.0 * n_active * batch      # one token per request
    return base


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    num_devices: int
    flops_per_device: float
    bytes_per_device: float
    collectives: dict
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    roofline_fraction: float
    model_flops_global: float
    useful_flops_ratio: float
    memory_per_device: Optional[dict] = None
    hbm_bytes_kernel_resident: float = 0.0
    t_memory_kernel_resident: float = 0.0
    roofline_fraction_kernel_resident: float = 0.0
    bottleneck_kernel_resident: str = ""

    def row(self) -> dict:
        return dataclasses.asdict(self)


def analyze_step(stats, *, arch: str, shape: str, mesh_name: str,
                 num_devices: int, cfg=None, hw: HW = H100_SXM,
                 memory: Optional[dict] = None) -> RooflineReport:
    """The reference's ``analyze_compiled`` on one rank's
    ``op_analysis.OpStats`` of one step: compute = FLOPs over the card's
    bf16 peak, memory = HBM bytes over its memory rate, collective = moved
    bytes over its link rate; the bottleneck is the largest term and the
    roofline fraction compute over it.  ``memory`` is the per-device
    ``{argument_bytes, output_bytes, temp_bytes, peak_bytes}`` (``None``
    where not measured)."""
    coll = dict(stats.collective_by_kind)
    coll["total"] = stats.collective_bytes
    coll["ops"] = stats.collective_ops
    coll["calls"] = dict(stats.collective_calls)
    t_c = stats.flops / hw.peak_flops
    t_m = stats.hbm_bytes / hw.hbm_bw
    t_x = stats.collective_bytes / hw.link_bw
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    frac = t_c / max(max(terms.values()), 1e-30)
    mf = model_flops(cfg, shape) if cfg is not None else 0.0
    t_m_res = stats.hbm_bytes_resident / hw.hbm_bw
    terms_res = {"compute": t_c, "memory": t_m_res, "collective": t_x}
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, num_devices=num_devices,
        flops_per_device=stats.flops, bytes_per_device=stats.hbm_bytes,
        collectives=coll, t_compute=t_c, t_memory=t_m, t_collective=t_x,
        bottleneck=max(terms, key=terms.get), roofline_fraction=frac,
        model_flops_global=mf,
        useful_flops_ratio=mf / max(stats.flops * num_devices, 1e-30),
        memory_per_device=memory,
        hbm_bytes_kernel_resident=stats.hbm_bytes_resident,
        t_memory_kernel_resident=t_m_res,
        roofline_fraction_kernel_resident=t_c / max(
            max(terms_res.values()), 1e-30),
        bottleneck_kernel_resident=max(terms_res, key=terms_res.get))
