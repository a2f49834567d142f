#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``).

Drives the port's paths on one NVIDIA card through the entry points a user
calls, and checks every hand-written kernel against its plain PyTorch
version on the shapes those paths give it.  Run from the repository root:

    python3 chip_smoke.py [--out results.json]

Paths and their kernels (each driven with every launch count set to 0
just before it and read just after):

* all-pairs similarity, fused executor -> ``fused_gather_gram``: the
  repository's benchmark profile at full size (m=4096 inputs, d=256
  features, Zipf a=1.6 sizes, q=1.0, seed 0; phases 3-6);
* X2Y similarity, fused executor -> ``fused_gather_gram_rect``: the skew
  join profile of ``benchmarks/bench_x2y.py`` scaled to 8192 x 512, and the
  balanced profile at 2048 x 2048, d=256 (phases 7-8);
* block serving, fused executor -> ``fused_gather_gram_rect``: m=100,000,
  d=256, ``benchmarks/bench_hierarchy.py``'s Zipf a=0.6 sizes at q=1.0, two
  4096 x 4096 blocks (phase 9);
* all-pairs with ``use_kernel=True`` on bucketed and dense ->
  ``pairwise_gram`` (phase 10).

Phase 1 reads the device, phase 2 builds the three kernels (one nvcc per
source, all started together), phase 11 times the new kernels (CUDA
events).  Any failed check raises, so the exit code is non-zero; without a
CUDA device it exits 2 before printing any result.  The last two lines are
the ``kernels`` JSON record and the device JSON record.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import plan_a2a, plan_x2y  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.pairwise import fused_gather_gram as fgg  # noqa: E402
from repro_torch.kernels.pairwise import pairwise as pg  # noqa: E402
from repro_torch.mapreduce import (  # noqa: E402
    make_executor,
    pairwise_similarity,
    skew_join,
    x2y_similarity,
)
from repro_torch.mapreduce.allpairs import (  # noqa: E402
    _plan_for,
    _x2y_plan_for,
)
from repro_torch.mapreduce.engine import (  # noqa: E402
    block_subplan,
    bucket_arrays,
    rect_bucket_arrays,
)
from repro_torch.serve import PairwiseService  # noqa: E402

M, D, Q, ZIPF_A, SEED = 4096, 256, 1.0, 1.6, 0
# fp32: kernel and torch.bmm sum d=256 products in different orders, which
# moves a result by a few ulps of the largest partial sum (|x_i·x_j| ~ 256
# for N(0,1) rows): rtol 1e-5 / atol 1e-4.  A TF32 product (10-bit mantissa)
# is off by ~1e-1 here and fails it.  bf16 tables at 2e-2, as in the
# reference.
FP32 = dict(rtol=1e-5, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)
# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_FP32_CUDA_CORES = 67e12
PEAK_BF16_TENSOR = 989e12
PEAK_HBM = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def bench_profile(m: int, d: int, seed: int):
    """The repository's skewed benchmark profile
    (``benchmarks/bench_engine.py::run_skewed``)."""
    rng = np.random.default_rng(seed)
    w = np.clip(rng.zipf(ZIPF_A, m).astype(np.float64) / 32.0,
                0.01, 0.45 * Q)
    x = rng.normal(size=(m, d)).astype(np.float32)
    return w, x


def time_cuda(fn, iters: int, warmup: int = 2) -> float:
    """Milliseconds per call of ``fn``: CUDA events around ``iters`` warm
    calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(got, want) -> float:
    return float((got - want).abs().max()) if got.numel() else 0.0


def check_kernel(x, idx, mask, tol, what: str) -> float:
    got = fgg.fused_gather_gram(x, idx, mask)
    torch.cuda.synchronize()
    want = fgg.fused_gather_gram_ref(x, idx, mask)
    torch.testing.assert_close(got, want, **tol, msg=lambda s: f"{what}: {s}")
    return max_err(got, want)


def phase_device() -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log(f"phase 1 device: {name} | nvidia-smi: {smi} | "
        f"count={torch.cuda.device_count()} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | python {sys.version.split()[0]}")
    return {"name": name, "smi": smi}


KERNELS = ("fused_gather_gram", "fused_gather_gram_rect", "pairwise_gram")


def phase_build() -> dict:
    t0 = time.perf_counter()
    each = _build.build_all(KERNELS, force=True)
    dt = time.perf_counter() - t0
    log(f"phase 2 build: three nvcc sm_90a builds in parallel, {dt:.2f} s "
        f"wall ({', '.join(f'{k} {v:.2f} s' for k, v in each.items())})")
    for name in KERNELS:
        lines = _build.build_log(name).splitlines()
        regs = sorted({int(ln.split("Used ")[1].split()[0]) for ln in lines
                       if "Used " in ln and "registers" in ln})
        spills = sorted({ln.strip() for ln in lines if "spill" in ln
                         and "0 bytes spill stores, 0 bytes spill loads"
                         not in ln})
        log(f"  {name}: {len([ln for ln in lines if 'registers' in ln])} "
            f"instantiations, registers {regs}; non-zero spills: "
            f"{spills or 'none'}")
    return {"wall_s": dt, "each_s": each}


def phase_kernel_vs_plain(x, plan) -> dict:
    dev = x.device
    errs = {"float32": 0.0, "bfloat16": 0.0}
    arrays = bucket_arrays(plan, dev)
    for b, (idx, mask, _) in zip(plan.buckets, arrays):
        e32 = check_kernel(x, idx, mask, FP32, f"bucket {b.width} fp32")
        e16 = check_kernel(x.bfloat16(), idx, mask, BF16,
                           f"bucket {b.width} bf16")
        errs["float32"] = max(errs["float32"], e32)
        errs["bfloat16"] = max(errs["bfloat16"], e16)
        log(f"phase 3 kernel==plain bucket width={b.width} R={b.R}: "
            f"max_abs_err fp32 {e32:.3e} bf16 {e16:.3e}")
    rng = np.random.default_rng(1)
    m = x.shape[0]
    cases = []
    for R, L in [(1000, 1), (64, 37), (16, 130)]:
        idx = torch.from_numpy(rng.integers(0, m, (R, L)).astype(np.int32))
        mask = torch.from_numpy(rng.uniform(size=(R, L)) < 0.8)
        cases.append((f"width {L}", idx, mask))
    idx = torch.from_numpy(rng.integers(0, m, (8, 16)).astype(np.int32))
    mask = torch.ones((8, 16), dtype=torch.bool)
    mask[3] = False                                   # all-masked padding row
    cases.append(("all-masked row", idx, mask))
    for what, idx, mask in cases:
        idx, mask = idx.to(dev), mask.to(dev)
        e32 = check_kernel(x, idx, mask, FP32, what + " fp32")
        e16 = check_kernel(x.bfloat16(), idx, mask, BF16, what + " bf16")
        if what == "all-masked row":
            assert float(fgg.fused_gather_gram(x, idx, mask)[3].abs()
                         .max()) == 0.0
        log(f"phase 3 kernel==plain {what}: max_abs_err fp32 {e32:.3e} "
            f"bf16 {e16:.3e}")
    empty = fgg.fused_gather_gram(x, arrays[0][0][:0], arrays[0][1][:0])
    assert empty.shape == (0, plan.buckets[0].width, plan.buckets[0].width)
    log("phase 3 kernel R=0: empty (0, L, L) output, no launch")
    return errs


def phase_end_to_end(x, schema, plan) -> dict:
    out = {}
    fgg.reset_launch_count()
    t0 = time.perf_counter()
    fused, _, _ = pairwise_similarity(x, q=Q, schema=schema, metric="dot",
                                      executor="fused", device="cuda")
    torch.cuda.synchronize()
    out["first_request_s"] = time.perf_counter() - t0
    out["launches"] = fgg.launch_count()
    assert out["launches"] == len(plan.buckets), out
    log(f"phase 4 main path: pairwise_similarity(executor='fused') m={M} "
        f"d={D}: {out['launches']} kernel launches "
        f"({len(plan.buckets)} buckets), first call "
        f"{out['first_request_s']:.3f} s incl. source map")
    for metric in ("dot", "l2", "cosine"):
        fused, _, _ = pairwise_similarity(x, q=Q, schema=schema,
                                          metric=metric, executor="fused")
        buck, _, _ = pairwise_similarity(x, q=Q, schema=schema,
                                         metric=metric, executor="bucketed")
        assert fused.shape == (M, M) and bool(torch.isfinite(fused).all())
        torch.testing.assert_close(fused, buck, **FP32)
        out[f"fused_vs_bucketed_{metric}"] = max_err(fused, buck)
        log(f"phase 4 fused==bucketed m={M} d={D} {metric}: max_abs_err "
            f"{out[f'fused_vs_bucketed_{metric}']:.3e}")
        del fused, buck
    ws, xs = bench_profile(512, 64, SEED)
    small = plan_a2a(ws, Q)
    for metric in ("dot", "l2", "cosine"):
        res = {ex: pairwise_similarity(xs, q=Q, schema=small, metric=metric,
                                       executor=ex)[0]
               for ex in ("dense", "bucketed", "fused")}
        cpu = pairwise_similarity(xs, q=Q, schema=small, metric=metric,
                                  executor="fused", device="cpu")[0]
        torch.testing.assert_close(res["fused"], res["dense"], **FP32)
        torch.testing.assert_close(res["bucketed"], res["dense"], **FP32)
        torch.testing.assert_close(res["fused"].cpu(), cpu, **FP32)
        log(f"phase 4 dense==bucketed==fused m=512 d=64 {metric}: max_abs_err "
            f"fused-dense {max_err(res['fused'], res['dense']):.3e}, "
            f"card-cpu {max_err(res['fused'].cpu(), cpu):.3e}")
    return out


def phase_serving() -> list:
    svc = PairwiseService(q=Q, executor="fused", metric="cosine")
    walls = []
    for seed in (1, 2):
        w, x = bench_profile(M, D, seed)
        for rep in range(2):
            before = fgg.launch_count()
            sims, info = svc.similarity(x, w)
            launched = fgg.launch_count() - before
            assert info["fused_path"] == "kernel", info["fused_path"]
            assert launched == len(info["bucket_widths"]), launched
            assert info["comm"]["measured_over_predicted"] == 1.0
            if rep:
                assert info["plan_cache_hit"]
            assert sims.shape == (M, M) and bool(torch.isfinite(sims).all())
            assert float(sims.diagonal().abs().max()) == 0.0
            torch.testing.assert_close(sims, sims.T, **FP32)
            walls.append(info["wall_s"])
            log(f"phase 5 request profile seed={seed} rep={rep}: "
                f"fused_path={info['fused_path']} launches={launched} "
                f"plan_cache_hit={info['plan_cache_hit']} "
                f"comm ratio={info['comm']['measured_over_predicted']} "
                f"algorithm={info['algorithm']} wall {info['wall_s']:.3f} s")
    return walls


def work_model(x, plan) -> dict:
    """Operations and bytes one request's fused_gather_gram launches need:
    products over valid pairs only; table read once, idx (int32) and mask
    (uint8) read once, every (R, L, L) fp32 output entry written once."""
    ops = 0
    out_bytes = 0
    in_bytes = x.shape[0] * x.shape[1] * x.element_size()
    for b in plan.buckets:
        n = b.mask.sum(axis=1).astype(np.int64)
        ops += 2 * x.shape[1] * int((n * n).sum())
        in_bytes += b.R * b.width * 5
        out_bytes += b.R * b.width * b.width * 4
    return {"ops": ops, "bytes": in_bytes + out_bytes}


def bound(work: dict, peak_ops: float) -> tuple:
    t_ops = work["ops"] / peak_ops * 1e3
    t_bytes = work["bytes"] / PEAK_HBM * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def profile_request(fn, label: str) -> dict:
    """Device time of one warm request ``fn()`` by kernel (torch.profiler),
    and the device's idle share of that request's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies, memsets): the CPU-side ops
    # that launched them carry the same device time again
    by_name = {e.key: e.self_device_time_total / 1e3
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA}
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"{label} profile of one warm request: device busy {busy_ms:.3f} ms "
        f"of {wall_ms:.3f} ms wall under the profiler (idle share "
        f"{1 - busy_ms / wall_ms:.3f}); top device time:")
    for name, ms in top:
        log(f"  {ms:9.3f} ms  {name[:90]}")
    return {"device_busy_ms": busy_ms, "profiled_wall_ms": wall_ms,
            "device_top_ms": dict(top)}


def phase_timing(x, schema, plan) -> dict:
    arrays = bucket_arrays(plan, x.device)
    rows = []
    tot = {"kernel_fp32": 0.0, "kernel_bf16": 0.0, "plain": 0.0, "bmm": 0.0}
    xb = x.bfloat16()
    for b, (idx, mask, _) in zip(plan.buckets, arrays):
        k32 = time_cuda(lambda: fgg.fused_gather_gram(x, idx, mask), 20)
        k16 = time_cuda(lambda: fgg.fused_gather_gram(xb, idx, mask), 20)
        plain = time_cuda(lambda: fgg.fused_gather_gram_ref(x, idx, mask), 5)
        g = x.index_select(0, idx.reshape(-1)).reshape(b.R, b.width, -1)
        g = g * mask[..., None]
        bmm = time_cuda(lambda: torch.bmm(g, g.transpose(1, 2)), 10)
        del g
        tot["kernel_fp32"] += k32
        tot["kernel_bf16"] += k16
        tot["plain"] += plain
        tot["bmm"] += bmm
        rows.append({"width": b.width, "R": b.R, "kernel_fp32_ms": k32,
                     "kernel_bf16_ms": k16, "plain_ms": plain,
                     "bmm_ms": bmm})
        log(f"phase 6 bucket width={b.width} R={b.R}: kernel fp32 "
            f"{k32:.4f} ms, bf16 {k16:.4f} ms; plain {plain:.4f} ms; "
            f"torch.bmm on pre-gathered blocks {bmm:.4f} ms")
    # a warmed request: plan and source map cached, device work + launches
    t = []
    for _ in range(5):
        t0 = time.perf_counter()
        pairwise_similarity(x, q=Q, schema=schema, metric="cosine",
                            executor="fused")
        torch.cuda.synchronize()
        t.append(time.perf_counter() - t0)
    tot["warm_request_s"] = float(np.median(t))
    tot.update(profile_request(
        lambda: pairwise_similarity(x, q=Q, schema=schema, metric="cosine",
                                    executor="fused"), "phase 6"))
    log(f"phase 6 totals over {len(plan.buckets)} buckets: kernel fp32 "
        f"{tot['kernel_fp32']:.4f} ms, bf16 {tot['kernel_bf16']:.4f} ms; "
        f"plain {tot['plain']:.4f} ms; bmm yardstick {tot['bmm']:.4f} ms; "
        f"warm request (plan cached) median {tot['warm_request_s']:.4f} s")
    return {"buckets": rows, "totals": tot}


# ---------------------------------------------------------------------------
# the rectangular path: X2Y similarity, skew join, block serving
# ---------------------------------------------------------------------------
MX, MY = 8192, 512                  # skew join profile, scaled
MB = 2048                           # balanced profile, both sides
M_BLOCK, Q_BLOCK = 100_000, 1.0     # block serving table
BLOCKS = [(0, 4096, 4096, 8192), (0, 4096, 0, 4096)]
# the keys of the reference service's info (tests/test_torch_x2y.py holds
# the port's keys and values equal to the reference's on the CPU)
INFO_KEYS = {"algorithm", "comm_cost", "lower_bound", "optimality_gap",
             "reducers", "bucket_widths", "dense_padded_elements",
             "bucketed_padded_elements", "padding_savings", "executor",
             "plan_cache_hit", "fused_path", "jit_cache", "wall_s", "comm"}


def counts() -> dict:
    return {k: _build.launch_counts().get(k, 0) for k in KERNELS}


def x2y_profile(kind: str, seed: int = SEED):
    """``benchmarks/bench_x2y.py``'s X2Y profiles at full size: skew join
    (X sizes U(0.01, 0.1), Y sizes U(0.2, 0.45)) and balanced (both
    U(0.05, 0.45)); q = 1.0, N(0, 1) features."""
    rng = np.random.default_rng(seed)
    if kind == "skew":
        wx, wy = rng.uniform(0.01, 0.1, MX), rng.uniform(0.2, 0.45, MY)
    else:
        wx, wy = rng.uniform(0.05, 0.45, MB), rng.uniform(0.05, 0.45, MB)
    x = rng.normal(size=(len(wx), D)).astype(np.float32)
    y = rng.normal(size=(len(wy), D)).astype(np.float32)
    return wx, wy, x, y


def block_profile(m: int, seed: int = SEED):
    """``benchmarks/bench_hierarchy.py::zipf_weights`` (w_k ~ k^-0.6,
    shuffled, clipped under q/4) at q = 1.0, N(0, 1) features."""
    w = 1.0 / (np.arange(1, m + 1) ** 0.6)
    w = np.clip(w / w.max(), None, 0.24 * Q_BLOCK)
    np.random.default_rng(seed).shuffle(w)
    x = np.random.default_rng(seed + 1).normal(size=(m, D)).astype(np.float32)
    return w, x


def oracle(x, y, metric: str):
    """The direct cross similarity (TF32 off), as block_similarity_x2y
    defines it, with every pair valid."""
    with fgg.ieee_fp32():
        g = x @ y.T
    if metric == "dot":
        return g
    n2x, n2y = x.square().sum(-1), y.square().sum(-1)
    if metric == "l2":
        return n2x[:, None] + n2y[None, :] - 2.0 * g
    return g / (torch.sqrt(n2x + 1e-9)[:, None]
                * torch.sqrt(n2y + 1e-9)[None, :])


def check_rect_buckets(x, y, plan, what: str) -> dict:
    """The rect kernel against its plain version on every bucket, fp32 and
    bf16."""
    errs = {"float32": 0.0, "bfloat16": 0.0}
    xb, yb = x.bfloat16(), y.bfloat16()
    for b, arr in zip(plan.buckets, rect_bucket_arrays(plan, x.device)):
        for dtype, (xt, yt), tol in (("float32", (x, y), FP32),
                                     ("bfloat16", (xb, yb), BF16)):
            got = fgg.fused_gather_gram_rect(xt, yt, *arr[:4])
            torch.cuda.synchronize()
            want = fgg.fused_gather_gram_rect_ref(xt, yt, *arr[:4])
            torch.testing.assert_close(
                got, want, **tol,
                msg=lambda m: f"{what} bucket {b.width}x{b.ywidth}: {m}")
            errs[dtype] = max(errs[dtype], max_err(got, want))
            del got, want
        log(f"  {what} rect kernel==plain bucket {b.width}x{b.ywidth} "
            f"R={b.R}: ok (running max fp32 {errs['float32']:.3e}, bf16 "
            f"{errs['bfloat16']:.3e})")
    return errs


def rect_work(x, y, plan) -> dict:
    """Operations and bytes one request's rect launches need: products
    over valid (x, y) pairs only; both tables read once, idx (int32) and
    mask (uint8) of both sides read once, every (R, Lx, Ly) fp32 output
    entry written once."""
    ops = 0
    nbytes = (x.shape[0] + y.shape[0]) * x.shape[1] * x.element_size()
    for b in plan.buckets:
        nx = b.mask.sum(axis=1).astype(np.int64)
        ny = b.ymask.sum(axis=1).astype(np.int64)
        ops += 2 * x.shape[1] * int((nx * ny).sum())
        nbytes += b.R * (b.width + b.ywidth) * 5 + b.R * b.width * b.ywidth * 4
    return {"ops": ops, "bytes": nbytes}


def x2y_host(kind: str):
    wx, wy, x_np, y_np = x2y_profile(kind)
    t0 = time.perf_counter()
    schema = plan_x2y(wx, wy, Q)
    t_plan = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = _x2y_plan_for(schema, len(wx), pad_reducers_to=1, pad_slots_to=1)
    t_build = time.perf_counter() - t0
    x, y = torch.from_numpy(x_np).cuda(), torch.from_numpy(y_np).cuda()
    log(f"{kind} X2Y plan {len(wx)}x{len(wy)} d={D}: {schema.algorithm}, "
        f"{plan.num_reducers} reducers, buckets "
        f"{[(b.width, b.ywidth, b.R) for b in plan.buckets]}, "
        f"{sum(b.R * b.width * b.ywidth for b in plan.buckets)} padded "
        f"entries; host plan_x2y {t_plan:.2f} s, build_x2y_plan "
        f"{t_build:.2f} s")
    return {"wx": wx, "wy": wy, "x": x, "y": y, "schema": schema,
            "plan": plan, "plan_s": t_plan, "build_plan_s": t_build}


def phase_x2y(case: dict, kind: str, full: bool) -> dict:
    """Phase 7 (skew, ``full``) / 8 (balanced): the rect kernel against its
    plain version on every bucket, then the main X2Y path once with the
    counts at 0, then fused against bucketed and the direct oracle."""
    x, y, schema, plan = case["x"], case["y"], case["schema"], case["plan"]
    phase = 7 if full else 8
    out = {"errs": check_rect_buckets(x, y, plan, f"phase {phase} {kind}")}
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    fused, _, _ = x2y_similarity(x, y, q=Q, schema=schema, metric="dot",
                                 executor="fused")
    torch.cuda.synchronize()
    out["first_request_s"] = time.perf_counter() - t0
    out["launches"] = counts()
    assert out["launches"] == {"fused_gather_gram": 0,
                               "fused_gather_gram_rect": len(plan.buckets),
                               "pairwise_gram": 0}, out["launches"]
    log(f"phase {phase} {kind} X2Y path: x2y_similarity(executor='fused') "
        f"launches {out['launches']} ({len(plan.buckets)} buckets), first "
        f"call {out['first_request_s']:.3f} s incl. source map")
    for metric in ("dot", "l2", "cosine") if full else ("dot", "cosine"):
        fused, _, _ = x2y_similarity(x, y, q=Q, schema=schema, metric=metric,
                                     executor="fused")
        want = oracle(x, y, metric)
        assert fused.shape == want.shape and bool(torch.isfinite(fused)
                                                  .all())
        torch.testing.assert_close(fused, want, **FP32)
        out[f"fused_vs_oracle_{metric}"] = max_err(fused, want)
        msg = f"fused==oracle {out[f'fused_vs_oracle_{metric}']:.3e}"
        if full:
            buck, _, _ = x2y_similarity(x, y, q=Q, schema=schema,
                                        metric=metric, executor="bucketed")
            torch.testing.assert_close(fused, buck, **FP32)
            out[f"fused_vs_bucketed_{metric}"] = max_err(fused, buck)
            msg += f", fused==bucketed {max_err(fused, buck):.3e}"
            del buck
        log(f"phase {phase} {kind} {metric}: max_abs_err {msg}")
        del fused, want
    return out


def phase_x2y_serving(case: dict) -> dict:
    """PairwiseService.x2y twice on the skew profile: each request plans
    anew (plan_x2y is not memoized, as in the reference) and launches the
    rect kernel once per bucket."""
    svc = PairwiseService(q=Q, executor="fused", metric="cosine")
    plan = case["plan"]
    walls = []
    for rep in range(2):
        before = counts()
        sims, info = svc.x2y(case["x"], case["y"], case["wx"], case["wy"])
        launched = {k: v - before[k] for k, v in counts().items()}
        assert set(info) == INFO_KEYS, sorted(set(info) ^ INFO_KEYS)
        assert launched["fused_gather_gram_rect"] == len(plan.buckets), \
            launched
        assert info["fused_path"] == "kernel" and not info["plan_cache_hit"]
        assert info["reducers"] == plan.num_reducers
        assert info["bucket_widths"] == plan.bucket_widths()
        assert info["comm"]["measured_over_predicted"] == 1.0
        assert sims.shape == (MX, MY) and bool(torch.isfinite(sims).all())
        walls.append(info["wall_s"])
        log(f"phase 7 service x2y rep={rep}: fused_path={info['fused_path']}"
            f" launches={launched['fused_gather_gram_rect']} "
            f"plan_cache_hit={info['plan_cache_hit']} comm ratio="
            f"{info['comm']['measured_over_predicted']} wall "
            f"{info['wall_s']:.3f} s")
    want = oracle(case["x"], case["y"], "cosine")
    torch.testing.assert_close(sims, want, **FP32)
    return {"walls": walls}


def phase_skew_join(case: dict) -> dict:
    """The skew join on the full skew profile with (3, 2)-wide payloads:
    the fused executor takes its counted non-Gram fallback and matches the
    dense executor."""
    rng = np.random.default_rng(SEED + 7)
    xv = torch.from_numpy(rng.normal(size=(MX, 3)).astype(np.float32)).cuda()
    yv = torch.from_numpy(rng.normal(size=(MY, 2)).astype(np.float32)).cuda()
    before = counts()
    fused_ex = make_executor("fused")
    out, _ = skew_join(xv, yv, q=Q, schema=case["schema"], executor=fused_ex)
    dense, _ = skew_join(xv, yv, q=Q, schema=case["schema"],
                         executor="dense")
    torch.cuda.synchronize()
    assert counts() == before, "the join's reducer is not a Gram block"
    assert fused_ex.stats()["fallbacks"] == 1
    assert out.shape == (MX, MY, 5)
    torch.testing.assert_close(out, dense, rtol=0, atol=0)
    want = torch.cat([xv[:, None, :].expand(MX, MY, 3),
                      yv[None, :, :].expand(MX, MY, 2)], dim=-1)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    log(f"phase 7 skew_join {MX}x{MY} payloads (3, 2): fused fallback "
        f"counted ({fused_ex.stats()['fallbacks']}), fused==dense==direct "
        f"join exactly")
    return {"fallbacks": fused_ex.stats()["fallbacks"]}


def phase_blocks() -> dict:
    """Phase 9: block serving at m=100,000 through PairwiseService."""
    w, x_np = block_profile(M_BLOCK)
    svc = PairwiseService(q=Q_BLOCK, executor="fused", metric="dot")
    info = svc.load_block_table(x_np, w)
    x = svc._block_table
    log(f"phase 9 load_block_table m={M_BLOCK} d={D}: {info['algorithm']}, "
        f"{info['reducers']} reducers, {info['bins']} bins, host entries "
        f"{info['host_entries']}, {info['wall_s']:.2f} s")
    out = {"load_s": info["wall_s"], "algorithm": info["algorithm"],
           "blocks": []}
    for i0, i1, j0, j1 in BLOCKS:
        t0 = time.perf_counter()
        sub = block_subplan(svc._block_sparse, i0, i1, j0, j1)
        t_sub = time.perf_counter() - t0
        xs, ys = x[i0:i1], x[j0:j1]
        errs = check_rect_buckets(xs, ys, sub, f"phase 9 block "
                                  f"[{i0}:{i1})x[{j0}:{j1})")
        _build.reset_launch_counts()
        blk, binfo = svc.block(i0, i1, j0, j1)       # sub-plan LRU hit
        launched = counts()
        assert launched == {"fused_gather_gram": 0,
                            "fused_gather_gram_rect": len(sub.buckets),
                            "pairwise_gram": 0}, launched
        want = oracle(xs, ys, "dot")
        lo, hi = max(i0, j0), min(i1, j1)
        if lo < hi:
            d = torch.arange(lo, hi, device=x.device)
            want[d - i0, d - j0] = 0.0
        torch.testing.assert_close(blk, want, **FP32)
        e = max_err(blk, want)
        t0 = time.perf_counter()
        svc.block(i0, i1, j0, j1)
        warm = time.perf_counter() - t0
        rec = {"block": (i0, i1, j0, j1), "subplan_s": t_sub,
               "first_request_s": binfo["wall_s"], "warm_request_s": warm,
               "launches": launched, "reducers": sub.num_reducers,
               "buckets": [(b.width, b.ywidth, b.R) for b in sub.buckets],
               "entries": sum(b.R * b.width * b.ywidth
                              for b in sub.buckets),
               "kernel_errs": errs, "oracle_err": e, "plan": sub, "x": xs,
               "y": ys}
        out["blocks"].append(rec)
        log(f"phase 9 block [{i0}:{i1})x[{j0}:{j1}): block_subplan "
            f"{t_sub:.2f} s, {sub.num_reducers} reducers in buckets "
            f"{rec['buckets']}, {rec['entries']} entries; launches "
            f"{launched['fused_gather_gram_rect']}; first request "
            f"{binfo['wall_s']:.3f} s (source map), warm {warm:.4f} s; "
            f"block==x_i x_j^T (diagonal zeroed) max_abs_err {e:.3e}")
        del blk, want
    return out


def phase_pairwise_gram(x, schema, plan) -> dict:
    """Phase 10: ``pairwise_gram`` against its plain version on the main
    path's bucket blocks, then ``use_kernel=True`` on bucketed (m=4096)
    against the fused result and on dense (m=512)."""
    out = {"errs": {"float32": 0.0, "bfloat16": 0.0}}
    for b, (idx, mask, _) in zip(plan.buckets, bucket_arrays(plan, x.device)):
        g = fgg.gather_rows(x, idx, mask)
        for dtype, blocks, tol in (("float32", g, FP32),
                                   ("bfloat16", g.bfloat16(), BF16)):
            got = pg.pairwise_gram_batched(blocks, blocks)
            torch.cuda.synchronize()
            want = pg.pairwise_gram_ref(blocks, blocks)
            torch.testing.assert_close(
                got, want, **tol,
                msg=lambda m: f"pairwise_gram bucket {b.width}: {m}")
            out["errs"][dtype] = max(out["errs"][dtype], max_err(got, want))
            del got, want, blocks
        del g
        log(f"phase 10 pairwise_gram==plain bucket width={b.width} R={b.R}: "
            f"ok (running max fp32 {out['errs']['float32']:.3e}, bf16 "
            f"{out['errs']['bfloat16']:.3e})")
    _build.reset_launch_counts()
    got, _, _ = pairwise_similarity(x, q=Q, schema=schema, metric="cosine",
                                    executor="bucketed", use_kernel=True)
    torch.cuda.synchronize()
    out["launches"] = counts()
    assert out["launches"] == {"fused_gather_gram": 0,
                               "fused_gather_gram_rect": 0,
                               "pairwise_gram": len(plan.buckets)}, \
        out["launches"]
    fused, _, _ = pairwise_similarity(x, q=Q, schema=schema, metric="cosine",
                                      executor="fused")
    torch.testing.assert_close(got, fused, **FP32)
    out["bucketed_vs_fused_cosine"] = max_err(got, fused)
    del got, fused
    log(f"phase 10 use_kernel path: pairwise_similarity(executor="
        f"'bucketed', use_kernel=True) m={M} launches {out['launches']}; "
        f"==fused (cosine) max_abs_err {out['bucketed_vs_fused_cosine']:.3e}")
    ws, xs = bench_profile(512, D, SEED)
    small = plan_a2a(ws, Q)
    for metric in ("dot", "l2"):
        before = counts()["pairwise_gram"]
        dense, _, _ = pairwise_similarity(xs, q=Q, schema=small,
                                          metric=metric, executor="dense",
                                          use_kernel=True)
        assert counts()["pairwise_gram"] == before + 1
        want, _, _ = pairwise_similarity(xs, q=Q, schema=small,
                                         metric=metric, executor="fused")
        torch.testing.assert_close(dense, want, **FP32)
        log(f"phase 10 dense use_kernel=True m=512 {metric}: one launch, "
            f"==fused max_abs_err {max_err(dense, want):.3e}")
    return out


def time_rect(x, y, plan) -> dict:
    """CUDA-event times of the rect kernel per bucket of one request, its
    plain version, and torch.bmm on the pre-gathered blocks."""
    rows, tot = [], {"kernel_fp32": 0.0, "kernel_bf16": 0.0, "plain": 0.0,
                     "bmm": 0.0}
    xb, yb = x.bfloat16(), y.bfloat16()
    for b, arr in zip(plan.buckets, rect_bucket_arrays(plan, x.device)):
        a = arr[:4]
        k32 = time_cuda(lambda: fgg.fused_gather_gram_rect(x, y, *a), 10)
        k16 = time_cuda(lambda: fgg.fused_gather_gram_rect(xb, yb, *a), 10)
        plain = time_cuda(lambda: fgg.fused_gather_gram_rect_ref(x, y, *a),
                          3, warmup=1)
        gx, gy = fgg.gather_rows(x, a[0], a[1]), fgg.gather_rows(y, a[2], a[3])
        with fgg.ieee_fp32():
            bmm = time_cuda(lambda: torch.bmm(gx, gy.transpose(1, 2)), 5)
        del gx, gy
        for k, v in (("kernel_fp32", k32), ("kernel_bf16", k16),
                     ("plain", plain), ("bmm", bmm)):
            tot[k] += v
        rows.append({"width": b.width, "ywidth": b.ywidth, "R": b.R,
                     "kernel_fp32_ms": k32, "kernel_bf16_ms": k16,
                     "plain_ms": plain, "bmm_ms": bmm})
    return {"buckets": rows, "totals": tot}


def time_pairwise_gram(x, plan) -> dict:
    """CUDA-event times of pairwise_gram per bucket of the main plan on the
    gathered blocks, its plain version, and one torch.bmm (the library
    yardstick, TF32 off) on the same blocks."""
    rows, tot = [], {"kernel_fp32": 0.0, "kernel_bf16": 0.0, "plain": 0.0,
                     "bmm": 0.0}
    for b, (idx, mask, _) in zip(plan.buckets, bucket_arrays(plan, x.device)):
        g = fgg.gather_rows(x, idx, mask)
        gb = g.bfloat16()
        k32 = time_cuda(lambda: pg.pairwise_gram_batched(g, g), 10)
        k16 = time_cuda(lambda: pg.pairwise_gram_batched(gb, gb), 10)
        plain = time_cuda(lambda: pg.pairwise_gram_ref(g, g), 5)
        with fgg.ieee_fp32():
            bmm = time_cuda(lambda: torch.bmm(g, g.transpose(1, 2)), 5)
        del g, gb
        for k, v in (("kernel_fp32", k32), ("kernel_bf16", k16),
                     ("plain", plain), ("bmm", bmm)):
            tot[k] += v
        rows.append({"width": b.width, "R": b.R, "kernel_fp32_ms": k32,
                     "kernel_bf16_ms": k16, "plain_ms": plain,
                     "bmm_ms": bmm})
    return {"buckets": rows, "totals": tot}


def pairwise_work(x, plan) -> dict:
    """Operations and bytes of one request's pairwise_gram launches: each
    is a dense batched product of the gathered (R, L, d) blocks with
    themselves — every product counts, the blocks are read once and the
    (R, L, L) fp32 output is written once."""
    d, item = x.shape[1], x.element_size()
    ops = sum(2 * b.R * b.width * b.width * d for b in plan.buckets)
    nbytes = sum(b.R * b.width * d * item + b.R * b.width * b.width * 4
                 for b in plan.buckets)
    return {"ops": ops, "bytes": nbytes}


def warm_request(fn, reps: int = 5) -> float:
    """Median host-clock seconds of ``fn()`` ending in a synchronize."""
    t = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        t.append(time.perf_counter() - t0)
    return float(np.median(t))


def phase_timing_new(skew, bal, blocks, x, plan) -> dict:
    """Phase 11: per-bucket and per-request times of the new kernels, warm
    request times and device profiles of the new paths."""
    out = {}
    for kind, case in (("skew", skew), ("balanced", bal)):
        t = time_rect(case["x"], case["y"], case["plan"])
        t["totals"]["warm_request_s"] = warm_request(
            lambda: x2y_similarity(case["x"], case["y"], q=Q,
                                   schema=case["schema"], metric="cosine",
                                   executor="fused"))
        t["totals"].update(profile_request(
            lambda: x2y_similarity(case["x"], case["y"], q=Q,
                                   schema=case["schema"], metric="cosine",
                                   executor="fused"), f"{kind} X2Y"))
        out[kind] = t
    for rec in blocks["blocks"]:
        i0, i1, j0, j1 = rec["block"]
        t = time_rect(rec["x"], rec["y"], rec["plan"])
        out[f"block_{i0}_{j0}"] = t
    out["pairwise_gram"] = time_pairwise_gram(x, plan)
    for name, t in out.items():
        for r in t["buckets"]:
            shape = (f"{r['width']}x{r['ywidth']}" if "ywidth" in r
                     else f"{r['width']}")
            log(f"phase 11 {name} bucket {shape} R={r['R']}: kernel fp32 "
                f"{r['kernel_fp32_ms']:.4f} ms, bf16 "
                f"{r['kernel_bf16_ms']:.4f} ms; plain {r['plain_ms']:.4f} "
                f"ms; torch.bmm {r['bmm_ms']:.4f} ms")
        tt = t["totals"]
        log(f"phase 11 {name} per request: kernel fp32 "
            f"{tt['kernel_fp32']:.4f} ms, bf16 {tt['kernel_bf16']:.4f} ms; "
            f"plain {tt['plain']:.4f} ms; torch.bmm {tt['bmm']:.4f} ms"
            + (f"; warm request median {tt['warm_request_s']:.4f} s"
               if "warm_request_s" in tt else ""))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every measured number here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False    # fp32 oracles, no TF32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = phase_device()
    build_s = phase_build()

    w, x_np = bench_profile(M, D, SEED)
    t0 = time.perf_counter()
    schema = plan_a2a(w, Q)
    t_plan = time.perf_counter() - t0
    t0 = time.perf_counter()
    # memoized on the schema: pairwise_similarity(schema=schema) reuses it
    plan = _plan_for(schema, pad_reducers_to=1, pad_slots_to=1)
    t_build = time.perf_counter() - t0
    x = torch.from_numpy(x_np).cuda()
    work = work_model(x, plan)
    log(f"plan m={M} d={D}: {schema.algorithm}, {plan.num_reducers} "
        f"reducers, bucket widths {plan.bucket_widths()} with "
        f"{[b.R for b in plan.buckets]} reducers, "
        f"{sum(b.R * b.width ** 2 for b in plan.buckets)} Gram entries, "
        f"{work['ops']} FLOP over valid pairs; host plan_a2a "
        f"{t_plan:.2f} s, build_plan {t_build:.2f} s")

    errs = phase_kernel_vs_plain(x, plan)
    e2e = phase_end_to_end(x, schema, plan)
    walls = phase_serving()
    timing = phase_timing(x, schema, plan)

    skew = x2y_host("skew")
    x2y_skew = phase_x2y(skew, "skew", full=True)
    x2y_serving = phase_x2y_serving(skew)
    join = phase_skew_join(skew)
    bal = x2y_host("balanced")
    x2y_bal = phase_x2y(bal, "balanced", full=False)
    blocks = phase_blocks()
    pgram = phase_pairwise_gram(x, schema, plan)
    timing_new = phase_timing_new(skew, bal, blocks, x, plan)

    tot = timing["totals"]
    bound_ms, bound_by = bound(work, PEAK_FP32_CUDA_CORES)
    b16_ms, b16_by = bound(work, PEAK_BF16_TENSOR)
    log(f"bound fp32 {bound_ms:.4f} ms ({bound_by}); bf16 {b16_ms:.4f} ms "
        f"({b16_by}); kernel fp32 at {bound_ms / tot['kernel_fp32']:.3f} "
        f"of its bound, bf16 at {b16_ms / tot['kernel_bf16']:.3f}")
    log(f"request wall (serving, host plan + source map + device) "
        f"{[round(v, 4) for v in walls]} s | card: {card['smi']}")
    kernels = [{
        "name": "fused_gather_gram",
        "route": "cuda",
        "source": "src/repro_torch/csrc/fused_gather_gram.cu",
        "replaces": "src/repro/kernels/pairwise/fused_gather_gram.py:115",
        "launches": e2e["launches"],
        "max_abs_err": errs["float32"],
        "ms": tot["kernel_fp32"],
        "plain_ms": tot["plain"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "bmm_pregathered_ms": tot["bmm"],
    }]
    rect_paths = {}
    for name, xt, yt, rplan, launches in (
            [("x2y_skew", skew["x"], skew["y"], skew["plan"],
              x2y_skew["launches"]),
             ("x2y_balanced", bal["x"], bal["y"], bal["plan"],
              x2y_bal["launches"])]
            + [(f"block_{r['block'][0]}_{r['block'][2]}", r["x"], r["y"],
                r["plan"], r["launches"]) for r in blocks["blocks"]]):
        t = timing_new[name.replace("x2y_", "")]["totals"]
        b_ms, b_by = bound(rect_work(xt, yt, rplan), PEAK_FP32_CUDA_CORES)
        rect_paths[name] = {
            "launches": launches["fused_gather_gram_rect"],
            "ms": t["kernel_fp32"], "bf16_ms": t["kernel_bf16"],
            "plain_ms": t["plain"], "bmm_pregathered_ms": t["bmm"],
            "bound_ms": b_ms, "bound_by": b_by,
            "warm_request_s": t.get("warm_request_s")}
        log(f"rect kernel on {name}: {launches['fused_gather_gram_rect']} "
            f"launches, {t['kernel_fp32']:.4f} ms fp32 vs bound "
            f"{b_ms:.4f} ms ({b_by}), share {b_ms / t['kernel_fp32']:.3f}")
    rect_errs = [x2y_skew["errs"], x2y_bal["errs"]] + [
        r["kernel_errs"] for r in blocks["blocks"]]
    main_rect = rect_paths["x2y_skew"]
    kernels.append({
        "name": "fused_gather_gram_rect",
        "route": "cuda",
        "source": "src/repro_torch/csrc/fused_gather_gram_rect.cu",
        "replaces": "src/repro/kernels/pairwise/fused_gather_gram.py:210",
        "launches": main_rect["launches"],
        "max_abs_err": max(e["float32"] for e in rect_errs),
        "ms": main_rect["ms"],
        "plain_ms": main_rect["plain_ms"],
        "bound_ms": main_rect["bound_ms"],
        "bound_by": main_rect["bound_by"],
        "library_ms": None,
        "bmm_pregathered_ms": main_rect["bmm_pregathered_ms"],
        "paths": rect_paths,
    })
    pt = timing_new["pairwise_gram"]["totals"]
    p_ms, p_by = bound(pairwise_work(x, plan), PEAK_FP32_CUDA_CORES)
    log(f"pairwise_gram on the use_kernel=True bucketed path: "
        f"{pgram['launches']['pairwise_gram']} launches, "
        f"{pt['kernel_fp32']:.4f} ms fp32 vs bound {p_ms:.4f} ms ({p_by}), "
        f"share {p_ms / pt['kernel_fp32']:.3f}; torch.bmm {pt['bmm']:.4f} ms")
    kernels.append({
        "name": "pairwise_gram",
        "route": "cuda",
        "source": "src/repro_torch/csrc/pairwise_gram.cu",
        "replaces": "src/repro/kernels/pairwise/pairwise.py:76",
        "launches": pgram["launches"]["pairwise_gram"],
        "max_abs_err": pgram["errs"]["float32"],
        "ms": pt["kernel_fp32"],
        "plain_ms": pt["plain"],
        "bound_ms": p_ms,
        "bound_by": p_by,
        "library_ms": pt["bmm"],
    })
    for rec in blocks["blocks"]:                  # not JSON: plan, tables
        for k in ("plan", "x", "y"):
            rec.pop(k)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({
            "card": card, "build_s": build_s, "plan_s": t_plan,
            "build_plan_s": t_build, "work": work, "errs": errs,
            "end_to_end": e2e, "serving_wall_s": walls, "timing": timing,
            "bound_fp32_ms": bound_ms, "bound_bf16_ms": b16_ms,
            "x2y_host": {k: {"plan_s": c["plan_s"],
                             "build_plan_s": c["build_plan_s"]}
                         for k, c in (("skew", skew), ("balanced", bal))},
            "x2y_skew": x2y_skew, "x2y_serving": x2y_serving,
            "skew_join": join, "x2y_balanced": x2y_bal, "blocks": blocks,
            "pairwise_gram": pgram, "timing_new": timing_new,
            "kernels": kernels,
            "total_s": time.perf_counter() - t_start}, indent=1))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
