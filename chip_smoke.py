#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``).

Drives the port's main path — all-pairs similarity through a mapping schema,
the fused executor with the hand-written ``fused_gather_gram`` kernel — on
one NVIDIA card at the repository's benchmark profile at full size (m=4096
inputs, d=256 features, Zipf a=1.6 sizes, q=1.0, seed 0), and checks every
kernel against its plain PyTorch version.  Run from the repository root:

    python3 chip_smoke.py [--out results.json]

Phases: 1 device, 2 kernel build (nvcc, sm_90a), 3 kernel vs plain on every
bucket of the full plan plus edge cases, 4 end to end (fused vs bucketed;
dense/bucketed/fused at m=512, d=64), 5 serving (PairwiseService, four
requests), 6 timing (CUDA events).  Any failed check raises, so the exit
code is non-zero; without a CUDA device it exits 2 before printing any
result.  The last two lines are the ``kernels`` JSON record and the device
JSON record.
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

from repro_torch.core import plan_a2a  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.pairwise import fused_gather_gram as fgg  # noqa: E402
from repro_torch.mapreduce import pairwise_similarity  # noqa: E402
from repro_torch.mapreduce.allpairs import _plan_for  # noqa: E402
from repro_torch.mapreduce.engine import bucket_arrays  # noqa: E402
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


def phase_build() -> float:
    t0 = time.perf_counter()
    _build.build("fused_gather_gram", force=True)
    dt = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.build_log("fused_gather_gram")
             .splitlines() if "registers" in ln or "spill" in ln]
    log(f"phase 2 build: nvcc sm_90a in {dt:.2f} s; ptxas lines "
        f"(spills, then registers/smem per instantiation):")
    for ln in ptxas:
        log(f"  {ln}")
    return dt


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


def profile_request(x, schema) -> dict:
    """Device time of one warm request by kernel (torch.profiler), and the
    device's idle share of that request's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pairwise_similarity(x, q=Q, schema=schema, metric="cosine",
                            executor="fused")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies, memsets): the CPU-side ops
    # that launched them carry the same device time again
    by_name = {e.key: e.self_device_time_total / 1e3
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA}
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"phase 6 profile of one warm request: device busy {busy_ms:.3f} ms "
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
    tot.update(profile_request(x, schema))
    log(f"phase 6 totals over {len(plan.buckets)} buckets: kernel fp32 "
        f"{tot['kernel_fp32']:.4f} ms, bf16 {tot['kernel_bf16']:.4f} ms; "
        f"plain {tot['plain']:.4f} ms; bmm yardstick {tot['bmm']:.4f} ms; "
        f"warm request (plan cached) median {tot['warm_request_s']:.4f} s")
    return {"buckets": rows, "totals": tot}


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
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({
            "card": card, "build_s": build_s, "plan_s": t_plan,
            "build_plan_s": t_build, "work": work, "errs": errs,
            "end_to_end": e2e, "serving_wall_s": walls, "timing": timing,
            "bound_fp32_ms": bound_ms, "bound_bf16_ms": b16_ms,
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
