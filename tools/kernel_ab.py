"""A/B variants of the port's hand-written kernels on one card.

Builds copies of ``src/repro_torch/csrc`` in which one design constant is
changed (the variants below, each a regex edit of the committed source),
loads each copy's library with ctypes beside the others, and holds every
variant on the same inputs in one process:

* ``ssd``: the bf16 ``ssd_scan`` with each choice of which fp32 operands
  enter their ``mma.sync`` as a bf16 hi + lo pair (``SPLIT_G``, ``SPLIT_W``,
  ``SPLIT_H`` in ``ssd_scan.cu``), with two heads per block on shared B / C
  and with one (``GMAX``), against the plain chunked scan on the
  operands the Jamba prefill hands the kernel (``chip_smoke.py``'s model:
  2 x 4096 and 1 x 32768, bf16, at chip_smoke's rtol 2e-2 / atol 2e-3),
  and on a slowly decaying synthetic 32k input whose state carries across
  many chunks; the error, the share of the tolerance it uses, and the time;
* ``fp32``: what a tensor-core fp32 route would give: the plain chunked
  scan with every product's fp32 operands split into bf16 hi + lo and
  multiplied three times (hi.hi + hi.lo + lo.hi, fp32 accumulation),
  emulated in PyTorch on the operands of the fp32 2048-token prefill,
  against the 2e-4 contract;
* ``gram``: ``pairwise_gram`` and ``fused_gather_gram`` with a 2- and a
  3-stage cp.async ring (``STAGES`` in ``stream_gram.cuh``) on the buckets
  of chip_smoke's m=4096 request, timed in the order A B B A;
* ``rect``: ``fused_gather_gram_rect`` as committed against one design
  constant changed at a time: no tile thinner than 4 (``TMIN``), one 64-row
  tile for sides of 33-64 slots instead of two of 32 (``TMAX``), a 3-stage
  ring, 64-byte chunks (``CB``) and the square kernels' register tiles
  kept where few warps fit on an SM (``MIN_WARPS``), on every bucket of
  chip_smoke's four rect paths (X2Y skew and balanced, the two serving
  blocks), fp32 and bf16, each variant held against the plain version and
  timed A B B A beside the committed one; and ``rect_finished``, the
  committed kernel storing cosine similarities from its epilogue, held
  against the plain version finished in torch and timed against the raw
  store on the buckets it takes (at most 32 wide a side;
  ``rect_on_finished`` is the raw store's time on those).

Run from the repository root on a machine with a card and nvcc::

    python3 tools/kernel_ab.py [--parts ssd,fp32,gram,rect] [--out FILE]

Every number is printed and, with ``--out``, written as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.pairwise import fused_gather_gram as fgg  # noqa: E402
from repro_torch.kernels.pairwise import pairwise as pg  # noqa: E402
from repro_torch.kernels.ssd import ssd as ssd_mod  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT_DIR = ROOT / "build" / "kernel_ab"

# (G, W, H) split or not; each one-rounding variant leaves one of them out
_SPLITS = {"split_all": (1, 1, 1), "split_w_h": (0, 1, 1),
           "split_g_h": (1, 0, 1), "split_g_w": (1, 1, 0),
           "split_h": (0, 0, 1), "split_none": (0, 0, 0)}


def ssd_edits(g: int, w: int, h: int) -> list:
    b = ("false", "true")
    return [(r"constexpr bool SPLIT_G = \w+;", f"constexpr bool SPLIT_G = {b[g]};"),
            (r"constexpr bool SPLIT_W = \w+;", f"constexpr bool SPLIT_W = {b[w]};"),
            (r"constexpr bool SPLIT_H = \w+;", f"constexpr bool SPLIT_H = {b[h]};")]


def stage_edits(n: int) -> list:
    return [(r"constexpr int STAGES = \d+;", f"constexpr int STAGES = {n};")]


# name: (library, the source file edited, its edits)
VARIANTS = {
    **{f"ssd_{k}": ("ssd_scan", "ssd_scan.cu", ssd_edits(*v))
       for k, v in _SPLITS.items()},
    # one head per block where B and C are shared
    **{f"ssd_{k}_g1": ("ssd_scan", "ssd_scan.cu", ssd_edits(*v) + [
        (r"constexpr int GMAX = \d+;", "constexpr int GMAX = 1;")])
       for k, v in _SPLITS.items()},
    **{f"{lib}_stages{n}": (lib, "stream_gram.cuh", stage_edits(n))
       for lib in ("pairwise_gram", "fused_gather_gram") for n in (2, 3)},
    # the rect kernel as committed, then one design constant changed
    "rect": ("fused_gather_gram_rect", "fused_gather_gram_rect.cu", []),
    "rect_tmin4": ("fused_gather_gram_rect", "fused_gather_gram_rect.cu", [
        (r"constexpr int TMIN = 1;", "constexpr int TMIN = 4;")]),
    "rect_tmax64": ("fused_gather_gram_rect", "fused_gather_gram_rect.cu", [
        (r"constexpr int TMAX = 32;", "constexpr int TMAX = 64;")]),
    "rect_stages3": ("fused_gather_gram_rect", "stream_gram.cuh",
                     stage_edits(3)),
    "rect_chunk64": ("fused_gather_gram_rect", "stream_gram.cuh", [
        (r"constexpr int CB = 128;", "constexpr int CB = 64;")]),
    "rect_square_tiles": ("fused_gather_gram_rect",
                          "fused_gather_gram_rect.cu",
                          [(r"constexpr int MIN_WARPS = 16;",
                            "constexpr int MIN_WARPS = 0;")]),
}


def edited_sources(name: str) -> dict:
    """Every csrc file's text for variant ``name``: its one edited file
    with each edit applied exactly once (else RuntimeError), the rest as
    committed."""
    _, edited, edits = VARIANTS[name]
    out = {src.name: src.read_text() for src in CSRC.glob("*.cu*")}
    for pat, rep in edits:
        out[edited], n = re.subn(pat, rep, out[edited])
        if n != 1:
            raise RuntimeError(f"{name}: {pat!r} matched {n} times in "
                               f"{edited}")
    return out


def build_variant(name: str) -> tuple:
    """Build variant ``name`` from its own copy of csrc; returns (name,
    CDLL, ptxas entries)."""
    lib = VARIANTS[name][0]
    d = OUT_DIR / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for fname, text in edited_sources(name).items():
        (d / fname).write_text(text)
    so = d / f"lib{lib}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                           str(d / f"{lib}.cu")], capture_output=True,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr[-4000:]}")
    entries = cs.ptxas_entries(proc.stdout + proc.stderr)
    return name, ctypes.CDLL(str(so)), entries


def entry(libs: dict, name: str, argtypes: list):
    fn = getattr(libs[name], f"{VARIANTS[name][0]}_launch")
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def checked(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: launch returned cudaError_t {err}")


# ------------------------------------------------------------------ ssd

def ssd_call(fn, args, out) -> None:
    x, la, b, c = args
    B, S, H, P = x.shape
    N = b.shape[3]
    la = la.float()
    strides = (ctypes.c_longlong * 15)(
        *x.stride()[:3], *la.stride(), *b.stride()[:3], *c.stride()[:3],
        *out.stride()[:3])
    checked(fn(x.data_ptr(), la.data_ptr(), b.data_ptr(), c.data_ptr(),
               out.data_ptr(), int(x.dtype == torch.bfloat16),
               ctypes.addressof(strides), B, S, H, N, P, cs.LM_CHUNK,
               torch.cuda.current_stream().cuda_stream), "ssd_scan")


def tol_use(got, want, tol) -> dict:
    """Max abs error, the plain value there, and the largest share of the
    tolerance |got - want| / (atol + rtol |want|) (<= 1 passes)."""
    err = (got.float() - want).abs()
    use = err / (tol["atol"] + tol["rtol"] * want.abs())
    k = int(err.argmax())
    return {"max_abs_err": float(err.max()),
            "plain_at_max_err": float(want.flatten()[k]),
            "tol_use": float(use.max()),
            "mean_abs_out": float(want.abs().mean())}


def merge(a: dict, b: dict) -> dict:
    if not a:
        return b
    out = {k: max(a[k], b[k]) for k in ("max_abs_err", "tol_use",
                                        "mean_abs_out")}
    out["plain_at_max_err"] = (a if a["max_abs_err"] >= b["max_abs_err"]
                               else b)["plain_at_max_err"]
    return out


def ssd_variants_on(calls, names, libs, label, iters) -> dict:
    """Each variant on every captured (x, la, b, c) against the plain
    chunked scan: worst error over the calls, and time per input set."""
    res = {n: {"err": {}, "ms": 0.0} for n in names}
    fns = {n: entry(libs, n, ssd_mod._ARGS) for n in names}
    for args in calls:
        want = cs.lm_plain("ssd_scan", args, {"chunk": cs.LM_CHUNK}).float()
        out = torch.empty(args[0].shape, dtype=args[0].dtype,
                          device=args[0].device)
        for n in names:
            cs.log(f"{label}: {n}")
            ssd_call(fns[n], args, out)
            torch.cuda.synchronize()
            res[n]["err"] = merge(res[n]["err"],
                                  tol_use(out, want, cs.LM_BF16))
        # A B .. B A, so drift over the run falls on every variant alike
        for n in names + names[::-1]:
            res[n]["ms"] += cs.time_cuda(
                lambda: ssd_call(fns[n], args, out), iters, warmup=1) / 2
        del want, out
    for n in names:
        e = res[n]["err"]
        res[n]["passes"] = e["tol_use"] <= 1.0
        cs.log(f"{label} {n}: max_abs_err {e['max_abs_err']:.3e} at a plain "
               f"value of {e['plain_at_max_err']:.4g} (mean |y| "
               f"{e['mean_abs_out']:.3e}), tolerance use {e['tol_use']:.3f}"
               f" ({'passes' if res[n]['passes'] else 'FAILS'}); "
               f"{res[n]['ms']:.3f} ms over {len(calls)} launch(es)")
    return res


def capture_ssd(model, tok) -> list:
    with cs.capture_lm_kernels() as calls:
        logits, _, _ = model({"tokens": tok})
        torch.cuda.synchronize()
    del logits
    return [args for args, _, _ in calls["ssd_scan"]]


def part_ssd(libs) -> dict:
    names = [f"ssd_{k}{g}" for k in _SPLITS for g in ("", "_g1")]
    out = {}
    model, _ = cs.lm_model("bfloat16")
    calls = capture_ssd(model, cs.lm_tokens(2, cs.LM_S_BF16))
    out["prefill_2x4096"] = ssd_variants_on(calls, names, libs,
                                            "ssd bf16 prefill 2x4096", 5)
    del calls
    calls = capture_ssd(model, cs.lm_tokens(1, cs.LM_S_LONG))
    del model
    cs.free_cuda()
    out["prefill_1x32768"] = ssd_variants_on(calls, names, libs,
                                             "ssd bf16 prefill 1x32768", 2)
    del calls
    cs.free_cuda()
    # slow decay: exp(-2e-4 |N(0,1)|) per step, about 0.98 per chunk, so
    # the state carries over some fifty chunks
    rng = np.random.default_rng(32)
    B, S, H, P, N = 1, cs.LM_S_LONG, 8, 64, 128
    dev = torch.device("cuda")
    x = torch.from_numpy(rng.normal(size=(B, S, H, P)).astype(np.float32))
    bc = torch.from_numpy(rng.normal(size=(2, B, S, 1, N)).astype(
        np.float32)) * N ** -0.5
    la = -torch.from_numpy(np.abs(rng.normal(size=(B, S, H))).astype(
        np.float32)) * 2e-4
    x = x.to(dev, torch.bfloat16)
    b, c = (t.to(dev, torch.bfloat16).expand(B, S, H, N) for t in bc)
    out["slow_decay_1x32768"] = ssd_variants_on(
        [(x, la.to(dev), b, c)], names, libs, "ssd bf16 slow decay 1x32768",
        2)
    return out


# ------------------------------------------------------------------ fp32

def _mm3(a, b):
    """a @ b with each fp32 operand split into bf16 hi + lo and multiplied
    hi.hi + hi.lo + lo.hi in fp32 (bf16 products are exact in fp32)."""
    def split(t):
        hi = t.bfloat16().float()
        return hi, (t - hi).bfloat16().float()
    ah, al = split(a)
    bh, bl = split(b)
    return ah @ bh + ah @ bl + al @ bh


def chunked_split3(x, log_a, b, c, chunk):
    """ssd_scan_chunked (one head per leading index) with every product
    through _mm3."""
    S, P = x.shape[-2:]
    N = b.shape[-1]
    lead = x.shape[:-2]
    Q = min(chunk, S)
    pad = -S % Q
    xf, bf, cf, laf = x.float(), b.float(), c.float(), log_a.float()
    if pad:
        xf, bf, cf = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                      for t in (xf, bf, cf))
        laf = torch.nn.functional.pad(laf, (0, pad))
    nc = xf.shape[-2] // Q
    xc = xf.reshape(*lead, nc, Q, P)
    bcq = bf.reshape(*lead, nc, Q, N)
    ccq = cf.reshape(*lead, nc, Q, N)
    lac = torch.cumsum(laf.reshape(*lead, nc, Q, 1), dim=-2)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    h = torch.zeros((*lead, N, P), dtype=torch.float32, device=x.device)
    ys = []
    with fgg.ieee_fp32():
        for i in range(nc):
            xq, bq, cq, la = (xc[..., i, :, :], bcq[..., i, :, :],
                              ccq[..., i, :, :], lac[..., i, :, :])
            decay = torch.exp(la - la.transpose(-1, -2))
            g = torch.where(tri, _mm3(cq, bq.transpose(-1, -2)) * decay, 0.0)
            ys.append(_mm3(g, xq) + torch.exp(la) * _mm3(cq, h))
            la_end = la[..., -1:, :]
            h = torch.exp(la_end) * h + _mm3(
                (bq * torch.exp(la_end - la)).transpose(-1, -2), xq)
    y = torch.stack(ys, dim=-3).reshape(*lead, nc * Q, P)
    return y[..., :S, :].to(x.dtype)


def part_fp32() -> dict:
    model, _ = cs.lm_model("float32")
    calls = capture_ssd(model, cs.lm_tokens(1, cs.LM_S_FP32))
    del model
    cs.free_cuda()
    err = {}
    for x, la, b, c in calls:
        want = cs.lm_plain("ssd_scan", (x, la, b, c), {"chunk": cs.LM_CHUNK})
        t = (lambda u: u.transpose(1, 2))
        got = chunked_split3(t(x), t(la), t(b), t(c), cs.LM_CHUNK)
        err = merge(err, tol_use(t(got), want.float(), cs.LM_FP32))
        del want, got
    cs.log(f"fp32 ssd, 3-product bf16 split emulated, prefill 1x"
           f"{cs.LM_S_FP32}: max_abs_err {err['max_abs_err']:.3e} at a "
           f"plain value of {err['plain_at_max_err']:.4g} (mean |y| "
           f"{err['mean_abs_out']:.3e}), use of the 2e-4 tolerance "
           f"{err['tol_use']:.3f}")
    del calls
    cs.free_cuda()
    return {"prefill_1x2048": err}


# ------------------------------------------------------------------ gram

def part_gram(libs) -> dict:
    from repro_torch.mapreduce.allpairs import _plan_for
    from repro_torch.mapreduce.engine import bucket_arrays
    w, xn = cs.bench_profile(cs.M, cs.D, cs.SEED)
    plan = _plan_for(cs.plan_a2a(w, cs.Q), pad_reducers_to=1,
                     pad_slots_to=1)
    x = torch.from_numpy(xn).cuda()
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        xt = x.to(dtype)
        key = str(dtype).split(".")[1]
        tot = {}
        for b, (idx, mask, _) in zip(plan.buckets,
                                     bucket_arrays(plan, x.device)):
            m8 = mask.view(torch.uint8)
            g = fgg.gather_rows(xt, idx, mask).contiguous()
            out = torch.empty((b.R, b.width, b.width), device="cuda")
            want = fgg.fused_gather_gram_ref(xt, idx, mask)
            calls = {}
            for n in (2, 3):
                f = entry(libs, f"fused_gather_gram_stages{n}",
                          fgg._SQUARE_ARGS)
                p = entry(libs, f"pairwise_gram_stages{n}", pg._ARGS)
                calls[f"fused_gather_gram_stages{n}"] = (
                    lambda f=f: checked(f(
                        xt.data_ptr(), int(dtype == torch.bfloat16),
                        idx.data_ptr(), m8.data_ptr(), out.data_ptr(), b.R,
                        b.width, xt.shape[1], xt.shape[0],
                        fgg.METRICS[None], stream), "fgg"))
                calls[f"pairwise_gram_stages{n}"] = (
                    lambda p=p: checked(p(
                        g.data_ptr(), None, int(dtype == torch.bfloat16),
                        out.data_ptr(), b.R, b.width, b.width, g.shape[2], 1,
                        stream), "pairwise_gram"))
            row = dict.fromkeys(calls, 0.0)
            for name, fn in calls.items():
                fn()
                torch.cuda.synchronize()
                torch.testing.assert_close(
                    out, want, **(cs.FP32 if dtype == torch.float32
                                  else cs.BF16))
            names = list(calls)
            for name in names + names[::-1]:
                row[name] += cs.time_cuda(calls[name], 20) / 2
            for k, v in row.items():
                tot[k] = tot.get(k, 0.0) + v
            cs.log(f"gram {key} bucket width {b.width}: " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in row.items()))
            res[f"{key}_width_{b.width}"] = row
            del g, out, want
        cs.log(f"gram {key} request: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in tot.items()))
        res[f"{key}_request"] = tot
    return res


# ------------------------------------------------------------------ rect

def rect_paths() -> list:
    """(path, x, y, plan) of chip_smoke's four rect paths: X2Y skew and
    balanced, and the two serving blocks of the m=100,000 table."""
    from repro_torch.mapreduce.engine import block_subplan
    out = []
    for kind in ("skew", "balanced"):
        case = cs.x2y_host(kind)
        out.append((f"x2y_{kind}", case["x"], case["y"], case["plan"]))
    w, xn = cs.block_profile(cs.M_BLOCK)
    svc = cs.PairwiseService(q=cs.Q_BLOCK, executor="fused", metric="dot")
    svc.load_block_table(xn, w)
    x = svc._block_table
    for i0, i1, j0, j1 in cs.BLOCKS:
        out.append((f"block_{i0}_{j0}", x[i0:i1], x[j0:j1],
                    block_subplan(svc._block_sparse, i0, i1, j0, j1)))
    return out


def part_rect(libs) -> dict:
    """Each rect variant against the committed kernel, bucket by bucket of
    the four paths, in fp32 and bf16: the plain version's check, then A B
    B A times (ms per launch) summed per path."""
    from repro_torch.mapreduce.engine import rect_bucket_arrays
    others = [n for n in VARIANTS if n.startswith("rect_")]
    fns = {n: entry(libs, n, fgg._RECT_ARGS) for n in ["rect", *others]}
    cosine = fgg.METRICS["cosine"]
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for path, x, y, plan in rect_paths():
        for dtype in (torch.float32, torch.bfloat16):
            xt, yt = x.to(dtype), y.to(dtype)
            key = f"{path}_{str(dtype).split('.')[1]}"
            tot = {}
            n2 = fgg.rect_table_norms(xt, yt, "cosine")
            for b, arr in zip(plan.buckets, rect_bucket_arrays(plan,
                                                               x.device)):
                xi, xm, yi, ym = arr[:4]
                out = torch.empty((b.R, b.width, b.ywidth), device="cuda")
                want = fgg.fused_gather_gram_rect_ref(xt, yt, xi, xm, yi, ym)

                def args(o, metric=0, norms=(None, None)):
                    return (xt.data_ptr(), yt.data_ptr(),
                            int(dtype == torch.bfloat16), xi.data_ptr(),
                            xm.view(torch.uint8).data_ptr(), yi.data_ptr(),
                            ym.view(torch.uint8).data_ptr(), o.data_ptr(),
                            b.R, b.width, b.ywidth, xt.shape[1],
                            xt.shape[0], yt.shape[0], metric,
                            *(n.data_ptr() if n is not None else None
                              for n in norms), stream)
                raw = args(out)
                calls = {
                    n: (lambda f=f, n=n: checked(f(*raw), f"rect {n}"))
                    for n, f in fns.items()}
                checks = {n: (out, want) for n in calls}
                timed = list(others)
                if max(b.width, b.ywidth) <= fgg.FINISH_MAX_WIDTH:
                    fin_out = torch.empty_like(out)
                    fin = args(fin_out, cosine, n2)
                    calls["rect_finished"] = lambda fin=fin: checked(
                        fns["rect"](*fin), "rect finished")
                    checks["rect_finished"] = (
                        fin_out, fgg.finish_rect_blocks(want, xi, xm, yi, ym,
                                                        *n2, "cosine"))
                    timed.append("rect_finished")
                for name, fn in calls.items():
                    got, ref = checks[name]
                    got.fill_(float("nan"))
                    fn()
                    torch.cuda.synchronize()
                    torch.testing.assert_close(
                        got, ref, **(cs.FP32 if dtype == torch.float32
                                     else cs.BF16),
                        msg=lambda m: f"{name} {key} {b.width}x{b.ywidth}: "
                                      f"{m}")
                row = {}
                for other in timed:
                    for name in ("rect", other, other, "rect"):
                        row.setdefault(name, 0.0)
                        row[name] += cs.time_cuda(calls[name], 10) / (
                            2 * len(timed) if name == "rect" else 2)
                if "rect_finished" in row:
                    row["rect_on_finished"] = row["rect"]
                for k, v in row.items():
                    tot[k] = tot.get(k, 0.0) + v
                cs.log(f"rect {key} bucket {b.width}x{b.ywidth} R={b.R}: "
                       + ", ".join(f"{k} {v:.4f} ms" for k, v in row.items()))
                del out, want, checks
            cs.log(f"rect {key} request: " + ", ".join(
                f"{k} {v:.4f} ms ({v / tot['rect']:.3f})"
                for k, v in tot.items()))
            if "rect_finished" in tot:
                cs.log(f"rect {key} finished / raw on the buckets the "
                       f"epilogue takes: {tot['rect_finished']:.4f} / "
                       f"{tot['rect_on_finished']:.4f} ms")
            res[key] = tot
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parts", default="ssd,fp32,gram,rect")
    ap.add_argument("--out", help="also write every number here (JSON)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    parts = args.parts.split(",")
    card = cs.phase_device()
    names = [n for n in VARIANTS
             if ("ssd" in parts and n.startswith("ssd_"))
             or ("rect" in parts and n.startswith("rect"))
             or ("gram" in parts
                 and n.startswith(("pairwise_gram_", "fused_gather_gram_")))]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        built = list(pool.map(build_variant, names))
    libs = {n: lib for n, lib, _ in built}
    result = {"card": card["smi"], "ptxas": {}}
    cs.log(f"built {len(names)} variants in {time.perf_counter() - t0:.1f} s")
    for n, _, entries in built:
        result["ptxas"][n] = entries
        regs = sorted({e["registers"] for e in entries})
        spills = sorted({(e["spill_stores"], e["spill_loads"])
                         for e in entries
                         if e["spill_stores"] or e["spill_loads"]})
        cs.log(f"  {n}: registers {regs}, spills {spills or 'none'}")
    if "ssd" in parts:
        result["ssd"] = part_ssd(libs)
    if "fp32" in parts:
        result["fp32"] = part_fp32()
    if "gram" in parts:
        result["gram"] = part_gram(libs)
    if "rect" in parts:
        result["rect"] = part_rect(libs)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
