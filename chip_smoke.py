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
  ``pairwise_gram`` (phase 10);
* some-pairs similarity, ``PairwiseService(executor='fused').some_pairs``
  -> ``fused_gather_gram`` (one launch per bucket, nothing else): the main
  path's table, with the pairs that ``examples/some_pairs.py``'s blocker
  keeps (a 4-hyperplane sign signature, ~1/16 of all pairs; phase 16);
* streaming A2A, ``PairwiseService(executor='streaming', use_kernel=True)``
  on the main path's table with ``benchmarks/bench_stream.py``'s planner
  thresholds: ``load_table`` -> ``fused_gather_gram`` (cold build) and
  ``pairwise_gram`` (the warmed delta shapes), then 48 seeded edits (16
  each of ``add_input`` / ``remove_input`` / ``update_weight``), each
  executed delta -> ``pairwise_gram`` once per bucket of its dirty sub-plan
  (phase 17);
* streaming X2Y, ``StreamingExecutor.run_x2y`` on an
  ``IncrementalX2YPlanner`` over the skew profile (8192 x 512) ->
  ``fused_gather_gram_rect`` (cold build), then 16 seeded edits, whose
  deltas reach no hand-written kernel (their reducer is a torch product,
  as in the reference; phase 18);
* sharded execution over an in-process NCCL group of one rank: A2A on the
  main path's table through ``pairwise_similarity(executor='sharded',
  mesh=group)`` and ``PairwiseService`` -> ``fused_gather_gram`` once per
  stacked width group; X2Y on the skew profile -> ``fused_gather_gram_rect``
  once per (wx, wy) group (phase 19);
* sharded and coded execution on 4 gloo ranks spawned on the one card
  (the collectives on host tensors, the kernels on the card): sharded A2A
  -> ``fused_gather_gram`` on an m=2048 table of the main path's
  profile, coded (r=2) A2A -> ``fused_gather_gram_rect`` (one table as
  both sides) on an m=1024 one, sharded X2Y on the skew profile ->
  ``fused_gather_gram_rect``;
  every rank's matrices against this process's fused ones, the coded
  ledger against the all-to-all's bytes, and no rank running nvcc
  (phase 20);
* ``mesh=`` on the single-program executors and the engine's dry run
  (phase 21): on an in-process NCCL group of one rank, dense and bucketed
  (``use_kernel=True`` -> ``pairwise_gram``) and fused (->
  ``fused_gather_gram``) on the main path's table, each matrix against
  ``mesh=None`` and each launch against its plain version; on phase 20's
  4 gloo ranks, fused A2A at m=2048 and the streaming service
  (``load_table`` and 4 edits; ``fused_gather_gram`` cold,
  ``pairwise_gram`` per delta bucket) over the group against this
  process's one-device matrices; then ``repro_torch.launch.dryrun_engine``
  at the reference's defaults (m=1024, d=2048, q=32, with and without
  Zipf sizes, bf16 tables): its stages on the one-rank group, the coded
  frontier on the 4 gloo ranks (S=4, cut from the reference's 16), every
  row printed as the reference prints it plus device ms and peak
  allocation; the bucketed path's peak allocation must exceed the fused
  path's by the largest gathered block less the fused path's fp32 blocks,
  the coded measured bytes must equal the model on every rank, and the
  planner-vs-naive comm ratio the plans';
* LM serving on jamba-1.5-large-398b at its published widths with the
  depth cut to 3 layers (attention + dense FFN, Mamba + MoE, Mamba +
  dense; 12.37 B parameters made on the card from seed 0): the prefill ->
  ``flash_attention`` (one launch) and ``ssd_scan`` (one per Mamba layer),
  in fp32 against the non-kernel route at B=1, S=2048 (phase 12), in bf16
  at B=2, S=4096 with each kernel against its plain version on the
  prefill's own operands and timed beside SDPA (phase 13), and at the
  prefill_32k length with the batch cut to 1, again against the plain
  versions (flash on three heads; phase 14); decode through
  ``BatchedServer`` (4 slots, 8 requests; phase 15), which reaches no
  kernel;
* LM training (phase 22), through the non-kernel route the reference
  trains on (neither kernel has a backward): (a) one fp32
  ``make_train_step`` step of jamba-1.5-large-398b-smoke (attention,
  Mamba, MoE; ``remat='full'``, microbatch 2) on the card against the CPU
  from the same weights: loss, grad norm, every parameter and moment; (b)
  ``stablelm-1.6b`` whole (24 layers, d_model 2048, 1.44 B parameters,
  random weights from seed 0) trained for 20 steps on
  ``PackedLMDataset`` batches of 4 x 2048 through
  ``repro_torch.launch.train_lm.Trainer`` (bf16, fp32 moments, remat
  'full'), checkpointed at step 10 and resumed in a fresh trainer: every
  loss and grad norm finite, the loss falling, no kernel launched, the
  restored weights, moments, step and data cursor equal to the saved ones
  bit for bit and the next batch the same; step ms, tokens/s, peak
  allocation and the model FLOP share of the card's bf16 peak printed;
  (c) both LM kernel wrappers, and the loss on the kernel route, refuse
  autograd on the card;
* the encoder, cross-attention and the frontend stubs (phase 23), bf16,
  weights from seed 0: (a) ``whisper-large-v3`` whole (32 encoder and 32
  decoder layers, 1.6 B parameters): the prefill of 4 x 448 decoder
  tokens over 4 x 1500 precomputed audio frame embeddings ->
  ``flash_attention`` once per decoder layer (the encoder and
  cross-attention stay on plain attention, as in the reference), each
  launch against its plain version and timed beside SDPA, the logits
  against ``use_pallas=False``'s; the encoder alone; then a 432-token
  prompt prefilled into a cache and 16 greedy ``decode_step`` ticks on
  the precomputed ``enc_out``, held against the teacher-forced forward
  over the prompt and the generated tokens; (b) ``internvl2-26b`` at full
  width, all 48 layers (19.3 B parameters): 256 image embeds prepended to
  2 x 1792 text tokens (a 2048-token causal prefill, GQA 48 / 8) ->
  ``flash_attention`` once per layer, checked as in (a), then the image
  and 1776 tokens prefilled into a cache and 16 greedy ticks against
  teacher forcing; (c) ``whisper-large-v3-smoke`` and
  ``internvl2-26b-smoke`` in fp32, card against CPU from the same
  weights: prefill and decode logits and one train step with the
  frontend's embeddings in the batch;
* the LM stack on a ``torch.distributed`` DeviceMesh (phase 24): (a) 4
  gloo ranks on the card answer whether gloo takes CUDA tensors for the
  four collectives DTensor issues; (b) jamba cut to 3 layers, bf16, 2 x
  4096, on a 2 x 2 ('data', 'model') gloo mesh if it does, else on a
  one-rank NCCL mesh: every flash and SSD launch on each rank's LOCAL
  heads (through ``local_map``) against its plain version, the gathered
  logits against the one-rank prefill's, collective bytes and calls by
  kind; (c) stablelm-1.6b whole, 5 train steps with the reference's
  train flags (ZeRO-1) against 5 steps with no mesh (loss within 1e-2),
  every moment's local shard as its placement says, and one fp32 FSDP
  step of jamba- and gemma3-smoke against one rank's; (d) GPipe of
  stablelm-1.6b's 24 layers as 4 stages of 6 on 4 gloo ranks on the card
  (activations through the host), 8 microbatches of 1 x 2048, against
  the sequential stack; (e) the LM dry run (fake backend, meta tensors)
  in a subprocess: one cell per kind on the pod and multi-pod meshes and
  jamba train_4k on the multi-pod one, each status the reference's
  ``shape_applicable``'s, each row with its per-device peak bytes; (f)
  the dry run's memory count held on the card: four witnesses (stablelm
  train and decode, jamba cut to 3 layers prefill, mamba2-370m cut to 4
  layers train on the per-position SSD loop) counted on meta in (e)'s
  subprocess on a fake 1 x 1 mesh, then run on the card on a one-rank
  NCCL mesh with the same flags, the counter on the card's own tensors
  beside ``torch.cuda.max_memory_allocated``'s high-water above the
  arguments (within 5%); (g) on the same one-rank NCCL mesh, size-1
  tensor dims named on its size-1 axes (``Replicate()`` there):
  granite-34b at its published widths cut to 2 layers (its one KV head on
  'model'), bf16 prefill 1 x 2048 -> ``flash_attention`` on the local
  heads (G = 48, each launch against its plain version) and 4 decode
  ticks, the logits against ``mesh=None``'s by (b)'s rule, then
  stablelm-1.6b whole, one bf16 step at global batch 1 x 2048 against the
  same step with no mesh.  ``tools/nccl_ranks.py --lm`` runs (b)-(c) on
  a 2 x 2 NCCL mesh of 4 cards.

Phase 1 reads the device, phase 2 builds the five kernels (one nvcc per
source, all started together) and prints ptxas's registers, shared memory
and spills of the tensor-core flash kernel, the SSD kernels and the
instantiations of ``pairwise_gram``, ``fused_gather_gram`` and
``fused_gather_gram_rect``, phase 6 times ``fused_gather_gram`` per bucket
beside ``torch.bmm``, its bound and the table bytes its gather streams from
L2, phase 11 times the rectangular kernel per bucket of its four paths (X2Y
skew and balanced, the two blocks) and ``pairwise_gram`` per bucket, each
beside ``torch.bmm`` on the pre-gathered blocks and its bound, the rect
kernel also beside the table bytes its gather stages (modelled from the
plan), and the summary sets ``fused_gather_gram`` beside ``pairwise_gram``
per bucket.  Phases 16-18 run after phase 11 and before the LM phases:
they time the some-pairs kernel and every edit (planner and patch), hold
every kernel launch against its plain version and every matrix against
x·xᵀ / x·yᵀ, and check that the first edit after a warmed ``load_table``
builds no library and brings no new table signature.  Phases 19-20 follow
them: kernel ms per stacked group of each rank's slice, host seconds of
the partition, stacking and maps (``_coded_maps`` included), collective ms
per rank, the coded path's local fraction and the balance factor; phase 21
follows phase 20 (its gloo part runs in phase 20's spawn).  Flash
is timed beside SDPA in the same call; flash and SSD with their ms per
launch, share of bound and achieved TFLOP/s.
Any failed check raises, so the exit code is non-zero; without a CUDA
device it exits 2 before printing any result.  The last two lines are the
``kernels`` JSON record and the device JSON record.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import gc
import json
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import compat  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (  # noqa: E402
    plan_a2a,
    plan_some_pairs,
    plan_x2y,
)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash.flash_attention import (  # noqa: E402
    flash_attention_heads,
)
from repro_torch.kernels.flash.ref import mha_ref  # noqa: E402
from repro_torch.kernels.pairwise import fused_gather_gram as fgg  # noqa: E402
from repro_torch.kernels.pairwise import pairwise as pg  # noqa: E402
from repro_torch.mapreduce import (  # noqa: E402
    build_plan,
    make_executor,
    pairwise_similarity,
    skew_join,
    table_signatures,
    x2y_similarity,
)
from repro_torch.mapreduce.allpairs import (  # noqa: E402
    _block_fn_x2y,
    _plan_for,
    _x2y_plan_for,
)
from repro_torch.mapreduce import executors as port_ex  # noqa: E402
from repro_torch.mapreduce.assembly import rect_launch_plan  # noqa: E402
from repro_torch.mapreduce.engine import (  # noqa: E402
    block_subplan,
    bucket_arrays,
    rect_bucket_arrays,
)
from repro_torch.obs import LEDGER, REGISTRY  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.launch import dryrun_engine as dryrun  # noqa: E402
from repro_torch.launch.op_analysis import OpCounter  # noqa: E402
from repro_torch.launch.roofline import (  # noqa: E402
    HW,
    PEAK_BF16_TENSOR,
    PEAK_FP32_CUDA_CORES,
    bound,
    bucket_work,
    pairwise_bucket_work,
    pairwise_work,
    rect_bucket_work,
    rect_work,
    work_model,
)
from repro_torch.kernels.ssd.ref import ssd_scan_chunked  # noqa: E402
from repro_torch.kernels.ssd.ssd import ssd_scan_heads  # noqa: E402
from repro_torch.data import PackedLMDataset  # noqa: E402
from repro_torch.launch.train_lm import Trainer, train  # noqa: E402
from repro_torch.models import RuntimeFlags, build_model  # noqa: E402
from repro_torch.models import blocks as model_blocks  # noqa: E402
from repro_torch.train import (  # noqa: E402
    AdamWConfig,
    init_state,
    make_train_step,
    state_to_reference,
)
from repro_torch.serve import (  # noqa: E402
    BatchedServer,
    PairwiseService,
    Request,
)
from repro_torch.stream import (  # noqa: E402
    IncrementalX2YPlanner,
    StreamingExecutor,
)

M, D, Q, ZIPF_A, SEED = 4096, 256, 1.0, 1.6, 0
# fp32: kernel and torch.bmm sum d=256 products in different orders, which
# moves a result by a few ulps of the largest partial sum (|x_i·x_j| ~ 256
# for N(0,1) rows): rtol 1e-5 / atol 1e-4.  A TF32 product (10-bit mantissa)
# is off by ~1e-1 here and fails it.  bf16 tables at 2e-2, as in the
# reference.
FP32 = dict(rtol=1e-5, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)
# LM serving: jamba-1.5-large-398b at full width, depth cut to 3 layers.
# fp32 prefill kernels are held at the reference's own kernel tolerance
# (tests/test_kernels.py), 2e-4.  In bf16 a kernel and its plain version
# both work in fp32 and round the result once, so they differ by at most
# one bf16 step (2^-8 = 3.9e-3 of the output), plus ~2^-9 of it where the
# flash tensor-core kernel rounds P to bf16: rtol 2e-2 covers that at any
# size and atol 2e-3 the outputs near zero.  The tolerance follows the
# output's size: late rows of a long causal layer have |o| ~ 0.03, where
# the reference's 3e-2 could not fail a wrong row.
LM_ARCH, LM_LAYERS, LM_CHUNK = "jamba-1.5-large-398b", 3, 128
LM_S_FP32, LM_S_BF16, LM_S_LONG = 2048, 4096, 32768
LM_FP32 = dict(rtol=2e-4, atol=2e-4)
LM_BF16 = dict(rtol=2e-2, atol=2e-3)
LM_LONG_HEADS = (0, 31, 63)   # flash heads checked at 32k (KV heads 0, 3, 7)
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


KERNELS = ("fused_gather_gram", "fused_gather_gram_rect", "pairwise_gram",
           "flash_attention", "ssd_scan")


# the redesigned kernels' entry functions, by library: their -Xptxas -v
# lines are printed one by one
PTXAS_ENTRIES = {"flash_attention": "flash_wgmma_kernel",
                 "pairwise_gram": "pairwise_gram_kernel",
                 "fused_gather_gram": "fused_gather_gram_kernel",
                 "fused_gather_gram_rect": "fused_gather_gram_rect_kernel",
                 "ssd_scan": "ssd_scan_"}


def entry_label(entry: str, key: str) -> str:
    """A readable name of a mangled kernel entry from ``key`` on: the Gram
    kernels' template arguments spelled out (``<f32, 32, 2, 1, 1>``: input
    type, then the tile and register-tile widths), else the mangled
    tail."""
    tail = entry[entry.index(key):]
    m = re.match(re.escape(key) + r"I(f|13__nv_bfloat16)((?:Li\d+E)+)E",
                 tail)
    if not m:
        return tail
    args = ["f32" if m.group(1) == "f" else "bf16",
            *re.findall(r"Li(\d+)E", m.group(2))]
    return f"{key}<{', '.join(args)}>"


def ptxas_entries(log_text: str) -> list:
    """Per entry function of one ``-Xptxas -v`` log: registers, static
    shared memory, stack frame and spill bytes."""
    out, cur = [], None
    for ln in log_text.splitlines():
        if "Compiling entry function" in ln:
            cur = {"entry": ln.split("'")[1], "registers": None,
                   "smem": 0, "stack": 0, "spill_stores": 0,
                   "spill_loads": 0}
            out.append(cur)
        elif cur is not None and "bytes stack frame" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split()
                    if w.isdigit()]
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = nums[:3]
        elif cur is not None and "Used " in ln and "registers" in ln:
            cur["registers"] = int(ln.split("Used ")[1].split()[0])
            if "bytes smem" in ln:
                cur["smem"] = int(ln.split(" bytes smem")[0].split()[-1])
    return out


def phase_build() -> dict:
    t0 = time.perf_counter()
    each = _build.build_all(KERNELS, force=True)
    dt = time.perf_counter() - t0
    log(f"phase 2 build: {len(KERNELS)} nvcc sm_90a builds in parallel, "
        f"{dt:.2f} s wall ("
        f"{', '.join(f'{k} {v:.2f} s' for k, v in each.items())})")
    ptxas = {}
    for name in KERNELS:
        entries = ptxas_entries(_build.build_log(name))
        regs = sorted({e["registers"] for e in entries})
        spills = sorted({(e["spill_stores"], e["spill_loads"])
                         for e in entries if e["spill_stores"]
                         or e["spill_loads"]})
        log(f"  {name}: {len(entries)} instantiations, registers {regs}; "
            f"non-zero spills (stores, loads): {spills or 'none'}")
        key = PTXAS_ENTRIES.get(name)
        ptxas[name] = [e for e in entries if key and key in e["entry"]]
        for e in ptxas[name]:
            log(f"    {entry_label(e['entry'], key)}: "
                f"{e['registers']} registers, "
                f"static smem {e['smem']} B, stack {e['stack']} B, spills "
                f"{e['spill_stores']} / {e['spill_loads']} B")
    return {"wall_s": dt, "each_s": each, "ptxas": ptxas}


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
        try:
            torch.testing.assert_close(res["fused"].cpu(), cpu, **FP32)
        except AssertionError:
            report_card_vs_cpu(res, cpu, xs, metric)
            raise
        log(f"phase 4 dense==bucketed==fused m=512 d=64 {metric}: max_abs_err "
            f"fused-dense {max_err(res['fused'], res['dense']):.3e}, "
            f"card-cpu {max_err(res['fused'].cpu(), cpu):.3e}")
    return out


def report_card_vs_cpu(res: dict, cpu, xs, metric: str, k: int = 8):
    """Before phase 4's card-versus-CPU check raises: the worst entries'
    (i, j), the card's fused value, the CPU's, each card executor's, and
    a float64 oracle of the same metric on the same rows, so a mismatch
    names which side strayed."""
    diff = (res["fused"].cpu() - cpu).abs()
    worst = torch.topk(diff.reshape(-1), k).indices
    x64 = torch.from_numpy(xs).double()
    g = x64 @ x64.T
    n2 = g.diagonal()
    if metric == "l2":
        g = n2[:, None] + n2[None, :] - 2.0 * g
    elif metric == "cosine":
        nrm = torch.sqrt(n2 + 1e-9)
        g = g / (nrm[:, None] * nrm[None, :])
    log(f"phase 4 card-vs-cpu MISMATCH, {metric}: "
        f"{int((diff > FP32['atol'] + FP32['rtol'] * cpu.abs()).sum())} "
        f"entries out of tolerance; worst {k}:")
    m = cpu.shape[1]
    for flat in worst.tolist():
        i, j = divmod(flat, m)
        log(f"  ({i}, {j}): card fused {float(res['fused'][i, j]):.8e} "
            f"dense {float(res['dense'][i, j]):.8e} bucketed "
            f"{float(res['bucketed'][i, j]):.8e} | cpu fused "
            f"{float(cpu[i, j]):.8e} | float64 {float(g[i, j]):.8e}")


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
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    log(f"{label} profile of one warm request: device busy {busy_ms:.3f} ms "
        f"of {wall_ms:.3f} ms wall under the profiler (idle share "
        f"{1 - busy_ms / wall_ms:.3f}); top device time:")
    for name, ms in top:
        log(f"  {ms:9.3f} ms  {name[:90]}")
    return {"device_busy_ms": busy_ms, "profiled_wall_ms": wall_ms,
            "device_top_ms": dict(top), "device_ms_by_name": by_name}


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
        # the bound as defined for the request (the table counted once per
        # request), and beside it the table bytes the kernel's schedule
        # stages from L2: modelled from the plan (gather_bytes), not
        # measured on the card
        b_ms, b_by = bound(bucket_work(b, x.shape[1]),
                           PEAK_FP32_CUDA_CORES)
        staged = fgg.gather_bytes(b.mask, x.shape[1], x.element_size())
        tot["modelled_gather_bytes"] = (
            tot.get("modelled_gather_bytes", 0) + staged)
        rows.append({"width": b.width, "R": b.R, "kernel_fp32_ms": k32,
                     "kernel_bf16_ms": k16, "plain_ms": plain,
                     "bmm_ms": bmm, "ratio_to_bmm": k32 / bmm,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "bound_share": b_ms / k32,
                     "modelled_gather_bytes": staged})
        log(f"phase 6 bucket width={b.width} R={b.R}: kernel fp32 "
            f"{k32:.4f} ms, bf16 {k16:.4f} ms; plain {plain:.4f} ms; "
            f"torch.bmm on pre-gathered blocks {bmm:.4f} ms (kernel / bmm "
            f"{k32 / bmm:.3f}); bound {b_ms:.4f} ms ({b_by}), share "
            f"{b_ms / k32:.3f}; the schedule stages {staged / 1e9:.3f} GB "
            f"of table rows from L2 (modelled from the plan: "
            f"{staged / k32 / 1e9:.2f} TB/s if all of it moved)")
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


def only(**launched) -> dict:
    """The counts a path must show: these launches, none of the others."""
    return {**dict.fromkeys(KERNELS, 0), **launched}


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
    # one launch per tight (wx, wy) class of each bucket's reducers
    n_launch = len(rect_launch_plan(plan).buckets)
    assert out["launches"] == only(
        fused_gather_gram_rect=n_launch), out["launches"]
    log(f"phase {phase} {kind} X2Y path: x2y_similarity(executor='fused') "
        f"launches {out['launches']} ({len(plan.buckets)} buckets, "
        f"{n_launch} launch classes), first call "
        f"{out['first_request_s']:.3f} s incl. source map")
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
    rect kernel once per tight class of each bucket's reducers
    (``assembly.rect_launch_plan``)."""
    svc = PairwiseService(q=Q, executor="fused", metric="cosine")
    plan = case["plan"]
    walls = []
    for rep in range(2):
        before = counts()
        sims, info = svc.x2y(case["x"], case["y"], case["wx"], case["wy"])
        launched = {k: v - before[k] for k, v in counts().items()}
        assert set(info) == INFO_KEYS, sorted(set(info) ^ INFO_KEYS)
        assert launched["fused_gather_gram_rect"] == len(
            rect_launch_plan(plan).buckets), launched
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
        assert launched == only(fused_gather_gram_rect=len(
            rect_launch_plan(sub).buckets)), launched
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
            got = pg.pairwise_gram_batched(blocks, blocks)   # self-Gram
            torch.cuda.synchronize()
            want = pg.pairwise_gram_ref(blocks, blocks)
            torch.testing.assert_close(
                got, want, **tol,
                msg=lambda m: f"pairwise_gram bucket {b.width}: {m}")
            out["errs"][dtype] = max(out["errs"][dtype], max_err(got, want))
            # the two-table route on a copy: the same values
            two = pg.pairwise_gram_batched(blocks, blocks.clone())
            torch.testing.assert_close(
                two, got, **tol,
                msg=lambda m: f"pairwise_gram (x, y) bucket {b.width}: {m}")
            out["self_vs_two_tables"] = max(
                out.get("self_vs_two_tables", 0.0), max_err(two, got))
            del got, want, blocks, two
        del g
        log(f"phase 10 pairwise_gram==plain bucket width={b.width} R={b.R}: "
            f"ok (running max fp32 {out['errs']['float32']:.3e}, bf16 "
            f"{out['errs']['bfloat16']:.3e}); self-Gram route == (x, y) "
            f"route on a copy, max diff {out['self_vs_two_tables']:.3e}")
    _build.reset_launch_counts()
    got, _, _ = pairwise_similarity(x, q=Q, schema=schema, metric="cosine",
                                    executor="bucketed", use_kernel=True)
    torch.cuda.synchronize()
    out["launches"] = counts()
    assert out["launches"] == only(pairwise_gram=len(plan.buckets)), \
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
    plain version, and torch.bmm on the pre-gathered blocks; per bucket the
    tile widths, the bound and the table bytes the gather stages (modelled
    from the plan, fp32)."""
    rows, tot = [], {"kernel_fp32": 0.0, "kernel_bf16": 0.0, "plain": 0.0,
                     "bmm": 0.0, "modelled_gather_bytes": 0}
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
        b_ms, b_by = bound(rect_bucket_work(b, x.shape[1]),
                           PEAK_FP32_CUDA_CORES)
        staged = fgg.rect_gather_bytes(b.mask, b.ymask, x.shape[1],
                                       x.element_size())
        tot["modelled_gather_bytes"] += staged
        rows.append({"width": b.width, "ywidth": b.ywidth, "R": b.R,
                     "tiles": fgg.rect_tile_widths(b.width, b.ywidth),
                     "kernel_fp32_ms": k32, "kernel_bf16_ms": k16,
                     "plain_ms": plain, "bmm_ms": bmm,
                     "ratio_to_bmm": k32 / bmm, "bound_ms": b_ms,
                     "bound_by": b_by, "bound_share": b_ms / k32,
                     "modelled_gather_bytes": staged})
    tot["ratio_to_bmm"] = tot["kernel_fp32"] / tot["bmm"]
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
        b_ms, b_by = bound(
            pairwise_bucket_work(b, x.shape[1], x.element_size()),
            PEAK_FP32_CUDA_CORES)
        rows.append({"width": b.width, "R": b.R, "kernel_fp32_ms": k32,
                     "kernel_bf16_ms": k16, "plain_ms": plain,
                     "bmm_ms": bmm, "bound_ms": b_ms, "bound_by": b_by,
                     "ratio_to_bmm": k32 / bmm, "bound_share": b_ms / k32})
    tot["ratio_to_bmm"] = tot["kernel_fp32"] / tot["bmm"]
    return {"buckets": rows, "totals": tot}


def fgg_buckets(timing, timing_new) -> list:
    """Per bucket of the m=4096 request: fused_gather_gram beside
    torch.bmm and pairwise_gram on the pre-gathered blocks (phase 11) and
    its share of bound, for the ``kernels`` record; the log also gives the
    table bytes its schedule stages (modelled from the plan, so kept out of
    the record)."""
    pg_ms = {r["width"]: r["kernel_fp32_ms"]
             for r in timing_new["pairwise_gram"]["buckets"]}
    rows = []
    for r in timing["buckets"]:
        rec = {k: r[k] for k in ("width", "R", "kernel_fp32_ms",
                                 "kernel_bf16_ms", "bmm_ms", "ratio_to_bmm",
                                 "bound_ms", "bound_share")}
        rec["pairwise_gram_ms"] = pg_ms[r["width"]]
        rec["ratio_to_pairwise_gram"] = r["kernel_fp32_ms"] / pg_ms[r["width"]]
        rows.append(rec)
        log(f"fused_gather_gram bucket width={r['width']}: fp32 "
            f"{r['kernel_fp32_ms']:.4f} ms, / torch.bmm "
            f"{r['ratio_to_bmm']:.3f}, / pairwise_gram "
            f"{rec['ratio_to_pairwise_gram']:.3f}, share of bound "
            f"{r['bound_share']:.3f}, L2 gather (modelled) "
            f"{r['modelled_gather_bytes'] / 1e9:.3f} GB")
    return rows


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
            rate = (r.get("modelled_gather_bytes", 0) / r["kernel_fp32_ms"]
                    / 1e9)
            shape = (f"{r['width']}x{r['ywidth']} (tiles "
                     f"{r['tiles'][0]}x{r['tiles'][1]})" if "ywidth" in r
                     else f"{r['width']}")
            log(f"phase 11 {name} bucket {shape} R={r['R']}: kernel fp32 "
                f"{r['kernel_fp32_ms']:.4f} ms, bf16 "
                f"{r['kernel_bf16_ms']:.4f} ms; plain {r['plain_ms']:.4f} "
                f"ms; torch.bmm {r['bmm_ms']:.4f} ms; kernel / bmm "
                f"{r['ratio_to_bmm']:.3f}, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}), share {r['bound_share']:.3f}"
                + (f"; L2 gather (modelled) "
                   f"{r['modelled_gather_bytes'] / 1e9:.3f} GB, "
                   f"{rate:.2f} TB/s if all of it moved"
                   if "ywidth" in r else ""))
        tt = t["totals"]
        log(f"phase 11 {name} per request: kernel fp32 "
            f"{tt['kernel_fp32']:.4f} ms, bf16 {tt['kernel_bf16']:.4f} ms; "
            f"plain {tt['plain']:.4f} ms; torch.bmm {tt['bmm']:.4f} ms "
            f"(kernel / bmm {tt['ratio_to_bmm']:.3f})"
            + (f"; L2 gather (modelled) "
               f"{tt['modelled_gather_bytes'] / 1e9:.3f} GB"
               if "modelled_gather_bytes" in tt else "")
            + (f"; warm request median {tt['warm_request_s']:.4f} s"
               if "warm_request_s" in tt else ""))
    return out


# ---------------------------------------------------------------------------
# some-pairs similarity and streaming (phases 16-18)
# ---------------------------------------------------------------------------
SP_PLANES = 4                       # examples/some_pairs.py's blocker
# benchmarks/bench_stream.py's planner thresholds
STREAM_MAX_GAP, STREAM_REPACK_GAP = 1.2, 1.03
STREAM_EDITS = 16                   # of each of add / remove / update
STREAM_CHECK_EVERY = 8
X2Y_STREAM_EDITS = 4                # of each of the four X2Y edit kinds


def required_pairs(x_np) -> np.ndarray:
    """``examples/some_pairs.py``'s blocking step: a 4-hyperplane sign
    signature of the features; pairs with equal signatures are required
    (about 1/16 of all pairs)."""
    planes = np.random.default_rng(SEED + 3).normal(
        size=(x_np.shape[1], SP_PLANES)).astype(np.float32)
    code = (x_np @ planes > 0) @ (1 << np.arange(SP_PLANES))
    out = []
    for c in np.unique(code):
        ids = np.flatnonzero(code == c)
        i, j = np.triu_indices(len(ids), 1)
        out.append(np.stack([ids[i], ids[j]], axis=1))
    return np.concatenate(out)


def phase_some_pairs(x, x_np, w) -> dict:
    """Phase 16: ``PairwiseService(executor='fused').some_pairs`` on the main
    path's table: ``fused_gather_gram`` once per bucket and nothing else,
    each bucket against its plain version, the matrix against x·xᵀ on the
    required pairs and exactly 0 elsewhere."""
    pairs = required_pairs(x_np)
    t0 = time.perf_counter()
    schema = plan_some_pairs(w, Q, pairs)
    t_plan = time.perf_counter() - t0
    plan = _plan_for(schema, pad_reducers_to=1, pad_slots_to=1)
    arrays = bucket_arrays(plan, x.device)
    errs = {"float32": 0.0, "bfloat16": 0.0}
    for b, (idx, mask, _) in zip(plan.buckets, arrays):
        errs["float32"] = max(errs["float32"], check_kernel(
            x, idx, mask, FP32, f"some-pairs bucket {b.width} fp32"))
        errs["bfloat16"] = max(errs["bfloat16"], check_kernel(
            x.bfloat16(), idx, mask, BF16, f"some-pairs bucket {b.width} "
            "bf16"))
    svc = PairwiseService(q=Q, executor="fused")
    _build.reset_launch_counts()
    sims, info = svc.some_pairs(x_np, pairs, w)
    launched = counts()
    assert launched == only(fused_gather_gram=len(plan.buckets)), launched
    assert info["fused_path"] == "kernel", info["fused_path"]
    assert (info["algorithm"], info["reducers"]) == \
        (schema.algorithm, plan.num_reducers), info
    with fgg.ieee_fp32():
        g = x @ x.T
    want = torch.zeros((M, M), dtype=torch.bool, device=x.device)
    p = torch.from_numpy(pairs).to(x.device)
    want[p[:, 0], p[:, 1]] = True
    want[p[:, 1], p[:, 0]] = True
    assert sims.shape == (M, M) and bool(torch.isfinite(sims).all())
    torch.testing.assert_close(sims[want], g[want], **FP32)
    off = float(sims[~want].abs().max())
    assert off == 0.0, off
    oracle_err = max_err(sims[want], g[want])
    del g, want, sims
    k_ms = sum(time_cuda(lambda: fgg.fused_gather_gram(x, i, mk), 10)
               for i, mk, _ in arrays)
    plain_ms = sum(time_cuda(lambda: fgg.fused_gather_gram_ref(x, i, mk),
                             3, warmup=1) for i, mk, _ in arrays)
    b_ms, b_by = bound(work_model(plan, *x.shape, x.element_size()),
                       PEAK_FP32_CUDA_CORES)
    log(f"phase 16 some-pairs m={M} d={D}: {len(pairs)} of {M * (M - 1) // 2}"
        f" pairs required; plan_some_pairs {schema.algorithm}, "
        f"{plan.num_reducers} reducers, buckets "
        f"{[(b.width, b.R) for b in plan.buckets]}, host plan {t_plan:.2f} s;"
        f" service request wall {info['wall_s']:.3f} s (plans again); "
        f"launches {launched}; kernel==plain max_abs_err fp32 "
        f"{errs['float32']:.3e} bf16 {errs['bfloat16']:.3e}; required "
        f"pairs==x·xᵀ max_abs_err {oracle_err:.3e}, others exactly 0; "
        f"kernel fp32 {k_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by})")
    return {"pairs": int(len(pairs)), "algorithm": schema.algorithm,
            "reducers": plan.num_reducers,
            "buckets": [(b.width, b.R) for b in plan.buckets],
            "plan_s": t_plan, "request_wall_s": info["wall_s"],
            "launches": launched, "errs": errs, "oracle_err": oracle_err,
            "ms": k_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by}


def zipf_size(rng) -> float:
    """One input size of the main path's profile (``bench_profile``)."""
    return float(np.clip(rng.zipf(ZIPF_A) / 32.0, 0.01, 0.45 * Q))


def check_live(sims, xt, active, what: str) -> float:
    """The maintained matrix against x·xᵀ (TF32 off) with a zero diagonal
    on the live rows; tombstoned rows and columns exactly 0."""
    with fgg.ieee_fp32():
        want = xt @ xt.T
    want.fill_diagonal_(0.0)
    dead = torch.from_numpy(~np.asarray(active, bool)).to(xt.device)
    want[dead] = 0.0
    want[:, dead] = 0.0
    assert sims.shape == want.shape, (sims.shape, want.shape)
    torch.testing.assert_close(sims, want, **FP32,
                               msg=lambda m: f"{what}: {m}")
    if bool(dead.any()):
        assert float(sims[dead].abs().max()) == 0.0, what
        assert float(sims[:, dead].abs().max()) == 0.0, what
    return max_err(sims, want)


def timed_planner(planner, ops, rec: dict) -> None:
    """Wrap the planner's edit methods so each edit's delta and host
    planning seconds land in ``rec``."""
    for op in ops:
        fn = getattr(planner, op)

        def timed(*args, _fn=fn):
            t0 = time.perf_counter()
            rec["delta"] = _fn(*args)
            rec["plan_s"] = time.perf_counter() - t0
            return rec["delta"]
        setattr(planner, op, timed)


def executed(delta) -> bool:
    """Whether a delta recomputes reducers (the patch runs its sub-plan)."""
    return bool(len(delta.touched_inputs) and delta.sub_plan is not None
                and len(delta.dirty_rows))


def edit_stats(rows) -> dict:
    out = {}
    for key in ("wall_s", "plan_s", "patch_s"):
        v = np.array([r[key] for r in rows])
        out[key] = {"median": float(np.median(v)),
                    "p99": float(np.percentile(v, 99)), "max": float(v.max())}
    return out


def delta_gram_check(table_np, delta) -> tuple:
    """pairwise_gram against its plain version on the blocks the delta's
    buckets gathered from the capacity-padded table, and both timed."""
    xt = StreamingExecutor._at_capacity(torch.from_numpy(table_np).cuda())
    blocks = [fgg.gather_rows(xt, torch.from_numpy(b.idx).cuda(),
                              torch.from_numpy(b.mask).cuda())
              for b in delta.sub_plan.buckets]
    err = 0.0
    for g in blocks:
        got = pg.pairwise_gram_batched(g, g)
        torch.cuda.synchronize()
        want = pg.pairwise_gram_ref(g, g)
        torch.testing.assert_close(got, want, **FP32)
        err = max(err, max_err(got, want))
    k_ms = time_cuda(lambda: [pg.pairwise_gram_batched(g, g)
                              for g in blocks], 10)
    plain_ms = time_cuda(lambda: [pg.pairwise_gram_ref(g, g)
                                  for g in blocks], 3, warmup=1)
    return err, k_ms, plain_ms


def phase_stream_a2a(x_np, w) -> dict:
    """Phase 17: the service's edit API on the main path's table with
    ``use_kernel=True``: ``load_table`` cold-builds through
    ``fused_gather_gram`` and warms every delta shape (``pairwise_gram``);
    then 48 seeded edits, each executed delta one ``pairwise_gram`` launch
    per bucket of its dirty sub-plan (and its blocks against the plain
    version), the first edit building nothing and bringing no new table
    signature, and the matrix checked every 8th edit and after the last."""
    svc = PairwiseService(q=Q, executor="streaming", use_kernel=True)
    _build.reset_launch_counts()
    sims, info = svc.load_table(x_np, w, max_gap=STREAM_MAX_GAP,
                                repack_gap=STREAM_REPACK_GAP, warmup=True)
    load = counts()
    load_s = info["wall_s"]
    planner = svc._planner
    plan = planner.plan()
    assert load == only(fused_gather_gram=len(plan.buckets),
                        pairwise_gram=info["warmed_shapes"]), load
    x = torch.from_numpy(x_np).cuda()
    cold_err = check_live(sims, x, planner.active, "phase 17 load_table")
    kerr = 0.0
    for b, (idx, mask, _) in zip(plan.buckets, bucket_arrays(plan, x.device)):
        kerr = max(kerr, check_kernel(x, idx, mask, FP32,
                                      f"phase 17 cold bucket {b.width}"))
    del sims, x
    log(f"phase 17 load_table m={M} d={D}: {info['algorithm']}, "
        f"{info['reducers']} reducers; {info['warmed_shapes']} delta shapes "
        f"warmed; launches {load}; {info['wall_s']:.2f} s (plan, cold "
        f"build, warmup); cold==x·xᵀ max_abs_err {cold_err:.3e}, cold "
        f"buckets kernel==plain {kerr:.3e}")
    rec: dict = {}
    timed_planner(planner, ("insert", "delete", "reweight"), rec)
    rng = np.random.default_rng(SEED + 11)
    ops = ["add"] * STREAM_EDITS + ["remove"] * STREAM_EDITS \
        + ["update"] * STREAM_EDITS
    rng.shuffle(ops)
    rows, pg_err, pg_ms, pg_plain_ms, pg_launches = [], 0.0, 0.0, 0.0, 0
    check_errs = []
    for k, op in enumerate(ops):
        live = planner.active_ids()
        before, builds, sigs = counts(), _build.build_counts(), \
            table_signatures()
        if op == "add":
            sims, info = svc.add_input(
                rng.normal(size=D).astype(np.float32), zipf_size(rng))
        elif op == "remove":
            sims, info = svc.remove_input(int(rng.choice(live)))
        else:
            sims, info = svc.update_weight(int(rng.choice(live)),
                                           zipf_size(rng))
        launched = {n: v - before[n] for n, v in counts().items()}
        delta = rec["delta"]
        if k == 0:
            assert _build.build_counts() == builds, "first edit built"
            assert table_signatures() == sigs, "first edit: new signature"
        if delta.full_replan:
            assert launched["fused_gather_gram"] > 0, launched
        else:
            n_pg = len(delta.sub_plan.buckets) if executed(delta) else 0
            assert launched == only(pairwise_gram=n_pg), (op, launched)
        pg_launches += launched["pairwise_gram"]
        if executed(delta) and not delta.full_replan:
            e, k_ms, p_ms = delta_gram_check(svc._table, delta)
            pg_err, pg_ms, pg_plain_ms = max(pg_err, e), pg_ms + k_ms, \
                pg_plain_ms + p_ms
        rows.append({"op": op, "kind": info["kind"],
                     "wall_s": info["wall_s"], "plan_s": rec["plan_s"],
                     "patch_s": info["wall_s"] - rec["plan_s"],
                     "dirty_reducers": info["dirty_reducers"],
                     "recompute_fraction": info["recompute_fraction"],
                     "replan": info["replan"], "executed": executed(delta),
                     "pairwise_gram_launches": launched["pairwise_gram"]})
        if (k + 1) % STREAM_CHECK_EVERY == 0 or k == len(ops) - 1:
            xt = torch.from_numpy(svc._table).cuda()
            check_errs.append(check_live(sims, xt, planner.active,
                                         f"phase 17 edit {k}"))
            del xt
        del sims
    # one more insert, under the profiler: the device's share of an edit
    prof = profile_request(
        lambda: svc.add_input(rng.normal(size=D).astype(np.float32),
                              zipf_size(rng)), "phase 17 one more insert")
    st = edit_stats(rows)
    n_exec = sum(r["executed"] for r in rows)
    log(f"phase 17 {len(rows)} edits ({STREAM_EDITS} each of add / remove / "
        f"update): wall median {st['wall_s']['median'] * 1e3:.2f} ms, p99 "
        f"{st['wall_s']['p99'] * 1e3:.2f} ms; planner median "
        f"{st['plan_s']['median'] * 1e3:.2f} ms, p99 "
        f"{st['plan_s']['p99'] * 1e3:.2f} ms; patch (table upload + device, "
        f"synchronized) median {st['patch_s']['median'] * 1e3:.2f} ms, p99 "
        f"{st['patch_s']['p99'] * 1e3:.2f} ms; dirty reducers median "
        f"{np.median([r['dirty_reducers'] for r in rows]):.0f} max "
        f"{max(r['dirty_reducers'] for r in rows)}; recompute fraction "
        f"median {np.median([r['recompute_fraction'] for r in rows]):.2e} "
        f"max {max(r['recompute_fraction'] for r in rows):.2e}; replans "
        f"{sum(r['replan'] for r in rows)}; {n_exec} deltas executed, "
        f"pairwise_gram launches {pg_launches} (kernel==plain max_abs_err "
        f"{pg_err:.3e}; kernel {pg_ms:.4f} ms, plain {pg_plain_ms:.4f} ms "
        f"over all of them); matrix==x·xᵀ at {len(check_errs)} checks, max "
        f"abs err {max(check_errs):.3e}; first edit: no nvcc build, no new "
        f"table signature")
    return {"load": {"wall_s": load_s, "launches": load,
                     "cold_err": cold_err, "kernel_err": kerr,
                     "reducers": plan.num_reducers,
                     "buckets": len(plan.buckets)},
            "edits": rows, "stats": st, "pairwise_gram": {
                "launches": pg_launches, "max_abs_err": pg_err,
                "ms": pg_ms, "plain_ms": pg_plain_ms,
                "executed_deltas": n_exec},
            "check_errs": check_errs, "profile_insert": prof}


def phase_stream_x2y(skew: dict) -> dict:
    """Phase 18: ``StreamingExecutor.run_x2y`` on an
    ``IncrementalX2YPlanner`` over the skew profile (8192 x 512): the cold
    build launches ``fused_gather_gram_rect`` once per rect bucket (each
    bucket against its plain version), then ``warm_delta_shapes_x2y`` and
    16 seeded edits, each checked against x·yᵀ on the live rows with
    tombstones exactly 0.  The X2Y delta reducer is a torch product in the
    reference too, so deltas launch no hand-written kernel."""
    t0 = time.perf_counter()
    inc = IncrementalX2YPlanner(Q, wx=skew["wx"], wy=skew["wy"])
    t_plan = time.perf_counter() - t0
    plan = inc.plan()
    X, Y = skew["x"], skew["y"]
    errs = check_rect_buckets(X, Y, plan, "phase 18 stream x2y")
    ex = make_executor("streaming")
    fn = _block_fn_x2y("dot")
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    sims = ex.run_x2y((X, Y), plan, fn, (MX, MY))
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    cold = counts()
    assert cold == only(fused_gather_gram_rect=len(plan.buckets)), cold
    torch.testing.assert_close(sims, oracle(X, Y, "dot"), **FP32)
    t0 = time.perf_counter()
    warmed = ex.warm_delta_shapes_x2y((X, Y), inc.delta_shapes(), fn)
    t_warm = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 13)
    ops = ["insert_x", "insert_y", "delete_x", "delete_y"] * X2Y_STREAM_EDITS
    rng.shuffle(ops)
    rows, errs_live = [], []
    for op in ops:
        before = counts()
        if op == "insert_x":
            X = torch.cat([X, torch.from_numpy(rng.normal(size=(1, D))
                                               .astype(np.float32)).cuda()])
            args = (float(rng.uniform(0.01, 0.1)),)
        elif op == "insert_y":
            Y = torch.cat([Y, torch.from_numpy(rng.normal(size=(1, D))
                                               .astype(np.float32)).cuda()])
            args = (float(rng.uniform(0.2, 0.45)),)
        else:
            live = inc.active_x_ids() if op == "delete_x" \
                else inc.active_y_ids()
            args = (int(rng.choice(live)),)
        t0 = time.perf_counter()
        delta = getattr(inc, op)(*args)
        t1 = time.perf_counter()
        sims = ex.apply_delta_x2y((X, Y), delta, fn, (X.shape[0],
                                                      Y.shape[0]),
                                  plan_provider=inc.plan)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launched = {n: v - before[n] for n, v in counts().items()}
        if not delta.full_replan:
            assert launched == only(), (op, launched)
        ax = torch.zeros(X.shape[0], dtype=torch.bool, device=X.device)
        ay = torch.zeros(Y.shape[0], dtype=torch.bool, device=X.device)
        ax[torch.from_numpy(inc.active_x_ids()).cuda()] = True
        ay[torch.from_numpy(inc.active_y_ids()).cuda()] = True
        want = oracle(X, Y, "dot") * (ax[:, None] & ay[None, :])
        torch.testing.assert_close(sims, want, **FP32,
                                   msg=lambda m: f"phase 18 {op}: {m}")
        dead = float(sims[~ax].abs().sum() + sims[:, ~ay].abs().sum())
        assert dead == 0.0, (op, dead)
        errs_live.append(max_err(sims, want))
        rows.append({"op": op, "plan_s": t1 - t0, "patch_s": t2 - t1,
                     "wall_s": t2 - t0,
                     "dirty_reducers": int(len(delta.dirty_rows)),
                     "recompute_fraction": float(delta.recompute_fraction),
                     "full_replan": bool(delta.full_replan)})
        del sims, want
    st = edit_stats(rows)
    log(f"phase 18 stream X2Y {MX}x{MY} d={D}: IncrementalX2YPlanner "
        f"{plan.num_reducers} reducers, {len(plan.buckets)} rect buckets, "
        f"host plan {t_plan:.2f} s; cold run_x2y {t_cold:.3f} s, launches "
        f"{cold}, kernel==plain max_abs_err fp32 {errs['float32']:.3e} bf16 "
        f"{errs['bfloat16']:.3e}; {warmed} delta shapes warmed in "
        f"{t_warm:.2f} s; {len(rows)} edits: wall median "
        f"{st['wall_s']['median'] * 1e3:.2f} ms p99 "
        f"{st['wall_s']['p99'] * 1e3:.2f} ms (planner median "
        f"{st['plan_s']['median'] * 1e3:.2f} ms, patch median "
        f"{st['patch_s']['median'] * 1e3:.2f} ms); dirty reducers median "
        f"{np.median([r['dirty_reducers'] for r in rows]):.0f}; "
        f"matrix==x·yᵀ after every edit, max_abs_err {max(errs_live):.3e}, "
        f"tombstones exactly 0")
    return {"plan_s": t_plan, "cold_s": t_cold, "warm_s": t_warm,
            "warmed_shapes": warmed, "reducers": plan.num_reducers,
            "buckets": len(plan.buckets), "launches": cold, "errs": errs,
            "edits": rows, "stats": st, "live_errs": errs_live}


# ---------------------------------------------------------------------------
# sharded and coded execution over a process group
# ---------------------------------------------------------------------------
M_RANKS, RANKS = 2048, 4            # phase 20: table size, gloo ranks
# phase 20's coded table: cut from M_RANKS to keep the script near 300 s,
# since ``_coded_maps`` is a per-reducer Python loop (~15 s per rank at
# m=2048, 171,405 reducers; 44,850 at m=1024)
M_CODED = 1024
GROUP_TIMEOUT_S = 120.0             # every collective, and each spawn


def square_plain(x, idx, mask, metric=None, out=None):
    """The square kernel's plain version with its metric finish in torch
    (``out`` is where the kernel wrote; the plain version allocates)."""
    g = fgg.fused_gather_gram_ref(x, idx, mask)
    return g if metric is None else fgg.finish_fused_blocks(g, mask, metric)


def rect_plain(x, y, xidx, xmask, yidx, ymask, metric=None, out=None,
               norms=None):
    """The rect kernel's plain version with its metric finish in torch
    (``out`` is where the kernel wrote; the plain version allocates)."""
    g = fgg.fused_gather_gram_rect_ref(x, y, xidx, xmask, yidx, ymask)
    if metric is None:
        return g
    return fgg.finish_rect_blocks(
        g, xidx, xmask.bool(), yidx, ymask.bool(),
        *(norms or fgg.rect_table_norms(x, y, metric)), metric)


class KernelSpy:
    """Records each launch of the three Gram kernels the executors make
    (its operands and output) to hold it against its plain version
    afterwards, which launches nothing."""

    # kernel -> (module the executors call its wrapper through, wrapper's
    # name there, plain version)
    TARGETS = {
        "fused_gather_gram": (port_ex, "fused_gather_gram", square_plain),
        "fused_gather_gram_rect": (port_ex, "fused_gather_gram_rect",
                                   rect_plain),
        "pairwise_gram": (pg, "pairwise_gram_batched",
                          pg.pairwise_gram_ref)}

    def __enter__(self):
        self.calls = []
        self._orig = {k: getattr(mod, attr)
                      for k, (mod, attr, _p) in self.TARGETS.items()}
        for name, fn in self._orig.items():
            def spy(*args, _name=name, _fn=fn):
                out = _fn(*args)
                self.calls.append((_name, args, out))
                return out
            mod, attr, _p = self.TARGETS[name]
            setattr(mod, attr, spy)
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            mod, attr, _p = self.TARGETS[name]
            setattr(mod, attr, fn)

    def check(self, what: str) -> dict:
        """Every recorded launch against its plain version on the same
        operands (fp32 tolerance): ``{kernel: {launches, max_abs_err}}``."""
        torch.cuda.synchronize()
        out = {}
        for name, args, got in self.calls:
            want = self.TARGETS[name][2](*args)
            torch.testing.assert_close(got, want, **FP32,
                                       msg=lambda m: f"{what} {name}: {m}")
            rec = out.setdefault(name, {"launches": 0, "max_abs_err": 0.0})
            rec["launches"] += 1
            rec["max_abs_err"] = max(rec["max_abs_err"], max_err(got, want))
        self.calls = []
        return out


@contextlib.contextmanager
def host_timers(names):
    """Seconds spent in each named host function of the executors module
    (the partition, the stacking, the source maps, the coded maps) while
    the block runs."""
    secs = dict.fromkeys(names, 0.0)
    orig = {n: getattr(port_ex, n) for n in names}
    for name, fn in orig.items():
        def timed(*args, _name=name, _fn=fn, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kw)
            finally:
                secs[_name] += time.perf_counter() - t0
        setattr(port_ex, name, timed)
    try:
        yield secs
    finally:
        for name, fn in orig.items():
            setattr(port_ex, name, fn)


@contextlib.contextmanager
def collective_timer():
    """Host milliseconds inside the collectives.  Pending device work is
    synchronized first and the ranks meet at a barrier, so neither the
    kernels nor waiting for a slower rank is counted."""
    import torch.distributed as dist
    rec = {"ms": 0.0, "calls": 0}
    orig = {n: getattr(compat, n) for n in ("all_gather", "all_to_all")}
    for name, fn in orig.items():
        def timed(t, group, _fn=fn):
            torch.cuda.synchronize()
            if group is not None:
                dist.barrier(group)
            t0 = time.perf_counter()
            out = _fn(t, group)
            torch.cuda.synchronize()
            rec["ms"] += (time.perf_counter() - t0) * 1e3
            rec["calls"] += 1
            return out
        setattr(compat, name, timed)
    try:
        yield rec
    finally:
        for name, fn in orig.items():
            setattr(compat, name, fn)


def nonzero(secs: dict) -> dict:
    return {k: round(v, 3) for k, v in secs.items() if v}


HOST_FNS = ("partition_plan", "_stacked_groups", "_sharded_srcmap",
            "_stacked_rect_groups", "_sharded_rect_srcmap", "_coded_maps")


def rank_slices(groups, rank: int, n: int, dev) -> list:
    return [tuple(torch.as_tensor(a[rank], device=dev) for a in g[:n])
            for g in groups]


def group_times(x, y, groups, rank: int, rect: bool) -> dict:
    """The kernel on ``rank``'s slice of every stacked group (the square
    kernel, or the rect kernel on ``(x, y)``): CUDA-event ms per group,
    their sum, the plain version's sum, and the bound of the slice's work
    (valid products only: n (n + 1) d per square block, 2 nx ny d per
    rect one; idx / mask read once, every fp32 output entry written once,
    each table read once)."""
    ms, plain_ms, ops, nbytes = [], 0.0, 0, 0
    for g, s in zip(groups, rank_slices(groups, rank, 4 if rect else 2,
                                        x.device)):
        if rect:
            ms.append(time_cuda(
                lambda: fgg.fused_gather_gram_rect(x, y, *s), 10))
            plain_ms += time_cuda(
                lambda: fgg.fused_gather_gram_rect_ref(x, y, *s), 3,
                warmup=1)
            nx = g[1][rank].sum(axis=1).astype(np.int64)
            ny = g[3][rank].sum(axis=1).astype(np.int64)
            ops += 2 * x.shape[1] * int((nx * ny).sum())
            Rw, wx, wy = g[0].shape[1], g[0].shape[2], g[2].shape[2]
            nbytes += Rw * (wx + wy) * 5 + Rw * wx * wy * 4
        else:
            ms.append(time_cuda(lambda: fgg.fused_gather_gram(x, *s), 10))
            plain_ms += time_cuda(
                lambda: fgg.fused_gather_gram_ref(x, *s), 3, warmup=1)
            n = g[1][rank].sum(axis=1).astype(np.int64)
            ops += x.shape[1] * int((n * (n + 1)).sum())
            Rw, wd = g[0].shape[1], g[0].shape[2]
            nbytes += Rw * wd * 5 + Rw * wd * wd * 4
    tables = (x,) if x is y else (x, y)
    nbytes += sum(t.numel() * t.element_size() for t in tables)
    b_ms, b_by = bound({"ops": ops, "bytes": nbytes}, PEAK_FP32_CUDA_CORES)
    return {"group_ms": ms, "ms": sum(ms), "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by}


@contextlib.contextmanager
def one_rank_nccl():
    """An in-process NCCL group of one rank, the default group for the
    block (rendezvous through a file store in a temporary directory, so
    no port is opened)."""
    import torch.distributed as dist
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(str(Path(tmp) / "store"), 1),
            rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        try:
            assert dist.get_backend(dist.group.WORLD) == "nccl"
            yield dist.group.WORLD
        finally:
            dist.destroy_process_group()


def phase_sharded_one_rank(x, x_np, w, schema, skew) -> dict:
    """Phase 19: an in-process NCCL group of one rank (rendezvous through a
    file store in a temporary directory, so no port is opened).  Sharded
    A2A on the main path's table through ``pairwise_similarity(mesh=
    group)`` and then ``PairwiseService(executor='sharded', mesh=group)``
    (which plans again), and sharded X2Y on the skew profile through
    ``x2y_similarity(mesh=group)``: each matrix against the fused
    executor's on the same inputs, each launch against its plain version,
    one launch per stacked group and nothing else."""
    out = {}
    with one_rank_nccl() as group:
        for path in ("a2a", "x2y"):
            out[path] = sharded_one_rank_path(path, group, x, schema,
                                              skew)
        svc = PairwiseService(q=Q, executor="sharded", mesh=group)
        fused = pairwise_similarity(x, q=Q, schema=schema,
                                    executor="fused")[0]
        _build.reset_launch_counts()
        with KernelSpy() as spy:
            sims, info = svc.similarity(x_np, w)
        launched = counts()
        spy.check("phase 19 service")
        assert launched == only(fused_gather_gram=out["a2a"][
            "launches"]), launched
        assert info["sharded"]["num_shards"] == 1, info["sharded"]
        assert info["comm"]["measured_over_predicted"] == 1.0
        torch.testing.assert_close(sims, fused, **FP32)
        out["service"] = {"wall_s": info["wall_s"],
                          "sharded": info["sharded"],
                          "vs_fused_max_abs_err": max_err(sims, fused)}
        del sims, fused
    for path in ("a2a", "x2y"):
        rec = out[path]
        log(f"phase 19 one-rank NCCL group, sharded {path}: launches "
            f"{rec['launches']} (one per stacked group {rec['groups']}), "
            f"kernel==plain max_abs_err {rec['max_abs_err']:.3e}, "
            f"sharded==fused max_abs_err {rec['vs_fused_max_abs_err']:.3e};"
            f" kernel ms per group {[round(v, 4) for v in rec['group_ms']]}"
            f" (sum {rec['ms']:.4f}, plain {rec['plain_ms']:.4f}, bound "
            f"{rec['bound_ms']:.4f} {rec['bound_by']}); host s "
            f"{nonzero(rec['host_s'])}")
    log(f"phase 19 PairwiseService(executor='sharded', mesh=group) request "
        f"(plans again): wall {out['service']['wall_s']:.3f} s, info "
        f"sharded {out['service']['sharded']}, ==fused max_abs_err "
        f"{out['service']['vs_fused_max_abs_err']:.3e}")
    return out


def sharded_one_rank_path(path: str, group, x, schema, skew) -> dict:
    """One phase-19 path on the warm plan of phase 4 (A2A) or 7 (X2Y)."""
    ex = make_executor("sharded")
    if path == "a2a":
        X = Y = x
        fused = pairwise_similarity(x, q=Q, schema=schema,
                                    executor="fused")[0]
    else:
        X, Y = skew["x"], skew["y"]
        fused = x2y_similarity(X, Y, q=Q, schema=skew["schema"],
                               executor="fused")[0]
    _build.reset_launch_counts()
    with KernelSpy() as spy, host_timers(HOST_FNS) as host:
        if path == "a2a":
            sims, plan, _ = pairwise_similarity(x, q=Q, schema=schema,
                                                executor=ex, mesh=group)
        else:
            sims, plan, _ = x2y_similarity(X, Y, q=Q, schema=skew["schema"],
                                           executor=ex, mesh=group)
        torch.cuda.synchronize()
    launched = counts()
    kernel = "fused_gather_gram" if path == "a2a" else \
        "fused_gather_gram_rect"
    kern = spy.check(f"phase 19 sharded {path}")
    part = ex.partition(plan, 1)
    groups = ex._groups_for(plan, part) if path == "a2a" else \
        ex._rect_groups_for(plan, part)
    assert launched == only(**{kernel: len(groups)}), launched
    assert ex.stats()["num_shards"] == 1, ex.stats()
    torch.testing.assert_close(sims, fused, **FP32)
    return {"launches": launched[kernel],
            "max_abs_err": kern[kernel]["max_abs_err"],
            "vs_fused_max_abs_err": max_err(sims, fused),
            **group_times(X, Y, groups, 0, rect=path != "a2a"),
            "groups": [(g[0].shape[2], g[-3].shape[2], g[0].shape[1])
                       for g in groups], "host_s": host}


def rank_paths(rank: int, world: int, tables: dict, skew_np,
               want_x2y, want_stream=None) -> dict:
    """Phase 20's program on one rank of the group, on card ``rank`` modulo
    the card count (all on ``cuda:0`` with one card): sharded A2A on the
    ``M_RANKS`` table and coded (r=2) A2A on the ``M_CODED`` one
    (``tables[path]`` is ``(w, x, the parent's fused matrix)``), sharded
    X2Y on the skew profile; each matrix against the parent's fused one,
    each launch against its plain version; kernel ms per stacked group of
    this rank's slice, collective ms, host seconds of the planners'
    maps.  Then phase 21's part on the same group (``rank_mesh_paths``,
    given the parent's one-device streaming matrix ``want_stream``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(rank % torch.cuda.device_count())
    out = {"rank": rank, "builds_before": _build.build_counts()}
    wx, wy, xs_np, ys_np = skew_np
    X, Y = torch.from_numpy(xs_np).cuda(), torch.from_numpy(ys_np).cuda()
    for path in ("sharded_a2a", "coded_a2a", "sharded_x2y"):
        name = path.split("_")[0]
        ex = make_executor(name)
        if path in tables:
            w, x_np, want_np = tables[path]
            x = torch.from_numpy(x_np).cuda()
        else:
            want_np = want_x2y

        def request(schema=None):
            if path.endswith("a2a"):
                return pairwise_similarity(x, q=Q, weights=w, schema=schema,
                                           executor=ex)
            return x2y_similarity(X, Y, q=Q, wx=wx, wy=wy, schema=schema,
                                  executor=ex)
        a2a_before = REGISTRY.counter_total("collective.bytes",
                                            op="all_to_all")
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        with KernelSpy() as spy, host_timers(HOST_FNS) as host, \
                collective_timer() as cold:
            sims, plan, schema = request()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts()
        a2a_bytes = REGISTRY.counter_total("collective.bytes",
                                           op="all_to_all") - a2a_before
        kern = spy.check(f"phase 20 rank {rank} {path}")
        # the same request again on its schema: the plan, its maps and the
        # collectives' connections are warm, as for a repeated profile
        t0 = time.perf_counter()
        with collective_timer() as coll:
            again = request(schema)[0]
            torch.cuda.synchronize()
        warm_wall = time.perf_counter() - t0
        assert torch.equal(again, sims), (rank, path)
        del again
        want = torch.from_numpy(want_np).cuda()
        torch.testing.assert_close(sims, want, **FP32,
                                   msg=lambda m: f"rank {rank} {path}: {m}")
        st = ex.stats()
        if name == "coded":
            part = ex.partition_coded(plan, world)
            groups = ex._coded_groups_for(plan, part, False)
            times = group_times(x, x, groups, rank, rect=True)
        elif path == "sharded_a2a":
            groups = ex._groups_for(plan, ex.partition(plan, world))
            times = group_times(x, x, groups, rank, rect=False)
        else:
            groups = ex._rect_groups_for(plan, ex.partition(plan, world))
            times = group_times(X, Y, groups, rank, rect=True)
        rec = {"launches": launched, "kernels": kern,
               "vs_fused_max_abs_err": max_err(sims, want),
               **times, "wall_s": wall, "warm_wall_s": warm_wall,
               "collective_ms": coll["ms"], "collectives": coll["calls"],
               "cold_collective_ms": cold["ms"],
               "host_s": host, "num_shards": st["num_shards"],
               "balance_factor": st["balance_factor"]}
        if name == "coded":
            led = [r for r in LEDGER.records() if r.executor == "coded"][-1]
            rec.update({
                "local_fraction": st["local_fraction"],
                "replication": st["replication"],
                "measured_over_predicted": led.measured_over_predicted,
                "assembly_bytes_per_shard":
                    led.meta["assembly_bytes_per_shard"],
                "all_to_all_bytes": a2a_bytes})
        out[path] = rec
        del sims, want
    if want_stream is not None:
        out["phase21"] = rank_mesh_paths(rank, world, tables["sharded_a2a"],
                                         want_stream)
    out["builds_after"] = _build.build_counts()
    return out


def path_record(rec: dict) -> dict:
    """A phase-19 path in the ``kernels`` line."""
    return {k: rec[k] for k in ("launches", "max_abs_err", "ms", "plain_ms",
                                "bound_ms", "bound_by", "group_ms")}


def ranks_record(ranks: dict, path: str, kernel: str) -> dict:
    """A phase-20 path in the ``kernels`` line: launches per rank, the
    largest kernel==plain error, and the slowest rank's kernel ms with its
    plain version's ms and its bound."""
    recs = [r[path] for r in ranks["ranks"]]
    slow = max(recs, key=lambda r: r["ms"])
    return {"launches": [r["launches"][kernel] for r in recs],
            "max_abs_err": max(r["kernels"][kernel]["max_abs_err"]
                               for r in recs),
            "ms": slow["ms"], "plain_ms": slow["plain_ms"],
            "bound_ms": slow["bound_ms"], "bound_by": slow["bound_by"],
            "rank_ms": [r["ms"] for r in recs]}


def mesh_record(rec: dict) -> dict:
    """A phase-21 one-rank path in the ``kernels`` line."""
    return {k: rec[k] for k in ("launches", "max_abs_err",
                                "vs_unsharded_max_abs_err")}


def mesh_ranks_record(ranks: dict, path: str, kernel: str) -> dict:
    """A phase-21 path of the gloo ranks in the ``kernels`` line: launches
    per rank and the largest kernel==plain error."""
    recs = [r["phase21"][path] for r in ranks["ranks"]]
    return {"launches": [r["launches"][kernel] for r in recs],
            "max_abs_err": max(r["kernels"][kernel]["max_abs_err"]
                               for r in recs),
            "vs_one_device_max_abs_err": max(
                r["vs_one_device_max_abs_err"] for r in recs)}


def phase_ranks(skew, backend: str = "gloo", ranks: int = RANKS) -> dict:
    """Phase 20: ``ranks`` gloo ranks spawned on this one card (NCCL
    refuses two ranks on one GPU, so the collectives run on host tensors;
    the kernels run on the card).  Every library is built before the
    spawn, and no rank may run nvcc.  Each rank's matrices are held
    against this process's fused ones, each launch against its plain
    version; the coded r=2 ledger must read exactly 2.0, and its assembly
    bytes must equal the all-to-all tensor's bytes times (S - 1) / S.
    ``tools/nccl_ranks.py`` runs the same with ``backend="nccl"``, one rank
    per card."""
    tables = {}
    for path, m in (("sharded_a2a", M_RANKS), ("coded_a2a", M_CODED)):
        w, x_np = bench_profile(m, D, SEED)
        tables[path] = (w, x_np, pairwise_similarity(
            torch.from_numpy(x_np).cuda(), q=Q, weights=w,
            executor="fused")[0].cpu().numpy())
    want_x2y = x2y_similarity(skew["x"], skew["y"], q=Q, schema=skew[
        "schema"], executor="fused")[0].cpu().numpy()
    skew_np = (skew["wx"], skew["wy"], skew["x"].cpu().numpy(),
               skew["y"].cpu().numpy())
    w, x_np, _ = tables["sharded_a2a"]
    want_stream = run_stream_edits(w, x_np)[0].cpu().numpy()
    _build.build_all(("fused_gather_gram", "fused_gather_gram_rect",
                      "pairwise_gram"))
    t0 = time.perf_counter()
    results = compat.run_local_group(
        rank_paths, ranks, tables, skew_np, want_x2y, want_stream,
        backend=backend, timeout_s=GROUP_TIMEOUT_S)
    wall = time.perf_counter() - t0
    for r in results:
        builds = sum(r["builds_before"].values()) + \
            sum(r["builds_after"].values())
        assert builds == 0, (r["rank"], r["builds_before"],
                             r["builds_after"])
        for path in ("sharded_a2a", "coded_a2a", "sharded_x2y"):
            assert r[path]["num_shards"] == ranks, (r["rank"], path)
        c = r["coded_a2a"]
        assert c["measured_over_predicted"] == 2.0, c
        assert int(c["all_to_all_bytes"] * ((ranks - 1) / ranks)) \
            == c["assembly_bytes_per_shard"], c
        for path, kernel in (("sharded_a2a", "fused_gather_gram"),
                             ("coded_a2a", "fused_gather_gram_rect"),
                             ("sharded_x2y", "fused_gather_gram_rect")):
            rec = r[path]
            assert rec["launches"] == only(**{
                kernel: len(rec["group_ms"])}), (r["rank"], path, rec)
            log(f"phase 20 rank {r['rank']}/{ranks} {path}: launches "
                f"{rec['launches'][kernel]}, kernel==plain max_abs_err "
                f"{rec['kernels'][kernel]['max_abs_err']:.3e}, ==fused "
                f"{rec['vs_fused_max_abs_err']:.3e}; kernel ms "
                f"{rec['ms']:.4f} ({[round(v, 4) for v in rec['group_ms']]}"
                f"; plain {rec['plain_ms']:.4f}, bound {rec['bound_ms']:.4f}"
                f" {rec['bound_by']}), collective ms "
                f"{rec['collective_ms']:.2f} over {rec['collectives']} calls "
                f"(first request {rec['cold_collective_ms']:.2f}), wall "
                f"{rec['wall_s']:.2f} s (again on the same schema "
                f"{rec['warm_wall_s'] * 1e3:.1f} ms), "
                f"host s {nonzero(rec['host_s'])}, balance_factor "
                f"{rec['balance_factor']:.4f}"
                + (f", local_fraction {rec['local_fraction']:.4f}, "
                   f"all-to-all {rec['all_to_all_bytes']} B, ledger "
                   f"ratio {rec['measured_over_predicted']}"
                   if path == "coded_a2a" else ""))
    log(f"phase 20 {ranks} {backend} ranks on {torch.cuda.device_count()} "
        f"card(s): sharded m={M_RANKS} and coded m={M_CODED} A2A, "
        f"{MX}x{MY} X2Y, spawn to last result "
        f"{wall:.1f} s; no rank ran nvcc")
    return {"ranks": results, "wall_s": wall, "backend": backend}


# ------------------------------------------------------------ mesh= on the
# single-program executors, and the engine's dry run (phase 21)
DRY_M, DRY_D, DRY_Q = 1024, 2048, 32.0    # the reference dry run's defaults
STREAM_MESH_EDITS = 4


def run_stream_edits(w, x_np, mesh=None):
    """``PairwiseService(executor='streaming', use_kernel=True, mesh=mesh)``
    on ``(w, x_np)``: ``load_table`` (phase 17's planner thresholds), then
    ``STREAM_MESH_EDITS`` seeded ``add_input`` edits.  Returns the last
    matrix and the service."""
    svc = PairwiseService(q=Q, executor="streaming", use_kernel=True,
                          mesh=mesh)
    sims, _ = svc.load_table(x_np, w, max_gap=STREAM_MAX_GAP,
                             repack_gap=STREAM_REPACK_GAP, warmup=True)
    rng = np.random.default_rng(SEED + 21)
    for _ in range(STREAM_MESH_EDITS):
        sims, _ = svc.add_input(
            rng.normal(size=x_np.shape[1]).astype(np.float32),
            zipf_size(rng))
    torch.cuda.synchronize()
    return sims, svc


def rank_mesh_paths(rank: int, world: int, a2a, want_stream) -> dict:
    """Phase 21's part on one rank of phase 20's gloo group: fused A2A on
    the ``M_RANKS`` table with ``mesh=group`` (this rank's block of every
    bucket's rows, one launch per bucket) against the parent's
    one-device fused matrix, then the streaming service over the group
    (``load_table`` and ``STREAM_MESH_EDITS`` edits) against the parent's
    one-device streaming matrix, every launch against its plain version;
    then the dry run's coded frontier at the reference's defaults over the
    group, its measured all-to-all bytes against the model."""
    import torch.distributed as dist
    group = dist.group.WORLD
    w, x_np, want_np = a2a
    x = torch.from_numpy(x_np).cuda()
    out = {}
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with KernelSpy() as spy:
        sims, plan, _ = pairwise_similarity(x, q=Q, weights=w,
                                            executor="fused", mesh=group)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    kern = spy.check(f"phase 21 rank {rank} fused mesh")
    assert launched == only(fused_gather_gram=len(plan.buckets)), launched
    want = torch.from_numpy(want_np).cuda()
    torch.testing.assert_close(sims, want, **FP32,
                               msg=lambda m: f"rank {rank} fused mesh: {m}")
    out["fused_a2a"] = {"launches": launched, "kernels": kern,
                        "vs_one_device_max_abs_err": max_err(sims, want),
                        "rows": [b.R // world for b in plan.buckets],
                        "wall_s": wall}
    del sims, want
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with KernelSpy() as spy:
        sims, svc = run_stream_edits(w, x_np, mesh=group)
    wall = time.perf_counter() - t0
    launched = counts()
    kern = spy.check(f"phase 21 rank {rank} streaming mesh")
    assert {k for k, v in launched.items() if v} == {
        "fused_gather_gram", "pairwise_gram"}, launched
    want = torch.from_numpy(want_stream).cuda()
    torch.testing.assert_close(sims, want, **FP32,
                               msg=lambda m: f"rank {rank} stream mesh: {m}")
    out["stream"] = {"launches": launched, "kernels": kern,
                     "vs_one_device_max_abs_err": max_err(sims, want),
                     "stats": svc.executor_stats(), "wall_s": wall}
    del sims, want, svc
    hw = HW.for_device(x.device)
    out["coded"] = {}
    for kind in ("uniform", "zipf"):
        wd = dryrun.profile(DRY_M, DRY_Q, kind == "zipf")
        schema = plan_a2a(wd, DRY_Q)
        dplan = build_plan(schema, pad_reducers_to=world)
        rec = dryrun.analyze_coded(
            dplan, DRY_M, DRY_D, f"coded-frontier[{schema.algorithm}]",
            group, device=x.device, hw=hw)
        for p in rec["pareto_frontier"]:
            assert p["measured_assembly_bytes_per_shard"] == \
                p["model_assembly_bytes_per_shard_fp32"], (rank, kind, p)
        out["coded"][kind] = rec
    return out


def mesh_one_rank_path(name: str, group, x, schema) -> dict:
    """Phase 21 (a): ``pairwise_similarity(executor=name, mesh=group)`` on
    the main path's table (``use_kernel=True`` on dense and bucketed, so
    they launch ``pairwise_gram``), against the same request with
    ``mesh=None``: equal matrices, equal launches, each launch of the
    group's request held against its plain version."""
    uk = name != "fused"
    kernel = "fused_gather_gram" if name == "fused" else "pairwise_gram"
    _build.reset_launch_counts()
    want, plan, _ = pairwise_similarity(x, q=Q, schema=schema,
                                        executor=name, use_kernel=uk)
    torch.cuda.synchronize()
    unsharded = counts()
    gathers = REGISTRY.counter_total("collective.calls", op="all_gather")
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with KernelSpy() as spy:
        got, _, _ = pairwise_similarity(x, q=Q, schema=schema,
                                        executor=name, use_kernel=uk,
                                        mesh=group)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    kern = spy.check(f"phase 21 {name} mesh")
    n = 1 if name == "dense" else len(plan.buckets)
    assert launched == unsharded == only(**{kernel: n}), (launched,
                                                          unsharded)
    torch.testing.assert_close(got, want, **FP32,
                               msg=lambda m: f"phase 21 {name}: {m}")
    rec = {"kernel": kernel, "launches": launched[kernel],
           "max_abs_err": kern[kernel]["max_abs_err"],
           "vs_unsharded_max_abs_err": max_err(got, want),
           "all_gathers": REGISTRY.counter_total(
               "collective.calls", op="all_gather") - gathers,
           "wall_s": wall}
    del got, want
    free_cuda()
    return rec


def dryrun_profile(kind: str, group, hw) -> dict:
    """Phase 21 (c) in this process: the dry run's dense, bucketed, fused,
    sharded and naive rows and the streaming delta at the reference's
    defaults (bf16 tables) over the one-rank group, and its checks: the
    bucketed path's peak allocation exceeds the fused path's by at least
    the largest bucket's gathered (Rb, Lb, d) block less the fused path's
    fp32 blocks (the fused path keeps them in fp32 where the bucketed one
    keeps bf16, and holds one bucket's finishing copy), and the
    planner-vs-naive ratio of ``schema_comm_cost_rows`` is the plans'."""
    w = dryrun.profile(DRY_M, DRY_Q, kind == "zipf")
    t0 = time.perf_counter()
    rows, schema, plan_opt, plan_nv = dryrun.engine_rows(
        w, DRY_Q, DRY_M, DRY_D, group, hw=hw)
    stream = dryrun.analyze_streaming(w, DRY_Q, DRY_M, DRY_D,
                                      "streaming-delta[insert]", hw=hw)
    wall = time.perf_counter() - t0
    bucketed, fused = rows[1], rows[2]
    slack = fused["fused_model"]["block_bytes"]
    need = bucketed["gathered_bytes_max_bucket"] - slack
    saved = fused["saved_peak_alloc_bytes_vs_bucketed"]
    assert saved >= need, (kind, saved, need)
    ratio = plan_opt.comm_cost / plan_nv.comm_cost
    for r in rows[:4]:
        assert r["comm_cost_vs_naive"] == ratio, (r["name"], ratio)
    free_cuda()
    return {"rows": rows, "stream": stream, "wall_s": wall,
            "peak_check": {"saved_peak_alloc_bytes": saved,
                           "gathered_bytes_max_bucket":
                               bucketed["gathered_bytes_max_bucket"],
                           "slack_bytes": slack},
            "comm_cost_vs_naive": ratio}


def phase_mesh(x, schema, ranks) -> dict:
    """Phase 21: ``mesh=`` on the dense, bucketed, fused and streaming
    executors and the engine's dry run.  (a) and the one-rank part of (c)
    run here on an in-process NCCL group of one rank; (b) and the coded
    frontier of (c) ran on phase 20's gloo ranks (``rank_mesh_paths``),
    whose results are checked and printed here."""
    t0 = time.perf_counter()
    out = {"one_rank": {}, "dryrun": {}}
    with one_rank_nccl() as group:
        for name in ("dense", "bucketed", "fused"):
            rec = out["one_rank"][name] = mesh_one_rank_path(name, group, x,
                                                             schema)
            log(f"phase 21 (a) one-rank NCCL group, {name} mesh=group "
                f"m={M}: {rec['kernel']} launches {rec['launches']} (as "
                f"mesh=None), kernel==plain max_abs_err "
                f"{rec['max_abs_err']:.3e}, ==mesh=None max_abs_err "
                f"{rec['vs_unsharded_max_abs_err']:.3e}, all-gathers "
                f"{rec['all_gathers']:.0f}, wall {rec['wall_s']:.2f} s")
        hw = HW.for_device(x.device)
        for kind in ("uniform", "zipf"):
            out["dryrun"][kind] = dryrun_profile(kind, group, hw)
    for r in ranks["ranks"]:
        for path in ("fused_a2a", "stream"):
            rec = r["phase21"][path]
            errs = {k: v["max_abs_err"] for k, v in rec["kernels"].items()}
            log(f"phase 21 (b) rank {r['rank']}/{RANKS} {path} mesh=group: "
                f"launches {nonzero(rec['launches'])}, kernel==plain "
                f"max_abs_err {errs}, ==one device max_abs_err "
                f"{rec['vs_one_device_max_abs_err']:.3e}, wall "
                f"{rec['wall_s']:.2f} s")
    for kind, dr in out["dryrun"].items():
        coded = [r["phase21"]["coded"][kind] for r in ranks["ranks"]]
        log(f"phase 21 (c) dry run m={DRY_M} d={DRY_D} q={DRY_Q} {kind} "
            f"(bf16 tables; one-rank NCCL group, coded on {RANKS} gloo "
            f"ranks), {dr['wall_s']:.1f} s here:")
        for line in dryrun.report_lines(dr["rows"] + coded[:1]
                                        + [dr["stream"]]):
            log(f"  {line}")
        pc = dr["peak_check"]
        measured = [[p["measured_assembly_bytes_per_shard"]
                     for p in c["pareto_frontier"]] for c in coded]
        log(f"phase 21 (c) {kind}: bucketed peak - fused peak "
            f"{pc['saved_peak_alloc_bytes'] / 1e6:.1f} MB >= largest "
            f"gathered bucket {pc['gathered_bytes_max_bucket'] / 1e6:.1f} MB"
            f" - fused fp32 blocks {pc['slack_bytes'] / 1e6:.1f} MB; "
            f"planner/naive schema_comm_cost_rows "
            f"{dr['comm_cost_vs_naive']:.6f} = the plans'; coded measured "
            f"all-to-all bytes per rank and r (== the model on every "
            f"rank): {measured}")
        out["dryrun"][kind]["coded"] = coded
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 21 in this process {out['wall_s']:.1f} s (phase 20's spawn "
        f"ran the ranks' part)")
    return out


# ------------------------------------------------------------ LM serving

def lm_config():
    """jamba-1.5-large-398b at its published widths (d_model 8192, 64 / 8
    heads of 128, d_ff 24576, 16 experts top-2 on every 2nd layer,
    ssm_state 128: 256 SSD heads of 64, vocab 65536), depth cut from 72
    layers to the first 3 of its pattern — attention + dense FFN, Mamba +
    MoE, Mamba + dense — so one card holds it (12.37 B parameters)."""
    return dataclasses.replace(get_config(LM_ARCH), num_layers=LM_LAYERS)


def lm_model(dtype: str, use_pallas: bool = True):
    """The cut model with weights made on the card from seed 0 (the same
    weights in every phase of one dtype)."""
    flags = RuntimeFlags(param_dtype=dtype, compute_dtype=dtype,
                         use_pallas=use_pallas)
    t0 = time.perf_counter()
    model = build_model(lm_config(), flags, device="cuda", seed=SEED)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def lm_tokens(B: int, S: int, seed: int = SEED) -> torch.Tensor:
    cfg = lm_config()
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S))).cuda()


def free_cuda() -> None:
    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def capture_lm_kernels():
    """Record the exact operands and results of every flash / SSD kernel
    call the prefill makes (the wrappers as ``flash.ops`` and ``ssd.ops``
    call them)."""
    calls = {"flash_attention": [], "ssd_scan": []}
    orig = (flash_ops.flash_attention_heads, ssd_ops.ssd_scan_heads)

    def flash(q, k, v, **kw):
        out = orig[0](q, k, v, **kw)
        calls["flash_attention"].append(((q, k, v), kw, out))
        return out

    def scan(x, la, b, c, **kw):
        out = orig[1](x, la, b, c, **kw)
        calls["ssd_scan"].append(((x, la, b, c), kw, out))
        return out

    flash_ops.flash_attention_heads, ssd_ops.ssd_scan_heads = flash, scan
    try:
        yield calls
    finally:
        flash_ops.flash_attention_heads, ssd_ops.ssd_scan_heads = orig


def lm_plain(name: str, args, kw, heads=None):
    """The plain version of one captured call; for flash only the query
    ``heads`` when given (one head's 32k x 32k fp32 scores take 4.3 GB),
    each against its own KV head."""
    if name == "flash_attention":
        if heads is None:
            return mha_ref(*args, **kw)
        q, k, v = args
        g = q.shape[2] // k.shape[2]
        return torch.cat([mha_ref(q[:, :, h:h + 1], k[:, :, h // g:h // g + 1],
                                  v[:, :, h // g:h // g + 1], **kw)
                          for h in heads], dim=2)
    x, la, b, c = args
    return ssd_scan_chunked(x.transpose(1, 2), la.transpose(1, 2),
                            b.transpose(1, 2), c.transpose(1, 2),
                            **kw).transpose(1, 2)


def lm_check_calls(calls, tol, what: str, heads=None) -> dict:
    """Each captured kernel result against its plain version on the same
    operands (flash: only ``heads`` when given); per kernel the max abs
    error, the plain value at that error (in bf16, one rounding step of a
    value in [2^e, 2^(e+1)) is 2^(e-7)) and the mean |output| it is
    measured against."""
    errs, at, mean_abs = {}, {}, {}
    for _, _, b, c in (args for args, _, _ in calls["ssd_scan"]):
        # one B and one C reach the kernel as stride-0 views, not copies
        assert all(t.stride(2) == 0 and t.stride(-1) == 1 for t in (b, c))
    for name, recs in calls.items():
        for args, kw, out in recs:
            sub = heads if name == "flash_attention" else None
            want = lm_plain(name, args, kw, sub).float()
            got = (out if sub is None else out[:, :, list(sub)]).float()
            torch.testing.assert_close(
                got, want, **tol, msg=lambda m: f"{what} {name}: {m}")
            err = max_err(got, want)
            if err >= errs.get(name, 0.0):
                errs[name] = err
                at[name] = (float(want.flatten()[
                    (got - want).abs().argmax()]) if got.numel() else 0.0)
            mean_abs[name] = max(mean_abs.get(name, 0.0),
                                 float(want.abs().mean()))
            del want, got
    log(f"{what}: kernel==plain on the prefill's own operands "
        f"(rtol {tol['rtol']}, atol {tol['atol']}"
        + (f"; flash heads {list(heads)}" if heads else "") + "): "
        + ", ".join(f"{k} {len(calls[k])} calls max_abs_err {v:.3e} at "
                    f"a plain value of {at[k]:.4g} (mean |out| "
                    f"{mean_abs[k]:.3e})" for k, v in errs.items()))
    return {"max_abs_err": errs, "value_at_max_err": at,
            "mean_abs_out": mean_abs}


def lm_work(name: str, args) -> dict:
    """Operations and bytes one kernel call needs for this run's data.
    Flash: 4 D operations per unmasked (query, key) pair (causal: S(S+1)/2
    per head), q, k, v read once and o written once.  SSD: per chunk of q
    rows, q(q+1)/2 (N + P) multiply-adds inside it and 2 q N P for the
    carried state (2 operations each); x, y, log_a once, and the one B and
    C shared by every head once."""
    if name == "flash_attention":
        q, k, v = args
        B, S, H, D = q.shape
        pairs = S * (S + 1) // 2
        ops = 4 * D * pairs * B * H
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        return {"ops": ops, "bytes": nbytes}
    x, la, b, c = args
    B, S, H, P = x.shape
    N = b.shape[3]
    ops = 0
    for t0 in range(0, S, LM_CHUNK):
        ql = min(LM_CHUNK, S - t0)
        ops += 2 * (ql * (ql + 1) // 2 * (N + P) + 2 * ql * N * P)
    ops *= B * H
    shared = b.untyped_storage().nbytes() + c.untyped_storage().nbytes()
    nbytes = 2 * x.numel() * x.element_size() + la.numel() * 4 + shared
    return {"ops": ops, "bytes": nbytes}


def sdpa_ms(q, k, v, iters: int) -> float:
    """The library yardstick for flash: one scaled_dot_product_attention
    call (causal, grouped KV heads) on the same tensors."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    try:
        F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                       enable_gqa=True)
        return time_cuda(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), iters)
    except TypeError:      # torch without enable_gqa: repeat outside timing
        g = q.shape[2] // k.shape[2]
        kt, vt = (t.repeat_interleave(g, dim=1) for t in (kt, vt))
        return time_cuda(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), iters)


def lm_kernel_times(calls, plain: bool, iters: int) -> dict:
    """CUDA-event ms per prefill of each kernel (summed over its calls),
    its plain version and, for flash, SDPA."""
    out = {}
    for name, recs in calls.items():
        t = {"kernel_ms": 0.0, "plain_ms": 0.0 if plain else None,
             "library_ms": None, "bound_ms": 0.0, "calls": len(recs),
             "ops": 0}
        fn = (flash_attention_heads if name == "flash_attention"
              else ssd_scan_heads)
        for args, kw, _ in recs:
            t["kernel_ms"] += time_cuda(lambda: fn(*args, **kw), iters,
                                        warmup=1)
            if plain:
                t["plain_ms"] += time_cuda(
                    lambda: lm_plain(name, args, kw), 2, warmup=1)
            if name == "flash_attention":
                t["library_ms"] = (t["library_ms"] or 0.0) + sdpa_ms(
                    *args, iters)
            w = lm_work(name, args)
            peak = (PEAK_BF16_TENSOR if args[0].dtype == torch.bfloat16
                    else PEAK_FP32_CUDA_CORES)
            b_ms, t["bound_by"] = bound(w, peak)
            t["bound_ms"] += b_ms
            t["ops"] += w["ops"]
        # achieved rate over the work this run's data needs, and the
        # kernel's time over its library call's in the same call
        t["tflops"] = t["ops"] / t["kernel_ms"] / 1e9
        t["ratio_to_library"] = (t["kernel_ms"] / t["library_ms"]
                                 if t["library_ms"] else None)
        out[name] = t
    return out


def ratio_text(t: dict) -> str:
    return (f", {t['kernel_ms'] / t['calls']:.3f} ms per launch, "
            f"{t['tflops']:.1f} TFLOP/s"
            + (f", kernel / library {t['ratio_to_library']:.3f}"
               if t["ratio_to_library"] else ""))


def phase_lm_fp32() -> dict:
    """Phase 12: the fp32 prefill on the kernel route against the
    reference's non-kernel path (use_pallas=False: grouped attention, the
    per-step scan) on the same weights, B=1, S=2048.  Tolerance rtol = atol
    = 2e-3, the reference's own model-level one (tests/test_arch_smoke.py):
    both routes are fp32 throughout (TF32 off), so they differ only by
    summation order, ~1e-5 of logits of size ~2."""
    model, init_s = lm_model("float32")
    tok = lm_tokens(1, LM_S_FP32)
    _build.reset_launch_counts()
    with capture_lm_kernels() as calls:
        t0 = time.perf_counter()
        got, _, aux = model({"tokens": tok})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched = counts()
    assert launched == only(flash_attention=1, ssd_scan=2), launched
    errs = lm_check_calls(calls, LM_FP32, "phase 12 fp32")["max_abs_err"]
    model.flags = dataclasses.replace(model.flags, use_pallas=False)
    t0 = time.perf_counter()
    want, _, want_aux = model({"tokens": tok})
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)
    e = max_err(got, want)
    log(f"phase 12 LM fp32 prefill {LM_ARCH} depth {LM_LAYERS} B=1 "
        f"S={LM_S_FP32}: weights made on the card in {init_s:.2f} s "
        f"({sum(p.numel() for p in model.parameters()) / 1e9:.3f} B "
        f"params); launches {launched}; kernel route {wall:.3f} s, "
        f"use_pallas=False {wall_plain:.3f} s; logits max_abs_err "
        f"{e:.3e} (|logits| max {float(want.abs().max()):.2f}), aux "
        f"{float(aux):.6f} vs {float(want_aux):.6f}")
    out = {"launches": launched, "kernel_errs": errs, "logits_err": e,
           "wall_kernel_s": wall, "wall_plain_s": wall_plain,
           "init_s": init_s}
    del model, got, want, calls
    free_cuda()
    return out


def phase_lm_bf16() -> dict:
    """Phase 13: the bf16 prefill at B=2, S=4096: launch counts, each
    kernel against its plain version on the operands the prefill handed
    it, CUDA-event times of kernels, plain versions and SDPA, the warm
    prefill's wall time and its device profile."""
    model, init_s = lm_model("bfloat16")
    tok = lm_tokens(2, LM_S_BF16)
    model({"tokens": tok})                    # warm: cuBLAS heuristics
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    with capture_lm_kernels() as calls:
        t0 = time.perf_counter()
        logits, _, _ = model({"tokens": tok})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched = counts()
    assert launched == only(flash_attention=1, ssd_scan=2), launched
    assert logits.shape == (2, LM_S_BF16, lm_config().padded_vocab())
    assert bool(torch.isfinite(logits).all())
    del logits
    checked = lm_check_calls(calls, LM_BF16, "phase 13 bf16")
    times = lm_kernel_times(calls, plain=True, iters=5)
    del calls
    prof = profile_request(lambda: model({"tokens": tok}),
                           "phase 13 bf16 prefill")
    split = dict.fromkeys(("flash_attention", "ssd_scan", "gemm", "other"),
                          0.0)
    for name, ms in prof.pop("device_ms_by_name").items():
        kind = ("flash_attention" if "flash_wgmma_kernel" in name
                or "flash_attention_kernel" in name else
                "ssd_scan" if "ssd_scan_" in name else
                "gemm" if any(g in name.lower() for g in
                              ("gemm", "nvjet", "xmma", "cutlass")) else
                "other")
        split[kind] += ms
    prof["device_ms_by_kind"] = split
    log("phase 13 bf16 prefill device ms by kind: " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items()))
    for name, t in times.items():
        log(f"phase 13 {name} per prefill ({t['calls']} call(s)): kernel "
            f"{t['kernel_ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, "
            f"library {t['library_ms']} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}), share {t['bound_ms'] / t['kernel_ms']:.4f}"
            + ratio_text(t))
    log(f"phase 13 LM bf16 prefill B=2 S={LM_S_BF16}: launches {launched}; "
        f"warm prefill {wall:.3f} s wall")
    out = {"launches": launched, "errs": checked["max_abs_err"],
           "mean_abs_out": checked["mean_abs_out"],
           "value_at_max_err": checked["value_at_max_err"],
           "times": times,
           "wall_s": wall, "profile": prof, "init_s": init_s}
    del model
    free_cuda()
    return out


def phase_lm_long() -> dict:
    """Phase 14: the bf16 prefill at the prefill_32k sequence length with
    the batch cut from 32 to 1: wall time (cold and warm), finite logits,
    each kernel against its plain version on the operands the warm prefill
    handed it (SSD on every head; flash on LM_LONG_HEADS, since all 64
    heads' fp32 scores would take 275 GB), and the kernels' times there."""
    model, _ = lm_model("bfloat16")
    tok = lm_tokens(1, LM_S_LONG)
    walls = []
    for rep in range(2):
        _build.reset_launch_counts()
        with capture_lm_kernels() as calls:
            t0 = time.perf_counter()
            logits, _, _ = model({"tokens": tok})
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        launched = counts()
        assert launched == only(flash_attention=1, ssd_scan=2), launched
        assert bool(torch.isfinite(logits).all())
        del logits
        if rep == 0:
            del calls
    peak = torch.cuda.max_memory_allocated() / 2**30
    del model
    free_cuda()
    checked = lm_check_calls(calls, LM_BF16, f"phase 14 bf16 S={LM_S_LONG}",
                             heads=LM_LONG_HEADS)
    times = lm_kernel_times(calls, plain=False, iters=1)
    del calls
    for name, t in times.items():
        log(f"phase 14 {name} per prefill at S={LM_S_LONG}: kernel "
            f"{t['kernel_ms']:.3f} ms, library {t['library_ms']} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}), share "
            f"{t['bound_ms'] / t['kernel_ms']:.4f}" + ratio_text(t))
    log(f"phase 14 LM bf16 prefill B=1 S={LM_S_LONG}: launches {launched}; "
        f"wall cold {walls[0]:.3f} s, warm {walls[1]:.3f} s; logits finite; "
        f"peak device memory {peak:.1f} GiB")
    out = {"launches": launched, "wall_s": walls, "times": times,
           "errs": checked["max_abs_err"],
           "mean_abs_out": checked["mean_abs_out"],
           "value_at_max_err": checked["value_at_max_err"],
           "peak_gib": peak}
    free_cuda()
    return out


def phase_lm_decode() -> dict:
    """Phase 15: BatchedServer with 4 slots answers 8 requests in bf16
    (prompts of 16-64 tokens from numpy seed 0, 16 new tokens, max_len
    128); per-tick decode latency.  Decode reaches no kernel (the cache
    path is plain attention and the step recurrence, as in the
    reference)."""
    model, _ = lm_model("bfloat16")
    cfg = lm_config()
    rng = np.random.default_rng(SEED)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n)
                    .astype(np.int32), max_new_tokens=16)
            for i, n in enumerate(rng.integers(16, 65, 8))]
    server = BatchedServer(model, batch_slots=4, max_len=128)
    for r in reqs:
        server.submit(r)
    _build.reset_launch_counts()
    ticks = []
    t0 = time.perf_counter()
    while True:
        t1 = time.perf_counter()
        live = server.tick()             # ends in the argmax's copy to host
        if live == 0 and not server.queue:
            break
        ticks.append(time.perf_counter() - t1)
    wall = time.perf_counter() - t0
    assert all(r.done and len(r.out) == 16 for r in reqs), \
        [(r.rid, r.done, len(r.out)) for r in reqs]
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.out)
    launched = counts()
    assert launched == only(), launched
    ms = np.asarray(ticks) * 1e3
    out = {"requests": len(reqs), "ticks": len(ticks), "wall_s": wall,
           "tick_median_ms": float(np.median(ms)),
           "tick_p99_ms": float(np.percentile(ms, 99)),
           "tokens": sum(len(r.out) for r in reqs), "launches": launched,
           "prompt_lens": [len(r.prompt) for r in reqs]}
    log(f"phase 15 BatchedServer bf16: {len(reqs)} requests (prompts "
        f"{out['prompt_lens']}) answered, 16 tokens each, in {len(ticks)} "
        f"ticks, {wall:.2f} s; tick median {out['tick_median_ms']:.2f} ms, "
        f"p99 {out['tick_p99_ms']:.2f} ms; kernel launches {launched}")
    del model, server
    free_cuda()
    return out


# ---------------------------------------------------------------- training
# (a) card against CPU: the reference's parameter tolerance
# (tests/test_train_step.py), fp32 with TF32 off on both devices; the
# hybrid (attention, Mamba, MoE) and two models without MoE routing, whose
# comparison no router near-tie can tip
TRAIN_CHECK_ARCHS = ("jamba-1.5-large-398b-smoke", "mamba2-370m-smoke",
                     "gemma3-4b-smoke")
TRAIN_CHECK_B, TRAIN_CHECK_S, TRAIN_CHECK_MICRO = 4, 64, 2
TRAIN_TOL = dict(rtol=2e-3, atol=2e-4)
# (b) stablelm-2-1.6b (hf:stabilityai/stablelm-2-1_6b) whole
TRAIN_ARCH, TRAIN_B, TRAIN_S = "stablelm-1.6b", 4, 2048
TRAIN_STEPS, TRAIN_SAVE_AT, TRAIN_WARMUP = 20, 10, 2
# the step-10 checkpoint (14.4 GB) goes under the checkout's build/
TRAIN_WORK_DIR = Path(__file__).resolve().parent / "build" / "train_ckpt"


def train_batch(vocab: int, B: int, S: int, seed: int = SEED) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "targets": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "mask": (rng.random((B, S)) > 0.1).astype(np.float32)}


def expert_choices(model, batch: dict, microbatch: int) -> list:
    """Per MoE layer and microbatch, the experts each token chose (sorted)
    and the gap between its k-th and (k+1)-th router probability: the
    train step's routing, since its forward runs the same operations on
    the same weights and microbatches."""
    seen, real = [], model_blocks.moe_apply

    def spy(params, x, *, top_k, capacity_factor, rules=None):
        with fgg.ieee_fp32():
            probs = torch.softmax(x.float() @ params["router"], dim=-1)
        top = torch.topk(probs, min(top_k + 1, probs.shape[-1]), dim=-1)
        gap = (top.values[..., top_k - 1] - top.values[..., top_k]
               if top.values.shape[-1] > top_k
               else torch.ones_like(top.values[..., 0]))
        seen.append((top.indices[..., :top_k].sort(dim=-1).values.cpu(),
                     gap.cpu()))
        return real(params, x, top_k=top_k, capacity_factor=capacity_factor,
                    rules=rules)

    n = batch["tokens"].shape[0] // microbatch
    model_blocks.moe_apply = spy
    try:
        with torch.no_grad():
            for i in range(microbatch):
                model({"tokens": torch.as_tensor(
                    batch["tokens"][i * n:(i + 1) * n], device=model.device)})
    finally:
        model_blocks.moe_apply = real
    return seen


def train_check(arch: str, device: str,
                label: str = "phase 22 (a)") -> dict:
    """One fp32 train step (remat 'full', microbatch 2) of ``arch`` on the
    card and on the CPU from the same weights, held at ``TRAIN_TOL``; the
    batch carries the stub frontend's embeddings when ``arch`` has one."""
    cfg = get_config(arch)
    flags = RuntimeFlags(param_dtype="float32", compute_dtype="float32",
                         use_pallas=False, remat="full")
    opt = AdamWConfig(warmup_steps=0, peak_lr=1e-3)
    batch = train_batch(cfg.vocab_size, TRAIN_CHECK_B, TRAIN_CHECK_S)
    batch.update({k: v.numpy() for k, v in frontend_batch(
        cfg, TRAIN_CHECK_B, TRAIN_CHECK_S, "cpu").items() if k != "tokens"})
    models = {dev: build_model(cfg, flags, device=dev)
              for dev in ("cpu", device)}
    # the CPU's weights on the card, bit for bit (the generators differ)
    models[device].load_state_dict(models["cpu"].state_dict())
    routing = None
    if cfg.num_experts:
        (cpu_r, dev_r) = (expert_choices(m, batch, TRAIN_CHECK_MICRO)
                          for m in models.values())
        flipped = [(c_gap[(c_idx != d_idx).any(-1)])
                   for (c_idx, c_gap), (d_idx, _) in zip(cpu_r, dev_r)]
        routing = {
            "tokens": sum(int(g.numel()) for _, g in cpu_r),
            "flipped": sum(int(f.numel()) for f in flipped),
            "flipped_max_gap": max((float(f.max()) for f in flipped
                                    if f.numel()), default=None),
            "min_gap": min(float(g.min()) for _, g in cpu_r)}
    states = {dev: init_state(m, opt) for dev, m in models.items()}
    out = {}
    for dev, model in models.items():
        t0 = time.perf_counter()
        state, metrics = make_train_step(
            model, opt, microbatch=TRAIN_CHECK_MICRO)(states[dev], batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        out[dev] = (state, metrics, time.perf_counter() - t0)
    (cst, cm, cpu_s), (gst, gm, dev_s) = out["cpu"], out[device]
    route = "" if routing is None else (
        f"; routing: {routing['flipped']} of {routing['tokens']} token "
        f"choices differ between card and CPU (largest CPU top-k gap among "
        f"them {routing['flipped_max_gap']}, smallest in the batch "
        f"{routing['min_gap']:.3e})")
    log(f"{label} {arch}: loss {gm['loss']:.6f} vs {cm['loss']:.6f}, "
        f"grad norm {gm['grad_norm']:.6f} vs {cm['grad_norm']:.6f}{route}")
    for k in ("loss", "grad_norm", "ce", "aux", "tokens", "lr"):
        np.testing.assert_allclose(gm[k], cm[k], **TRAIN_TOL,
                                   err_msg=f"{label} {arch} {k}")
    errs = {}
    for part, g_tree, c_tree in (
            [("params", gst["params"], cst["params"])]
            + [(k, gst["opt"][k], cst["opt"][k]) for k in ("m", "v")]):
        worst = 0.0
        for n, c in c_tree.items():
            g = g_tree[n].detach().cpu()
            torch.testing.assert_close(
                g, c.detach(), **TRAIN_TOL,
                msg=lambda m, n=n: f"{label} {arch} {part} {n}: {m}")
            worst = max(worst, max_err(g, c.detach()))
        errs[part] = worst
    log(f"{label} {arch} fp32 remat=full microbatch="
        f"{TRAIN_CHECK_MICRO} B={TRAIN_CHECK_B} S={TRAIN_CHECK_S}: card == "
        f"CPU; max abs err params {errs['params']:.3e}, m {errs['m']:.3e}, "
        f"v {errs['v']:.3e} over {len(cst['params'])} tensors; step "
        f"{dev_s:.2f} s on the card, {cpu_s:.2f} s on the CPU")
    del models, states, out, cst, gst
    return {"metrics_card": gm, "metrics_cpu": cm, "max_abs_err": errs,
            "routing": routing}


def phase_train_card_vs_cpu(device: str = "cuda") -> dict:
    """Phase 22 (a): :func:`train_check` for each of
    ``TRAIN_CHECK_ARCHS``."""
    out = {arch: train_check(arch, device) for arch in TRAIN_CHECK_ARCHS}
    free_cuda()
    return out


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's raw bits, so equality is bit for bit."""
    return t.view({torch.bfloat16: torch.int16, torch.float32: torch.int32}
                  .get(t.dtype, t.dtype))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def train_flops(cfg, n_params: int, B: int, S: int) -> float:
    """Model FLOPs of one training step: 6 N per token plus attention's
    QKᵀ and PV, forward and backward, over the causal half of S x S (the
    plain path also computes the masked half; remat's recompute is not
    counted either)."""
    attn = 6 * cfg.num_layers * cfg.num_heads * cfg.head_dim_() * S * S * B
    return 6.0 * n_params * B * S + attn


def phase_train_full(device: str = "cuda", work_dir=None) -> dict:
    """Phase 22 (b): stablelm-1.6b whole, 20 steps, a checkpoint at step
    10 restored into a fresh trainer."""
    cfg = get_config(TRAIN_ARCH)
    kw = dict(flags=RuntimeFlags(param_dtype="bfloat16",
                                 compute_dtype="bfloat16", use_pallas=False,
                                 remat="full"),
              opt_cfg=AdamWConfig(peak_lr=3e-4, warmup_steps=5,
                                  total_steps=TRAIN_STEPS),
              batch=TRAIN_B, seq=TRAIN_S, seed=SEED, device=device, keep=1)
    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    if work_dir is not None:
        Path(work_dir).mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work_dir) as d:
        t0 = time.perf_counter()
        run1 = train(cfg, TRAIN_SAVE_AT, log=log, ckpt_dir=d,
                     ckpt_every=TRAIN_SAVE_AT, **kw)
        run1_s = time.perf_counter() - t0
        first = run1.pop("trainer")
        n_params = sum(p.numel() for p in first.model.parameters())
        assert run1["saved"] == [TRAIN_SAVE_AT], run1["saved"]
        saved = {k: v.cpu() for k, v in _flat(state_to_reference(
            first.model, first.state)).items()}
        cursor = first.dataset.state()
        want_next = next(iter(first.dataset))
        ckpt_bytes = sum(f.stat().st_size for f in Path(d).rglob("*")
                         if f.is_file())
        del first
        free_cuda()
        t0 = time.perf_counter()
        second = Trainer(cfg, ckpt_dir=d, ckpt_every=0, **kw)
        restore_s = time.perf_counter() - t0
        assert second.start == TRAIN_SAVE_AT, second.start
        restored = _flat(state_to_reference(second.model, second.state))
        assert set(restored) == set(saved)
        for k, v in saved.items():
            r = restored[k].detach().cpu()
            assert r.dtype == v.dtype and r.shape == v.shape, k
            assert torch.equal(_bits(r), _bits(v)), f"phase 22 (b) {k}"
        del restored, saved
        assert second.dataset.state() == cursor, (second.dataset.state(),
                                                  cursor)
        peek = PackedLMDataset(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                               batch_size=TRAIN_B, seed=SEED)
        peek.restore(second.dataset.state())
        got_next = next(iter(peek))
        for k, v in want_next.items():
            np.testing.assert_array_equal(got_next[k], v, err_msg=k)
        t0 = time.perf_counter()
        run2 = second.run(TRAIN_STEPS - 1, log=log)
        run2_s = time.perf_counter() - t0
        last = {}                        # the last step, under the profiler
        prof = profile_request(
            lambda: last.update(second.run(TRAIN_STEPS, log=None)),
            "phase 22 (b) train step")
        del second
    peak = torch.cuda.max_memory_allocated()
    free_cuda()
    launched = counts()
    assert launched == only(), launched
    losses = run1["loss"] + run2["loss"] + last["loss"]
    gnorms = run1["grad_norm"] + run2["grad_norm"] + last["grad_norm"]
    assert len(losses) == TRAIN_STEPS
    assert all(np.isfinite(losses)) and all(np.isfinite(gnorms)), \
        (losses, gnorms)
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    assert last5 < first5, (first5, last5)
    steady = run1["seconds"][TRAIN_WARMUP:] + run2["seconds"][TRAIN_WARMUP:]
    step_s = float(np.median(steady))
    tokens = TRAIN_B * TRAIN_S
    flops = train_flops(cfg, n_params, TRAIN_B, TRAIN_S)
    peak_flops = HW.for_device(device).peak_flops
    out = {"arch": TRAIN_ARCH, "params": n_params, "losses": losses,
           "grad_norms": gnorms, "lr": run1["lr"] + run2["lr"] + last["lr"],
           "step_seconds": run1["seconds"] + run2["seconds"],
           "profiled_step_seconds": last["seconds"], "profile": prof,
           "step_ms_median": step_s * 1e3,
           "step_ms_p90": float(np.percentile(steady, 90)) * 1e3,
           "tokens_per_s": tokens / step_s, "flops_per_step": flops,
           "flop_share": flops / step_s / peak_flops,
           "peak_alloc_bytes": peak, "checkpoint_bytes": ckpt_bytes,
           "run1_s": run1_s, "restore_s": restore_s,
           "run2_s": run2_s, "launches": launched,
           "loss_first5": first5, "loss_last5": last5}
    log(f"phase 22 (b) {TRAIN_ARCH} whole ({n_params / 1e9:.3f} B params, "
        f"{cfg.num_layers} layers, d_model {cfg.d_model}) bf16 remat=full "
        f"B={TRAIN_B} S={TRAIN_S}: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"(mean of first 5 {first5:.4f}, last 5 {last5:.4f}); step "
        f"{out['step_ms_median']:.1f} ms median (p90 "
        f"{out['step_ms_p90']:.1f}) over steps 3-10 and 13-19, "
        f"{out['tokens_per_s']:.0f} tokens/s, model FLOP share "
        f"{out['flop_share']:.3f} of the bf16 peak "
        f"({flops / 1e12:.1f} TFLOP per step); peak allocation "
        f"{peak / 1e9:.2f} GB; checkpoint {ckpt_bytes / 1e9:.2f} GB, "
        f"restore {restore_s:.1f} s, bit-equal, cursor {cursor}, next "
        f"batch equal; kernel launches {launched}")
    return out


def phase_train_refusal(device: str = "cuda") -> dict:
    """Phase 22 (c): the kernel wrappers, and the loss on the kernel
    route, raise under autograd on the card (before any launch)."""
    before = counts()
    gen = torch.Generator(device=device).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    q, k, v = randn(1, 64, 2, 64), randn(1, 64, 2, 64), randn(1, 64, 2, 64)
    x, b = randn(1, 64, 2, 64), randn(1, 64, 2, 16)
    la = -torch.rand((1, 64, 2), generator=gen, device=device)
    cfg = get_config("jamba-1.5-large-398b-smoke")
    model = build_model(cfg, RuntimeFlags(param_dtype="float32",
                                          compute_dtype="float32"),
                        device=device).requires_grad_(True)
    batch = {k: torch.from_numpy(a).to(device) for k, a in train_batch(
        cfg.vocab_size, 2, 32).items()}
    calls = {
        "flash_attention_heads": lambda: flash_attention_heads(
            q.requires_grad_(True), k, v),
        "ssd_scan_heads": lambda: ssd_scan_heads(
            x.requires_grad_(True), la, b, b),
        "LMModel.loss(use_pallas=True)": lambda: model.loss(batch)}
    refused = {}
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            assert "use_pallas=False" in str(e), (name, str(e))
            refused[name] = str(e).split(":")[0]
        else:
            raise AssertionError(f"phase 22 (c) {name} did not refuse")
    assert counts() == before, (counts(), before)
    log(f"phase 22 (c) autograd through the kernel route refused on the "
        f"card: {refused}; no launch")
    del model
    free_cuda()
    return {"refused": refused}


# ------------------------------------ encoder, cross-attention, frontends
# phase 23: whisper-large-v3 whole (arXiv:2212.04356: 32 encoder and 32
# decoder layers, d_model 1280, 20 heads of 64, 1500 encoder frames, 448
# decoder positions) and internvl2-26b at full width (arXiv:2404.16821:
# the InternLM2 backbone, d_model 6144, 48 / 8 heads of 128, d_ff 16384,
# 256 image tokens), both bf16 from seed 0; the frontends are stubs fed
# precomputed embeddings, as in the reference
FE_AUDIO, FE_AUDIO_B, FE_AUDIO_S = "whisper-large-v3", 4, 448
FE_VISION, FE_VISION_B, FE_VISION_S = "internvl2-26b", 2, 1792
FE_TICKS = 16
FE_SMOKE = ("whisper-large-v3-smoke", "internvl2-26b-smoke")
FE_SMOKE_B, FE_SMOKE_S = 2, 64
# bf16 logits of two routes through the whole model (kernel against plain,
# decode against teacher forcing): each route rounds the residual stream
# to bf16 (8 significant bits) several times a layer, independently, and
# a random-init stack amplifies the difference with depth.  The yardstick
# is measured in the same run: the plain route against itself with its
# attention probabilities rounded to bf16 before the PV product (the
# reference's attn_probs_dtype='bfloat16'), which is the rounding the
# tensor-core flash kernel adds.  Held at: RMS of the difference <= 2x
# that yardstick's (relative to the logits' norm), and max abs difference
# <= 5% of max |logits| (4-5 bf16 steps of the largest logit).  A CPU
# rehearsal of whisper's 32 decoder layers gave 0.047 at |logits| <= 3.45
# and an RMS of 1.06%; internvl2's 48 layers reached 2.9% on the card.  A
# single wrong launch is caught by its own check against mha_ref, which
# runs on every launch.
FE_LOGITS_MAX, FE_LOGITS_RMS_FACTOR = 0.05, 2.0
# each bf16 flash launch of phase 23 against mha_ref: the tensor-core
# kernel rounds P to bf16 before the PV product (as SDPA's flash kernels
# do), which moves an output by up to 2^-9 (bf16's unit roundoff) x
# sum_j p_j |v_j|.  Where a row's terms cancel that exceeds LM_BF16's 2e-2
# |o| + 2e-3: on an H100, a whisper row over two keys with |o| = 0.008
# from terms of size ~1 came out 0.0023 off.  Held at LM_BF16 plus twice
# that rounding bound, sum_j p_j |v_j| from the plain version run on
# |v|.
FE_P_ROUNDING = 2.0 ** -8


def logits_drift(got, want) -> dict:
    got, want = got.float(), want.float()
    assert got.shape == want.shape, (got.shape, want.shape)
    return {"max_abs_err": max_err(got, want),
            "max_abs_logit": float(want.abs().max()),
            "rel_rms": float((got - want).norm() / want.norm())}


def check_bf16_logits(got, want, what: str, floor: dict) -> dict:
    """Two bf16 routes' logits: finite, max abs difference within 5% of
    max |want|, RMS within 2x ``floor``'s (``FE_LOGITS_*``)."""
    assert bool(torch.isfinite(got).all()), what
    d = logits_drift(got, want)
    rms_limit = FE_LOGITS_RMS_FACTOR * floor["rel_rms"]
    assert d["max_abs_err"] <= FE_LOGITS_MAX * d["max_abs_logit"] and \
        d["rel_rms"] <= rms_limit, (
            f"{what}: max abs err {d['max_abs_err']:.4g} (limit "
            f"{FE_LOGITS_MAX * d['max_abs_logit']:.4g}), rms "
            f"{d['rel_rms']:.4g} (limit {rms_limit:.4g})")
    return d


def check_flash_bf16(calls, what: str) -> dict:
    """Each captured bf16 flash launch against ``mha_ref`` on its own
    operands, element by element within ``LM_BF16`` plus
    ``FE_P_ROUNDING`` x the plain version on |v|; per launch the max abs
    error, and the largest error over its limit."""
    rt, at = LM_BF16["rtol"], LM_BF16["atol"]
    err = over = mean_abs = 0.0
    for (q, k, v), kw, out in calls["flash_attention"]:
        want = mha_ref(q, k, v, **kw).float()
        mag = mha_ref(q, k, v.abs(), **kw).float()
        diff = (out.float() - want).abs()
        ratio = diff / (rt * want.abs() + at + FE_P_ROUNDING * mag)
        i = int(ratio.argmax())
        r = float(ratio.flatten()[i])
        assert r <= 1.0, (
            f"{what} flash: |got - want| {float(diff.flatten()[i]):.4g} at "
            f"{tuple(np.unravel_index(i, diff.shape))}, want "
            f"{float(want.flatten()[i]):.4g}, sum p|v| "
            f"{float(mag.flatten()[i]):.4g}: {r:.3f} of its limit")
        err, over = max(err, float(diff.max())), max(over, r)
        mean_abs = max(mean_abs, float(want.abs().mean()))
        del want, mag, diff, ratio
    log(f"{what}: flash == plain on the prefill's own operands, "
        f"{len(calls['flash_attention'])} launches, max abs err {err:.3e} "
        f"(mean |out| {mean_abs:.3e}), largest error {over:.3f} of its "
        f"limit (rtol {rt}, atol {at}, + {FE_P_ROUNDING} sum p|v|)")
    return {"max_abs_err": err, "max_err_over_limit": over,
            "mean_abs_out": mean_abs}


def frontend_batch(cfg, B: int, S: int, device, seed: int = SEED) -> dict:
    """Seeded text tokens (B, S) and the stub frontend's precomputed
    embeddings: ``audio_embeds`` (B, S_enc, d) or ``image_embeds`` (B, F,
    d), N(0, 1) in fp32 (the model casts them to its compute dtype)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, S))).to(device)}
    if cfg.frontend == "audio":
        out["audio_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model), dtype=np.float32)).to(device)
    if cfg.frontend == "vision":
        out["image_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.num_frontend_tokens, cfg.d_model),
            dtype=np.float32)).to(device)
    return out


def greedy_against_teacher_forcing(model, batch: dict, ctx: dict,
                                   what: str, floor: dict) -> dict:
    """Prefill the first S - FE_TICKS text tokens (and the image, when the
    batch has one) into a cache in one ``decode_step`` call, hold its
    logits against the kernel-route prefill's, decode FE_TICKS greedy
    ticks, then run the teacher-forced forward (kernel route) over the
    prompt and the generated tokens and hold each tick's logits against
    its position's (``check_bf16_logits`` against ``floor``).  The middle
    tick runs under the profiler and is left out of the tick times.
    ``ctx`` (``enc_out``) goes with every call."""
    tok = batch["tokens"]
    B, S = tok.shape
    P = S - FE_TICKS
    F = batch["image_embeds"].shape[1] if "image_embeds" in batch else 0
    dev = tok.device
    cache = model.init_cache(B, F + S)
    first = {"tokens": tok[:, :P], "pos": torch.arange(F + P, device=dev),
             **ctx}
    if F:
        first["image_embeds"] = batch["image_embeds"]
    t0 = time.perf_counter()
    lg, cache = model.decode_step(cache, first)
    torch.cuda.synchronize()
    cache_prefill_s = time.perf_counter() - t0
    nxt = lg[:, -1].argmax(-1)
    ticks, gen, ms, prof = [], [], [], None
    for t in range(FE_TICKS):
        step = {"tokens": nxt[:, None], "pos": F + P + t, **ctx}
        if t == FE_TICKS // 2:
            held = {}
            prof = profile_request(lambda: held.update(
                r=model.decode_step(cache, step)), f"{what} decode tick")
            out, cache = held["r"]
        else:
            t1 = time.perf_counter()
            out, cache = model.decode_step(cache, step)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
        gen.append(nxt)
        ticks.append(out[:, 0])
        nxt = out[:, 0].argmax(-1)
    seq = torch.cat([tok[:, :P], torch.stack(gen, dim=1)], dim=1)
    tf_batch = {"tokens": seq, **ctx}
    if F:
        tf_batch["image_embeds"] = batch["image_embeds"]
    tf, _, _ = model(tf_batch)
    prefix = check_bf16_logits(lg, tf[:, :P], f"{what} cached prefill",
                               floor)
    dec = check_bf16_logits(torch.stack(ticks, dim=1), tf[:, P:],
                            f"{what} decode", floor)
    prof.pop("device_ms_by_name")
    return {"prompt": P, "ticks": FE_TICKS, "tick_ms": ms,
            "tick_median_ms": float(np.median(ms)),
            "cache_prefill_s": cache_prefill_s, "cached_prefill": prefix,
            "decode_vs_teacher_forcing": dec, "tick_profile": prof}


def frontend_prefill(model, batch: dict, what: str):
    """The kernel-route prefill (``cache=None``), warm: flash once per
    decoder layer, each launch held against ``mha_ref`` on its own
    operands (``check_flash_bf16``) and timed beside SDPA; then the same
    model's ``use_pallas=False`` logits.  Returns the record and the
    logits."""
    cfg = model.cfg
    model(batch)                                  # warm: cuBLAS heuristics
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    with capture_lm_kernels() as calls:
        t0 = time.perf_counter()
        logits, _, _ = model(batch)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    launched = counts()
    assert launched == only(flash_attention=cfg.num_layers), launched
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_()
    B, S = batch["tokens"].shape
    S += cfg.num_frontend_tokens if "image_embeds" in batch else 0
    for (q, k, _), kw, _ in calls["flash_attention"]:
        assert tuple(q.shape) == (B, S, H, D) and \
            tuple(k.shape) == (B, S, Hkv, D) and kw["causal"], (
                q.shape, k.shape, kw)
    assert not calls["ssd_scan"]
    checked = check_flash_bf16(calls, what)
    times = lm_kernel_times({"flash_attention": calls["flash_attention"]},
                            plain=False, iters=5)["flash_attention"]
    del calls
    flags = model.flags
    model.flags = dataclasses.replace(flags, use_pallas=False)
    want, _, _ = model(batch)
    model.flags = dataclasses.replace(flags, use_pallas=False,
                                      attn_probs_dtype="bfloat16")
    alt, _, _ = model(batch)
    model.flags = flags
    floor = logits_drift(alt, want)
    del alt
    routes = check_bf16_logits(logits, want, f"{what} kernel vs plain route",
                               floor)
    del want
    n = times["calls"]
    log(f"{what} prefill B={B} S={S} (kernel route, warm): "
        f"{prefill_s * 1e3:.1f} ms; launches {launched}; flash per launch "
        f"(q {(B, S, H, D)}, {Hkv} KV heads) {times['kernel_ms'] / n:.4f} "
        f"ms, SDPA {times['library_ms'] / n:.4f} ms, bound "
        f"{times['bound_ms'] / n:.4f} ms ({times['bound_by']}), share "
        f"{times['bound_ms'] / times['kernel_ms']:.3f}, "
        f"{times['tflops']:.1f} TFLOP/s; logits kernel vs plain route: "
        f"max abs err {routes['max_abs_err']:.4g} at max |logit| "
        f"{routes['max_abs_logit']:.4g}, rms {routes['rel_rms']:.4g}; plain "
        f"route with bf16 probabilities vs plain: max abs err "
        f"{floor['max_abs_err']:.4g}, rms {floor['rel_rms']:.4g}")
    return {"launches": launched, "prefill_ms": prefill_s * 1e3,
            "flash": {"launches": launched["flash_attention"],
                      "shape_q": [B, S, H, D], "kv_heads": Hkv,
                      "max_abs_err": checked["max_abs_err"],
                      "max_err_over_limit": checked["max_err_over_limit"],
                      "mean_abs_out": checked["mean_abs_out"],
                      "ms": times["kernel_ms"],
                      "ms_per_launch": times["kernel_ms"] / n,
                      "library_ms": times["library_ms"],
                      "library_ms_per_launch": times["library_ms"] / n,
                      "bound_ms": times["bound_ms"],
                      "bound_ms_per_launch": times["bound_ms"] / n,
                      "bound_by": times["bound_by"],
                      "tflops": times["tflops"],
                      "plain_ms": None},
            "routes": routes, "bf16_probs_drift": floor}, logits


def frontend_model(cfg, device):
    flags = RuntimeFlags(param_dtype="bfloat16", compute_dtype="bfloat16",
                         use_pallas=True)
    t0 = time.perf_counter()
    model = build_model(cfg, flags, device=device, seed=SEED)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def phase_fe_audio(device: str = "cuda") -> dict:
    """Phase 23 (a): whisper-large-v3 whole, bf16: the prefill of 448
    decoder tokens over 1500 audio frames (``frontend_prefill``), the
    encoder alone, and 16 greedy ticks on a precomputed ``enc_out``
    against teacher forcing."""
    cfg = get_config(FE_AUDIO)
    model, init_s = frontend_model(cfg, device)
    n_params = sum(p.numel() for p in model.parameters())
    batch = frontend_batch(cfg, FE_AUDIO_B, FE_AUDIO_S, device)
    what = f"phase 23 (a) {FE_AUDIO}"
    out, _ = frontend_prefill(model, batch, what)
    floor = out["bf16_probs_drift"]
    t0 = time.perf_counter()
    enc_out = model._encode(batch["audio_embeds"])
    torch.cuda.synchronize()
    encoder_s = time.perf_counter() - t0
    assert enc_out.shape == (FE_AUDIO_B, cfg.encoder_seq, cfg.d_model)
    assert bool(torch.isfinite(enc_out).all())
    _build.reset_launch_counts()
    dec = greedy_against_teacher_forcing(model, batch, {"enc_out": enc_out},
                                         what, floor)
    out.update(arch=FE_AUDIO, params=n_params, init_s=init_s,
               encoder_ms=encoder_s * 1e3, decode=dec)
    log(f"{what} whole ({n_params / 1e9:.3f} B params, {cfg.encoder_layers}"
        f" + {cfg.num_layers} layers): encoder {encoder_s * 1e3:.1f} ms for "
        f"{FE_AUDIO_B} x {cfg.encoder_seq} frames; prefill "
        f"{out['prefill_ms']:.1f} ms (encoder included); cached prefill of "
        f"{dec['prompt']} tokens {dec['cache_prefill_s'] * 1e3:.1f} ms; "
        f"tick median {dec['tick_median_ms']:.2f} ms over {FE_TICKS} greedy "
        f"ticks; decode vs teacher forcing max abs err "
        f"{dec['decode_vs_teacher_forcing']['max_abs_err']:.4g}, rms "
        f"{dec['decode_vs_teacher_forcing']['rel_rms']:.4g}")
    del model, enc_out, batch
    free_cuda()
    return out


def phase_fe_vision(device: str = "cuda") -> dict:
    """Phase 23 (b): internvl2-26b whole (all 48 layers, 19.3 B
    parameters), bf16: 256 image embeds prepended to 1792 text tokens (a
    2048-token causal prefill), then the image and 1776 tokens prefilled
    into a cache and 16 greedy ticks against teacher forcing."""
    cfg = get_config(FE_VISION)
    model, init_s = frontend_model(cfg, device)
    n_params = sum(p.numel() for p in model.parameters())
    batch = frontend_batch(cfg, FE_VISION_B, FE_VISION_S, device)
    what = f"phase 23 (b) {FE_VISION}"
    out, logits = frontend_prefill(model, batch, what)
    floor = out["bf16_probs_drift"]
    assert logits.shape == (FE_VISION_B, FE_VISION_S, cfg.padded_vocab())
    del logits
    _build.reset_launch_counts()
    dec = greedy_against_teacher_forcing(model, batch, {}, what, floor)
    peak = torch.cuda.max_memory_allocated()
    out.update(arch=FE_VISION, layers=cfg.num_layers, params=n_params,
               init_s=init_s, decode=dec, peak_alloc_bytes=peak)
    log(f"{what} whole ({cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B params, made on the card in {init_s:.2f} "
        f"s): prefill {out['prefill_ms']:.1f} ms; cached prefill "
        f"{dec['cache_prefill_s'] * 1e3:.1f} ms; tick median "
        f"{dec['tick_median_ms']:.2f} ms over {FE_TICKS} greedy ticks; "
        f"decode vs teacher forcing max abs err "
        f"{dec['decode_vs_teacher_forcing']['max_abs_err']:.4g}, rms "
        f"{dec['decode_vs_teacher_forcing']['rel_rms']:.4g}; peak "
        f"allocation {peak / 1e9:.2f} GB")
    del model, batch
    free_cuda()
    return out


def serve_check(arch: str, device: str) -> dict:
    """Phase 23 (c) serving: fp32 ``use_pallas=False`` (the reduced
    configs' 16-wide heads take no kernel) on the CPU and on ``device``
    from the same weights: prefill logits, then 8 decode steps (whisper
    on each device's own ``enc_out``, internvl2 after an image + prompt
    prefill into the cache), each at ``LM_FP32``."""
    cfg = get_config(arch)
    flags = RuntimeFlags(param_dtype="float32", compute_dtype="float32",
                         use_pallas=False)
    models = {dev: build_model(cfg, flags, device=dev)
              for dev in ("cpu", device)}
    models[device].load_state_dict(models["cpu"].state_dict())
    batch = frontend_batch(cfg, FE_SMOKE_B, FE_SMOKE_S, "cpu")
    F = cfg.num_frontend_tokens if "image_embeds" in batch else 0
    P, steps = FE_SMOKE_S - 8, 8
    out = {}
    for dev, model in models.items():
        b = {k: v.to(dev) for k, v in batch.items()}
        logits, _, _ = model(b)
        ctx = ({"enc_out": model._encode(b["audio_embeds"])}
               if "audio_embeds" in b else {})
        cache = model.init_cache(FE_SMOKE_B, F + FE_SMOKE_S)
        first = {"tokens": b["tokens"][:, :P],
                 "pos": torch.arange(F + P, device=dev), **ctx}
        if F:
            first["image_embeds"] = b["image_embeds"]
        lg, cache = model.decode_step(cache, first)
        dec = [lg]
        for t in range(P, P + steps):
            lg, cache = model.decode_step(cache, {
                "tokens": b["tokens"][:, t:t + 1], "pos": F + t, **ctx})
            dec.append(lg)
        out[dev] = (logits.cpu(), torch.cat(dec, dim=1).cpu(),
                    ctx.get("enc_out"))
    (c_log, c_dec, c_enc), (g_log, g_dec, g_enc) = out["cpu"], out[device]
    errs = {}
    for name, got, want in (("prefill", g_log, c_log),
                            ("decode", g_dec, c_dec),
                            ("teacher_forcing", c_dec, c_log)):
        torch.testing.assert_close(
            got, want, **LM_FP32,
            msg=lambda m, n=name: f"phase 23 (c) {arch} {n}: {m}")
        errs[name] = max_err(got, want)
    if c_enc is not None:
        torch.testing.assert_close(g_enc.cpu(), c_enc, **LM_FP32)
        errs["enc_out"] = max_err(g_enc.cpu(), c_enc)
    log(f"phase 23 (c) {arch} fp32 serving, card == CPU at rtol "
        f"{LM_FP32['rtol']} / atol {LM_FP32['atol']}: max abs err "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    return errs


def phase_fe_card_vs_cpu(device: str = "cuda") -> dict:
    """Phase 23 (c): the reduced configs on the card against the CPU:
    serving (``serve_check``) and one train step (``train_check``, the
    frontend's embeds in the batch) each."""
    out = {arch: {"serving": serve_check(arch, device),
                  "train": train_check(arch, device, "phase 23 (c)")}
           for arch in FE_SMOKE}
    free_cuda()
    return out


# ------------------------------- LM sharding, GPipe and the LM dry run
# (phase 24).  (a) asks whether gloo takes CUDA tensors; (b)-(c) run the
# LM stack on a DeviceMesh on the card: a 2 x 2 ('data', 'model') mesh of
# 4 gloo ranks if it does, else a one-rank NCCL mesh (every placement
# degenerate, every code path on CUDA); tools/nccl_ranks.py --lm runs them
# at 2 x 2 over NCCL, one rank per card.  (d) GPipe over 4 gloo ranks on
# the card (activations through the host), (e) the dry run in a
# subprocess, (f) its memory count and (g) size-1 dims on size-1 axes on
# the one-rank NCCL mesh.
GLOO_OPS = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
            "all_to_all_single")
MESH_TRAIN_ARCH, MESH_TRAIN_STEPS, MESH_TRAIN_RTOL = "stablelm-1.6b", 5, 1e-2
MESH_SMOKE_ARCHS = ("jamba-1.5-large-398b-smoke", "gemma3-4b-smoke")
PP_ARCH, PP_STAGES, PP_MICRO, PP_S = "stablelm-1.6b", 4, 8, 2048
# (f): (arch, depth cut or None, shape, (seq, global batch)), each with
# default_flags on a 1 x 1 mesh.  mamba2 at 4 x 512: the per-position SSD
# loop's saved states (1 MB per position and sequence) set the peak there,
# and 512 positions halve the eager loop's time against 2 x 1024 (at 1 x
# 1024 AdamW's fp32 temporaries set it and the repeat rule goes unchecked)
MEM_WITNESSES = [("stablelm-1.6b", None, "train_4k", (2048, 4)),
                 ("jamba-1.5-large-398b", 3, "prefill_32k", (4096, 2)),
                 ("mamba2-370m", 4, "train_4k", (512, 4)),
                 ("stablelm-1.6b", None, "decode_32k", (4096, 8))]
MEM_RTOL = 0.05
DRY_CELLS = [(a, s, mp) for a, s in (("stablelm-1.6b", "train_4k"),
                                     ("stablelm-1.6b", "prefill_32k"),
                                     ("stablelm-1.6b", "decode_32k"))
             for mp in (False, True)] + [
    ("jamba-1.5-large-398b", "train_4k", True)]


GLOO_PROBE_SIZES = ((torch.float32, 8), (torch.bfloat16, 8),
                    (torch.bfloat16, 1 << 25),     # 64 MB
                    (torch.bfloat16, 1 << 27))     # 256 MB: a big weight
GLOO_PROBE_REPEATS = 3


def _gloo_op(op: str, rank: int, n: int, dtype, numel: int, group=None,
             dev="cuda:0") -> bool:
    """One ``op`` on tensors of ``dev`` over ``group`` (``n`` ranks, this
    one ``rank`` in it; None: the default group); True when the result is
    right."""
    import torch.distributed as dist
    dev = torch.device(dev)
    per = max(1, numel // n)
    if op == "all_reduce":
        t = torch.full((numel,), float(rank + 1), device=dev, dtype=dtype)
        dist.all_reduce(t, group=group)
        ok = bool((t == n * (n + 1) / 2).all())
    elif op == "all_gather_into_tensor":
        t = torch.full((per,), float(rank), device=dev, dtype=dtype)
        o = torch.empty(per * n, device=dev, dtype=dtype)
        dist.all_gather_into_tensor(o, t, group=group)
        ok = bool((o.view(n, per) == torch.arange(
            n, device=dev, dtype=dtype)[:, None]).all())
    elif op == "reduce_scatter_tensor":
        t = torch.full((per * n,), float(rank + 1), device=dev, dtype=dtype)
        o = torch.empty(per, device=dev, dtype=dtype)
        dist.reduce_scatter_tensor(o, t, group=group)
        ok = bool((o == n * (n + 1) / 2).all())
    else:
        t = (torch.arange(n, device=dev, dtype=dtype) + 10 * rank)[
            :, None].expand(n, per).contiguous().view(-1)
        o = torch.empty_like(t)
        dist.all_to_all_single(o, t, group=group)
        ok = bool((o.view(n, per)[:, 0] == torch.arange(
            n, device=dev, dtype=dtype) * 10 + rank).all())
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return ok


def gloo_cuda_op(rank: int, world: int, ops) -> str:
    """``ops`` in order on CUDA tensors of card 0 over a gloo group and
    over its halves (two-rank subgroups, as a 2 x 2 mesh's dims are), each
    at every ``GLOO_PROBE_SIZES`` size, ``GLOO_PROBE_REPEATS`` times:
    "ok", "wrong values", or the error's first line."""
    import torch.distributed as dist
    torch.cuda.set_device(0)
    half = world // 2
    subs = [dist.new_group(list(range(i, i + half)))
            for i in range(0, world, half)]
    sub = subs[rank // half]
    try:
        ok = all(_gloo_op(op, r, n, dt, numel, g)
                 for g, n, r in ((None, world, rank),
                                 (sub, half, rank % half))
                 for _ in range(GLOO_PROBE_REPEATS)
                 for dt, numel in GLOO_PROBE_SIZES for op in ops)
        return "ok" if ok else "wrong values"
    except Exception as e:   # noqa: BLE001 — the answer, not a failure
        return f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"


def gloo_cuda_dtensor(rank: int, world: int, dev: str = "cuda") -> str:
    """DTensor's own redistributions on a 2 x 2 ('data', 'model') gloo mesh
    of CUDA tensors, as the LM stack issues them: a split weight's
    non-contiguous column chunk gathered back (ZeRO-1), a partial sum
    reduced, and a vocabulary-split fp32 logits block (800 MB a rank)
    gathered.  "ok", "wrong values", or the error's first line."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import distribute_tensor
    if dev == "cuda":
        torch.cuda.set_device(0)
    try:
        mesh = make_mesh((2, 2), ("data", "model"), device_type=dev)
        g = torch.Generator(device=dev).manual_seed(0)
        w = torch.randn(8192, 4096, device=dev, generator=g).bfloat16()
        d = distribute_tensor(w, mesh, (Replicate(), Shard(0)))
        cols = d.redistribute(mesh, (Shard(1), Shard(0)))
        ok = torch.equal(cols.redistribute(mesh, (Replicate(), Shard(0)))
                         .to_local(), d.to_local())
        part = distribute_tensor(w, mesh, (Replicate(), Replicate()))
        part = type(part).from_local(part.to_local(), mesh,
                                     (Partial(), Replicate()))
        ok &= torch.equal(part.full_tensor(), w * 2)
        big = torch.randn(2, 2048, 50176, device=dev, generator=g)
        bd = distribute_tensor(big, mesh, (Shard(0), Shard(2)))
        ok &= torch.equal(bd.redistribute(mesh, (Shard(0), Replicate()))
                          .to_local(), big[rank // 2:rank // 2 + 1])
        return "ok" if ok else "wrong values"
    except Exception as e:   # noqa: BLE001 — the answer, not a failure
        return f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"


def phase_mesh_probe() -> dict:
    """Phase 24 (a): each of the four collectives DTensor issues on CUDA
    tensors of a 4-rank gloo group on the one card, and of its two-rank
    subgroups (fp32 and bf16, 8 elements to 256 MB, three times), each op
    in its own group, all four in sequence in a fifth, and DTensor's own
    redistributions on a 2 x 2 mesh in a sixth (``gloo_cuda_dtensor``),
    the six groups spawned together.  A rank that dies is an answer
    ("no"), recorded, not a failed phase."""
    import threading
    t0 = time.perf_counter()
    res: dict = {}
    cases = {op: (gloo_cuda_op, (op,)) for op in GLOO_OPS}
    cases["in_sequence"] = (gloo_cuda_op, GLOO_OPS)
    cases["dtensor_2x2"] = (gloo_cuda_dtensor,)

    def one(name):
        try:
            got = compat.run_local_group(cases[name][0], RANKS,
                                         *cases[name][1:], timeout_s=60.0)
            res[name] = got[0] if len(set(got)) == 1 else "; ".join(got)
        except (RuntimeError, TimeoutError) as e:
            res[name] = f"ranks failed: {str(e).splitlines()[0][:200]}"
    threads = [threading.Thread(target=one, args=(c,)) for c in cases]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    out = {"ops": {c: res[c] for c in cases},
           "gloo_takes_cuda": all(res[c] == "ok" for c in cases),
           "seconds": time.perf_counter() - t0}
    log(f"phase 24 (a) gloo on CUDA tensors, {RANKS} ranks on one card: "
        + "; ".join(f"{k}: {v}" for k, v in out["ops"].items())
        + f" -> (b)-(c) on "
        + ("a 2 x 2 gloo mesh" if out["gloo_takes_cuda"]
           else "a one-rank NCCL mesh") + f" ({out['seconds']:.1f} s)")
    return out


def _dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def mesh_collectives(fn) -> dict:
    """Collective bytes (the reference's ring accounting) and calls by
    kind of one call of ``fn`` on this rank (``launch.op_analysis``)."""
    from repro_torch.launch.op_analysis import count_ops
    _, st = count_ops(fn)
    return {"bytes": st.collective_by_kind, "calls": st.collective_calls,
            "flops": st.flops}


def in_turn(build):
    """``build()`` on each rank of the default group in turn (a barrier
    after each), so the ranks sharing a card never hold their largest
    temporaries at once, and each gives its allocator's cache back before
    the next starts."""
    import torch.distributed as dist
    out = None
    for r in range(dist.get_world_size()):
        if r == dist.get_rank():
            out = build()
            free_cuda()       # the whole tensors drawn, cached: give back
        dist.barrier()
    return out


# the sharded bf16 logits may drift from the fp32 function at most this
# many times as far as the one-rank bf16 logits do (RMS over the rank's
# block): the partial sums of split products are rounded to bf16 once
# more, and a token whose top-2 experts are a near tie may route apart
MESH_LOGITS_RMS_FACTOR = 2.0


def _load(t, block):
    """``t[block]`` of a tensor or of a ``torch.save`` file (mapped)."""
    if not torch.is_tensor(t):
        t = torch.load(t, mmap=True)
    return t[block]


def sharded_logits_check(local, off, want, what: str) -> dict:
    """This rank's block of the sharded bf16 logits against the same block
    of the one-rank fp32 logits (``want[1]``), beside the one-rank bf16
    logits' (``want[0]``) distance from them: relative RMS within
    ``MESH_LOGITS_RMS_FACTOR`` times that yardstick, all finite
    (``what`` names the check in a failure)."""
    block = tuple(slice(o, o + n) for o, n in zip(off, local.shape))
    bf16, fp32 = (_load(t, block) for t in want)
    sq = {"mesh": 0.0, "one_rank": 0.0, "ref": 0.0}
    max_abs = 0.0
    for i in range(0, local.shape[1], 512):          # a slice at a time
        got = local[:, i:i + 512].float()
        ref = fp32[:, i:i + 512].cuda().float()
        one = bf16[:, i:i + 512].cuda().float()
        assert bool(torch.isfinite(got).all()), f"{what} logits"
        sq["mesh"] += float((got - ref).square().sum())
        sq["one_rank"] += float((one - ref).square().sum())
        sq["ref"] += float(ref.square().sum())
        max_abs = max(max_abs, max_err(got, one))
        del got, ref, one
    rms = {k: (sq[k] / sq["ref"]) ** 0.5 for k in ("mesh", "one_rank")}
    assert rms["mesh"] <= MESH_LOGITS_RMS_FACTOR * rms["one_rank"], (
        f"{what}: sharded bf16 logits at relative RMS "
        f"{rms['mesh']:.4g} from fp32, one rank's at {rms['one_rank']:.4g}")
    return {"rel_rms": rms["mesh"], "one_rank_rel_rms": rms["one_rank"],
            "max_abs_diff_to_one_rank": max_abs}


def lm_mesh_rank(rank: int, world: int, shape: tuple, want_logits,
                 want_losses, smoke_want) -> dict:
    """Phase 24 (b)-(c) on one rank of the default group, on a ``shape``
    ('data', 'model') mesh of CUDA devices: the sharded Jamba prefill
    (each kernel launch against its plain version on its local operands,
    each rank's block of the logits against ``want_logits``, the one-rank
    bf16 and fp32 logits: ``sharded_logits_check``), the sharded stablelm
    train steps (losses against ``want_losses``, ZeRO-1 local sizes), and
    one FSDP step of each smoke config against ``smoke_want``."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.rules import rules_for
    from repro_torch.launch.specs import default_flags
    from repro_torch.models.lm import distribute_model
    from repro_torch.parallel.local import global_offset
    from repro_torch.train.train_step import make_state_shardings
    import faulthandler
    faulthandler.enable(all_threads=True)    # a crash names its line
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(rank % torch.cuda.device_count())
    out = {"rank": rank, "builds_before": _build.build_counts()}
    mesh = make_mesh(shape, ("data", "model"), device_type="cuda")

    # (b) jamba cut to 3 layers, bf16, 2 x 4096
    cfg = lm_config()
    flags = RuntimeFlags(param_dtype="bfloat16", compute_dtype="bfloat16")
    rules = rules_for(cfg, mesh, flags)
    # each parameter placed as it is drawn: no rank holds the whole model
    model = in_turn(lambda: build_model(
        cfg, flags, rules, device="cuda", seed=SEED, mesh=mesh))
    tok = lm_tokens(2, LM_S_BF16)
    with torch.no_grad():
        model({"tokens": tok})                         # warm
        torch.cuda.synchronize()
        dist.barrier()
        _build.reset_launch_counts()
        with capture_lm_kernels() as calls:
            t0 = time.perf_counter()
            logits = model({"tokens": tok})[0]
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
        launched = counts()
        coll = mesh_collectives(lambda: model({"tokens": tok}))
    assert launched == only(flash_attention=1, ssd_scan=2), launched
    for name, recs in calls.items():
        for args, _, res in recs:
            assert not any(_dtensor(a) for a in (*args, res)), name
    local, (b0, s0, v0) = logits.to_local(), global_offset(logits)[1]
    del logits, model
    free_cuda()
    # the plain versions' fp32 scores: one rank at a time on the card
    checked = in_turn(lambda: lm_check_calls(
        calls, LM_BF16, f"phase 24 (b) rank {rank}"))
    times = in_turn(lambda: lm_kernel_times(calls, plain=False, iters=3))
    del calls
    if want_logits is not None:
        out["logits"] = sharded_logits_check(local, (b0, s0, v0),
                                             want_logits,
                                             f"phase 24 (b) rank {rank}")
    del local
    free_cuda()
    out["prefill"] = {"ms": prefill_ms, "launches": launched,
                      "errs": checked["max_abs_err"],
                      "kernel_ms": {k: t["kernel_ms"]
                                    for k, t in times.items()},
                      "collectives": coll}

    # (c) stablelm-1.6b whole, the reference's flags for its train cell
    cfg = get_config(MESH_TRAIN_ARCH)
    flags = dataclasses.replace(default_flags(cfg, "train_4k", mesh),
                                use_pallas=False)
    rules = rules_for(cfg, mesh, flags)
    model = in_turn(lambda: build_model(
        cfg, flags, rules, device="cuda", seed=SEED, mesh=mesh))
    opt = AdamWConfig(peak_lr=3e-4, warmup_steps=2, total_steps=100)
    state = init_state(model, opt)
    sh = make_state_shardings(model, mesh, rules, zero1=flags.zero1)
    for n, t in state["opt"]["m"].items():
        assert tuple(t.placements) == sh["opt"]["m"][n], n
        local, _ = global_offset(t)
        assert tuple(t.to_local().shape) == tuple(local), n
    step = make_train_step(model, opt)
    data = iter(PackedLMDataset(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                                batch_size=TRAIN_B, seed=SEED))
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for i in range(MESH_TRAIN_STEPS):
        batch = next(data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(met["loss"]))
    if want_losses is not None:
        for got, want in zip(losses, want_losses):
            assert abs(got - want) <= MESH_TRAIN_RTOL * abs(want), \
                (losses, want_losses)
    out["train"] = {
        "flags": {k: getattr(flags, k) for k in ("fsdp", "zero1", "remat")},
        "losses": losses, "step_ms": step_ms,
        "tokens_per_s": TRAIN_B * TRAIN_S / (float(np.median(
            step_ms[1:])) / 1e3),
        "peak_alloc_bytes": torch.cuda.max_memory_allocated(),
        "moment_local_bytes": sum(t.to_local().numel() * t.element_size()
                                  for t in state["opt"]["m"].values())}
    del state, model, step
    free_cuda()

    # (c) one fp32 FSDP step of each smoke config
    out["smoke"] = {}
    for arch in MESH_SMOKE_ARCHS:
        cfg = get_config(arch)
        flags = RuntimeFlags(param_dtype="float32", compute_dtype="float32",
                             use_pallas=False, fsdp=True)
        rules = rules_for(cfg, mesh, flags)
        model = distribute_model(build_model(cfg, flags, rules,
                                             device="cuda", seed=SEED),
                                 mesh, rules)
        opt = AdamWConfig(warmup_steps=0)
        state = init_state(model, opt)
        state, met = make_train_step(model, opt)(
            state, train_batch(cfg.vocab_size, TRAIN_CHECK_B,
                               TRAIN_CHECK_S))
        if smoke_want is not None:
            want = smoke_want[arch]
            np.testing.assert_allclose(float(met["loss"]), want["loss"],
                                       **TRAIN_TOL)
            for n, p in state["params"].items():
                torch.testing.assert_close(
                    p.full_tensor().detach().cpu(), want["params"][n],
                    **TRAIN_TOL)
            for n, t in state["opt"]["v"].items():
                torch.testing.assert_close(t.full_tensor().cpu(),
                                           want["v"][n], **TRAIN_TOL)
        out["smoke"][arch] = float(met["loss"])
        del state, model
        free_cuda()
    out["builds_after"] = _build.build_counts()
    return out


def one_rank_logits():
    """Phase 24 (b)'s yardsticks: the cut Jamba's 2 x 4096 prefill logits
    with no mesh in bf16 (and its warm ms) and in fp32, on the host."""
    tok = lm_tokens(2, LM_S_BF16)
    out, ms = [], None
    for dtype in ("bfloat16", "float32"):
        model, _ = lm_model(dtype)
        with torch.no_grad():
            if dtype == "bfloat16":
                model({"tokens": tok})
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits = model({"tokens": tok})[0]
            torch.cuda.synchronize()
            ms = ms or (time.perf_counter() - t1) * 1e3
            out.append(logits.cpu())
        del model, logits
        free_cuda()
    return out, ms


def one_rank_smoke_steps() -> dict:
    """Phase 24 (c)'s yardstick: one fp32 step of each smoke config on one
    card with no mesh (the weights and batch the mesh step takes)."""
    out = {}
    for arch in MESH_SMOKE_ARCHS:
        cfg = get_config(arch)
        model = build_model(cfg, RuntimeFlags(
            param_dtype="float32", compute_dtype="float32",
            use_pallas=False), device="cuda", seed=SEED)
        opt = AdamWConfig(warmup_steps=0)
        state, met = make_train_step(model, opt)(
            init_state(model, opt),
            train_batch(cfg.vocab_size, TRAIN_CHECK_B, TRAIN_CHECK_S))
        out[arch] = {"loss": float(met["loss"]),
                     "params": {n: p.detach().cpu()
                                for n, p in state["params"].items()},
                     "v": {n: t.cpu() for n, t in state["opt"]["v"].items()}}
        del state, model
        free_cuda()
    return out


def one_rank_train_losses() -> dict:
    """Phase 24 (c)'s one-rank run: the same weights, flags and batches
    with no mesh."""
    from repro_torch.launch.specs import default_flags
    cfg = get_config(MESH_TRAIN_ARCH)
    flags = dataclasses.replace(default_flags(cfg, "train_4k"),
                                use_pallas=False)
    model = build_model(cfg, flags, device="cuda", seed=SEED)
    opt = AdamWConfig(peak_lr=3e-4, warmup_steps=2, total_steps=100)
    state, step = init_state(model, opt), make_train_step(model, opt)
    data = iter(PackedLMDataset(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                                batch_size=TRAIN_B, seed=SEED))
    losses, step_ms = [], []
    for _ in range(MESH_TRAIN_STEPS):
        batch = next(data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(met["loss"]))
    del state, model, step
    free_cuda()
    return {"losses": losses, "step_ms": step_ms}


def phase_lm_mesh(probe: dict) -> dict:
    """Phase 24 (b)-(c): the one-rank runs first (kept on the host and
    freed), then the mesh runs against them."""
    t0 = time.perf_counter()
    want, one_ms = one_rank_logits()
    one_train = one_rank_train_losses()
    smoke = one_rank_smoke_steps()
    if probe["gloo_takes_cuda"]:
        TRAIN_WORK_DIR.parent.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=TRAIN_WORK_DIR.parent) as d:
            paths = [str(Path(d) / f"logits_{i}.pt") for i in (0, 1)]
            for t, path in zip(want, paths):
                torch.save(t, path)
            ranks = compat.run_local_group(
                lm_mesh_rank, RANKS, (2, 2), paths, one_train["losses"],
                smoke, timeout_s=GROUP_TIMEOUT_S * 4)
        layout = "2x2 gloo"
    else:
        with one_rank_nccl():
            ranks = [lm_mesh_rank(0, 1, (1, 1), want,
                                  one_train["losses"], smoke)]
        layout = "1x1 nccl"
    for r in ranks:
        # no nvcc in a rank: a spawned one finds every library built
        assert r["builds_after"] == r["builds_before"], r
        assert layout == "1x1 nccl" or r["builds_before"] == {}, r
        p, t = r["prefill"], r["train"]
        log(f"phase 24 (b) rank {r['rank']} ({layout}): jamba 3 layers bf16 "
            f"2 x {LM_S_BF16} prefill {p['ms']:.1f} ms (one rank, no mesh: "
            f"{one_ms:.1f} ms), launches {p['launches']}, kernel ms "
            f"{p['kernel_ms']}, errs {p['errs']}, logits {r['logits']}; "
            f"collectives "
            f"{p['collectives']['calls']} calls, bytes "
            f"{p['collectives']['bytes']}")
        log(f"phase 24 (c) rank {r['rank']}: {MESH_TRAIN_ARCH} "
            f"{t['flags']}: losses {[round(x, 4) for x in t['losses']]} "
            f"(no mesh {[round(x, 4) for x in one_train['losses']]}), step "
            f"ms {[round(x, 1) for x in t['step_ms']]} (no mesh "
            f"{[round(x, 1) for x in one_train['step_ms']]}), "
            f"{t['tokens_per_s']:.0f} tokens/s, peak "
            f"{t['peak_alloc_bytes'] / 1e9:.2f} GB, moments "
            f"{t['moment_local_bytes'] / 1e9:.3f} GB local; FSDP smoke "
            f"losses {r['smoke']}")
    out = {"layout": layout, "one_rank_prefill_ms": one_ms,
           "one_rank_train": one_train, "ranks": ranks,
           "seconds": time.perf_counter() - t0}
    log(f"phase 24 (b)-(c) took {out['seconds']:.1f} s")
    return out


def pipeline_rank(rank: int, world: int, tokens_np) -> dict:
    """Phase 24 (d) on one rank of a gloo group sharing the card: stage
    ``rank`` of ``PP_ARCH``'s layers (``num_layers / world`` each) over
    ``PP_MICRO`` microbatches (the embedded tokens, the same on every
    rank), through ``parallel.pipeline_apply``."""
    from repro_torch.obs import REGISTRY as REG
    from repro_torch.parallel import pipeline_apply
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    out = {"rank": rank, "builds_before": _build.build_counts()}
    cfg = get_config(PP_ARCH)
    flags = RuntimeFlags(param_dtype="bfloat16", compute_dtype="bfloat16")
    model = build_model(cfg, flags, device="cuda", seed=SEED)
    per = cfg.num_layers // world
    stage = list(model.layers[rank * per:(rank + 1) * per])

    def stage_fn(layers, x):
        for layer in layers:
            x = model_blocks._block_apply(layer, x, cfg, flags)[0]
        return x
    with torch.no_grad():
        x = model.embed["table"][torch.from_numpy(tokens_np).cuda()].to(
            flags.cdtype)                       # (M, 1, S, d)
        pipeline_apply(stage_fn, stage, x[:1])  # warm
        torch.cuda.synchronize()
        comm0 = REG.counter_total("pipeline.comm_ms")
        t0 = time.perf_counter()
        y = pipeline_apply(stage_fn, stage, x)
        torch.cuda.synchronize()
        out["wall_ms"] = (time.perf_counter() - t0) * 1e3
    out["comm_ms"] = REG.counter_total("pipeline.comm_ms") - comm0
    out["bytes"] = REG.counter_total("collective.bytes", op="send_recv")
    if rank == 0:      # numpy: a tensor's shared memory dies with the rank
        out["y"] = y.cpu().view(torch.int16).numpy()
    out["builds_after"] = _build.build_counts()
    return out


def phase_pipeline() -> dict:
    """Phase 24 (d): GPipe of ``PP_ARCH``'s layers as ``PP_STAGES`` stages
    on as many gloo ranks on the card, against the sequential stack on
    this process's card."""
    from repro_torch.parallel import bubble_fraction
    assert abs(bubble_fraction(PP_STAGES, PP_MICRO) - 3 / 11) < 1e-12
    cfg = get_config(PP_ARCH)
    tokens = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (PP_MICRO, 1, PP_S))
    t0 = time.perf_counter()
    ranks = compat.run_local_group(pipeline_rank, PP_STAGES, tokens,
                                   timeout_s=GROUP_TIMEOUT_S * 2)
    flags = RuntimeFlags(param_dtype="bfloat16", compute_dtype="bfloat16")
    model = build_model(cfg, flags, device="cuda", seed=SEED)
    with torch.no_grad():
        x = model.embed["table"][torch.from_numpy(tokens).cuda()].to(
            flags.cdtype)
        seq = []
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for m in range(PP_MICRO):
            h = x[m]
            for layer in model.layers:
                h = model_blocks._block_apply(layer, h, cfg, flags)[0]
            seq.append(h)
        torch.cuda.synchronize()
        seq_ms = (time.perf_counter() - t1) * 1e3
        want = torch.stack(seq)
    got = torch.from_numpy(ranks[0].pop("y")).view(torch.bfloat16).cuda()
    torch.testing.assert_close(got.float(), want.float(), **LM_BF16,
                               msg=lambda m: f"phase 24 (d) GPipe: {m}")
    err = max_err(got.float(), want.float())
    del model, x, seq, want, got
    free_cuda()
    for r in ranks:
        assert r["builds_before"] == {} and r["builds_after"] == {}, r
    wall = max(r["wall_ms"] for r in ranks)
    out = {"ranks": ranks, "max_abs_err": err, "wall_ms": wall,
           "ms_per_microbatch": wall / PP_MICRO,
           "sequential_ms_per_microbatch": seq_ms / PP_MICRO,
           "bubble_fraction": bubble_fraction(PP_STAGES, PP_MICRO),
           "seconds": time.perf_counter() - t0}
    log(f"phase 24 (d) GPipe {PP_ARCH} {cfg.num_layers} layers as "
        f"{PP_STAGES} stages, M={PP_MICRO} x 1 x {PP_S} bf16: "
        f"{out['ms_per_microbatch']:.1f} ms per microbatch (sequential on "
        f"one card {out['sequential_ms_per_microbatch']:.1f}), send/recv "
        f"ms per rank {[round(r['comm_ms'], 1) for r in ranks]}, bytes "
        f"{[int(r['bytes']) for r in ranks]}, bubble 3/11, max |err| vs "
        f"the sequential stack {err:.3e} ({out['seconds']:.1f} s)")
    return out


DRY_SCRIPT = """
import dataclasses, json, sys, time
from repro_torch.launch import dryrun
from repro_torch.launch.specs import shape_applicable
from repro_torch.configs import get_config
for arch, shape, mp in json.loads(sys.argv[1]):
    rec = dryrun.run_cell(arch, shape, mp, skip_existing=False,
                          results_dir=sys.argv[2])
    rec["want"] = "ok" if shape_applicable(get_config(arch), shape)[0] \\
        else "skipped"
    print("CELL " + json.dumps(rec, default=str), flush=True)
for arch, layers, shape, seq_batch in json.loads(sys.argv[3]):
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    t0 = time.perf_counter()
    stats, ctx = dryrun.lower_cell(
        arch, shape, False, mesh_shape=((1, 1), ("data", "model")), cfg=cfg,
        seq_batch=tuple(seq_batch))
    print("WITNESS " + json.dumps({
        "memory": ctx["memory"], "live_peak": stats.live_peak,
        "seconds": time.perf_counter() - t0}), flush=True)
"""


def phase_lm_dryrun() -> dict:
    """Phase 24 (e): the LM dry run's cells in a subprocess (its fake
    group never meets this process's groups): one cell per kind on both
    meshes and jamba train_4k on the multi-pod mesh; each status the
    reference's ``shape_applicable``'s, each row printed.  Then (f)'s
    witnesses on a fake 1 x 1 mesh (``witnesses``: each one's memory
    fields, counted on meta)."""
    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent
    proc = subprocess.run(
        [sys.executable, "-c", DRY_SCRIPT, json.dumps(DRY_CELLS),
         str(root / "build" / "dryrun_lm"), json.dumps(MEM_WITNESSES)],
        env={**__import__("os").environ, "PYTHONPATH": str(root / "src")},
        capture_output=True, text=True, timeout=600, cwd=root)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    rows = [json.loads(ln[5:]) for ln in proc.stdout.splitlines()
            if ln.startswith("CELL ")]
    assert len(rows) == len(DRY_CELLS), proc.stdout[-3000:]
    wit = [json.loads(ln[8:]) for ln in proc.stdout.splitlines()
           if ln.startswith("WITNESS ")]
    assert len(wit) == len(MEM_WITNESSES), proc.stdout[-3000:]
    for r in rows:
        assert r["status"] == r["want"], r
        if r["status"] == "ok":
            mem = r["memory_per_device"]
            assert r["peak_counted_on"] == "meta", r
            assert mem["peak_bytes"] >= mem["argument_bytes"] > 0, r
            log(f"phase 24 (e) {r['arch']} {r['shape']} {r['mesh']}: "
                f"bottleneck {r['bottleneck']}, t_compute "
                f"{r['t_compute']:.4g} s, t_memory {r['t_memory']:.4g} s, "
                f"t_collective {r['t_collective']:.4g} s, roofline "
                f"fraction {r['roofline_fraction']:.3f}, peak "
                f"{mem['peak_bytes'] / 1e9:.3f} GB per device (arguments "
                f"{mem['argument_bytes'] / 1e9:.3f}, temp "
                f"{mem['temp_bytes'] / 1e9:.3f}), step on meta "
                f"{r['step_s']} s")
    out = {"rows": rows, "witnesses": wit,
           "seconds": time.perf_counter() - t0}
    log(f"phase 24 (e) LM dry run, {len(rows)} cells: "
        f"{out['seconds']:.1f} s")
    return out


class ThreadCounter(OpCounter):
    """``OpCounter`` that also notes the threads its ops ran on (the
    backward of a CUDA step runs on autograd's device thread)."""

    def __init__(self, device: str):
        super().__init__(device)
        self.threads: set = set()

    def _count(self, func, args, kwargs, out) -> None:
        self.threads.add(threading.get_ident())
        super()._count(func, args, kwargs, out)


def witness_config(arch: str, layers):
    cfg = get_config(arch)
    return cfg if not layers else dataclasses.replace(cfg, num_layers=layers)


def memory_on_card(witness, mesh) -> dict:
    """One witness's step on the card, with the flags the dry run gives it
    on a 1 x 1 mesh: a warm-up step (cuBLAS workspaces, the allocator's
    pools), then the counted one, ``max_memory_allocated`` read from
    ``reset_peak_memory_stats``."""
    from repro_torch.launch.dryrun import cell_step
    from repro_torch.launch.specs import default_flags
    arch, layers, shape, seq_batch = witness
    cfg = witness_config(arch, layers)
    flags = default_flags(cfg, shape, mesh)
    t0 = time.perf_counter()
    run, _ = cell_step(cfg, shape, flags, mesh, seq_batch=tuple(seq_batch),
                       device="cuda", seed=SEED)
    t1 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t1
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    counter = ThreadCounter("cuda")
    t1 = time.perf_counter()
    with counter:
        out = run()
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t1
    measured = torch.cuda.max_memory_allocated() - base
    del out, run
    free_cuda()
    return {"measured": measured, "counted_cuda": counter.stats.live_peak,
            "threads": len(counter.threads), "step_s": step_s,
            "warm_step_s": warm_s,
            "seconds": time.perf_counter() - t0}


def phase_lm_memory(dry: dict, card: dict, mesh) -> dict:
    """Phase 24 (f): each witness's meta prediction (``peak_bytes -
    argument_bytes`` from (e)'s subprocess) and the counter on the card's
    own tensors against the allocator's high-water above the arguments,
    on ``mesh``, the one-rank NCCL mesh; each within ``MEM_RTOL`` of the
    measured."""
    t0 = time.perf_counter()
    rows = []
    for w, meta in zip(MEM_WITNESSES, dry["witnesses"]):
        got = memory_on_card(w, mesh)
        mem = meta["memory"]
        got["predicted"] = mem["peak_bytes"] - mem["argument_bytes"]
        got["memory_meta"] = mem
        got["meta_s"] = meta["seconds"]
        got["witness"] = w
        rows.append(got)
        arch, layers, shape, (seq, batch) = w
        log(f"phase 24 (f) {arch}{f' ({layers} layers)' if layers else ''}"
            f" {shape} {batch} x {seq}: high-water above the arguments "
            f"{got['measured'] / 1e9:.4f} GB (max_memory_allocated), "
            f"counted on the card {got['counted_cuda'] / 1e9:.4f} GB, "
            f"predicted on meta {got['predicted'] / 1e9:.4f} GB "
            f"({got['predicted'] / got['measured'] - 1:+.2%}); "
            f"arguments {mem['argument_bytes'] / 1e9:.3f} GB, peak "
            f"{mem['peak_bytes'] / 1e9:.3f} GB; ops on "
            f"{got['threads']} threads; step {got['warm_step_s']:.2f} s, "
            f"{got['step_s']:.2f} s counted | {card['smi']}")
    for r in rows:
        for k in ("predicted", "counted_cuda"):
            assert abs(r[k] - r["measured"]) <= MEM_RTOL * r["measured"], \
                (k, r)
    out = {"rows": rows, "seconds": time.perf_counter() - t0}
    log(f"phase 24 (f) memory witnesses: {out['seconds']:.1f} s")
    return out


# (g): size-1 tensor dims named on the one-rank mesh's size-1 axes, which
# parallel.placements makes Replicate(): Granite's one KV head on 'model'
# and a global batch of 1 on 'data'
SIZE1_ARCH, SIZE1_LAYERS, SIZE1_S, SIZE1_TICKS = "granite-34b", 2, 2048, 4
SIZE1_TRAIN_ARCH, SIZE1_TRAIN_S = "stablelm-1.6b", 2048
# the mesh step runs the no-mesh step's local operations; its loss is
# summed by the vocab-parallel path (fp32) instead of logsumexp
SIZE1_LOSS_RTOL = 1e-5


def size1_config():
    """granite-34b at its published widths (d_model 6144, 48 query heads
    and ONE KV head of 128, GELU d_ff 24576, vocab 49152), depth cut from
    88 layers to ``SIZE1_LAYERS``."""
    return dataclasses.replace(get_config(SIZE1_ARCH),
                               num_layers=SIZE1_LAYERS)


def size1_serve(model, tokens, label: str) -> dict:
    """``model``'s prefill of the first ``SIZE1_S`` tokens (its forward:
    flash on the kernel route; warm, then timed with the flash calls
    captured and the launches counted, then profiled under ``label``),
    then that prompt filled into a cache by one ``decode_step`` and the
    next ``SIZE1_TICKS`` tokens decoded one at a time.  Logits whole, on
    the model's device."""
    from repro_torch.parallel.local import whole
    prompt = tokens[:, :SIZE1_S]
    with torch.no_grad():
        model({"tokens": prompt})
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        with capture_lm_kernels() as calls:
            t0 = time.perf_counter()
            logits = model({"tokens": prompt})[0]
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        out = {"prefill": whole(logits), "prefill_ms": ms,
               "launches": counts(), "calls": calls["flash_attention"],
               "profile": profile_request(lambda: model({"tokens": prompt}),
                                          label)}
        cache = model.init_cache(1, SIZE1_S + SIZE1_TICKS)
        model.decode_step(cache, {"tokens": prompt,
                                  "pos": np.arange(SIZE1_S)})
        out["ticks"] = []
        for t in range(SIZE1_S, SIZE1_S + SIZE1_TICKS):
            lg, cache = model.decode_step(
                cache, {"tokens": tokens[:, t:t + 1], "pos": t})
            out["ticks"].append(whole(lg))
    return out


def size1_train_steps(mesh, batch, device) -> dict:
    """Two bf16 steps of ``SIZE1_TRAIN_ARCH`` whole on ``batch`` with the
    reference's train flags (``use_pallas=False``), on ``mesh`` or with
    none, from the weights of seed ``SEED``: the first cold, the second
    warm; then a third under the profiler."""
    from repro_torch.launch.rules import rules_for
    from repro_torch.launch.specs import default_flags
    cfg = get_config(SIZE1_TRAIN_ARCH)
    flags = dataclasses.replace(default_flags(cfg, "train_4k", mesh),
                                use_pallas=False)
    rules = None if mesh is None else rules_for(cfg, mesh, flags)
    model = build_model(cfg, flags, rules, device=device, seed=SEED,
                        mesh=mesh)
    opt = AdamWConfig(peak_lr=3e-4, warmup_steps=2, total_steps=100)
    state, step = init_state(model, opt), make_train_step(model, opt)
    out = {"loss": [], "grad_norm": [], "step_ms": []}
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, batch)
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["loss"].append(float(met["loss"]))
        out["grad_norm"].append(float(met["grad_norm"]))
    out["profile"] = profile_request(
        lambda: step(state, batch), f"phase 24 (g) {SIZE1_TRAIN_ARCH} step "
        + ("with no mesh" if mesh is None else "on the mesh"))
    del state, model, step
    free_cuda()
    return out


def phase_size1(mesh, card: dict, device: str = "cuda") -> dict:
    """Phase 24 (g), on ``mesh`` (the one-rank NCCL mesh): Granite cut to
    ``SIZE1_LAYERS`` layers in bf16, its one KV head named on 'model' of
    size 1 (every KV weight ``Replicate()``), prefill and decode ticks
    against the same model with ``mesh=None`` in bf16 and fp32 (phase 24
    (b)'s rule: relative RMS from fp32 within ``MESH_LOGITS_RMS_FACTOR``
    times the no-mesh bf16 logits'), each flash launch on the local heads
    (G = 48) against its plain version (``check_flash_bf16``: the kernel
    rounds P to bf16); then ``SIZE1_TRAIN_ARCH`` whole, two steps at
    global batch 1 x ``SIZE1_TRAIN_S`` against the same steps with no
    mesh (the first loss within ``SIZE1_LOSS_RTOL``, each loss and grad
    norm within ``MESH_TRAIN_RTOL``)."""
    from repro_torch.launch.rules import rules_for
    t0 = time.perf_counter()
    cfg = size1_config()
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (1, SIZE1_S + SIZE1_TICKS))).to(device)
    want = {}
    for dtype in ("bfloat16", "float32"):
        model = build_model(cfg, RuntimeFlags(param_dtype=dtype,
                                              compute_dtype=dtype),
                            device=device, seed=SEED)
        run = size1_serve(model, tokens,
                          f"phase 24 (g) granite prefill {dtype} no mesh")
        want[dtype] = {"prefill": run["prefill"].cpu(),
                       "ticks": [t.cpu() for t in run["ticks"]],
                       "prefill_ms": run["prefill_ms"],
                       "profile": run["profile"]}
        del model, run
        free_cuda()
    flags = RuntimeFlags(param_dtype="bfloat16", compute_dtype="bfloat16")
    model = build_model(cfg, flags, rules_for(cfg, mesh, flags),
                        device=device, seed=SEED, mesh=mesh)
    kv = {n: tuple(p.placements) for n, p in model.named_parameters()
          if n.endswith((".wk", ".wv"))}
    assert kv and all(p.is_replicate() for pl in kv.values() for p in pl), kv
    got = size1_serve(model, tokens, "phase 24 (g) granite prefill mesh")
    with torch.no_grad():
        coll = mesh_collectives(
            lambda: model({"tokens": tokens[:, :SIZE1_S]}))
    del model
    free_cuda()
    assert got["launches"] == only(flash_attention=SIZE1_LAYERS), \
        got["launches"]
    for args, _, res in got["calls"]:
        assert not any(_dtensor(a) for a in (*args, res))
        assert args[0].shape[2] == cfg.num_heads and args[1].shape[2] == 1
    calls = {"flash_attention": got["calls"]}
    checked = check_flash_bf16(calls, "phase 24 (g) granite prefill")
    times = lm_kernel_times(calls, plain=False, iters=3)
    del calls
    ref = [want[d] for d in ("bfloat16", "float32")]
    logits = sharded_logits_check(
        got["prefill"], (0, 0, 0), [w["prefill"] for w in ref],
        "phase 24 (g) granite prefill")
    ticks = [sharded_logits_check(t, (0, 0, 0), [w["ticks"][i] for w in ref],
                                  f"phase 24 (g) granite tick {i}")
             for i, t in enumerate(got["ticks"])]
    serve = {"prefill_ms": got["prefill_ms"],
             "no_mesh_prefill_ms": want["bfloat16"]["prefill_ms"],
             "launches": got["launches"],
             "errs": {"flash_attention": checked["max_abs_err"]},
             "err_over_limit": checked["max_err_over_limit"],
             "kernel_ms": {k: t["kernel_ms"] for k, t in times.items()},
             "kernel_times": times,
             "idle_share": {k: 1 - r["profile"]["device_busy_ms"]
                            / r["profile"]["profiled_wall_ms"]
                            for k, r in (("mesh", got),
                                         ("no_mesh", want["bfloat16"]))},
             "logits": logits, "ticks": ticks, "collectives": coll,
             "kv_placements": {n: [repr(p) for p in pl]
                               for n, pl in kv.items()}}
    del got, want, ref
    free_cuda()
    log(f"phase 24 (g) {SIZE1_ARCH} {SIZE1_LAYERS} layers bf16, 1 x "
        f"{SIZE1_S} on the 1 x 1 NCCL mesh (KV weights "
        f"{sorted(set(map(str, serve['kv_placements'].values())))}): "
        f"prefill {serve['prefill_ms']:.1f} ms (no mesh "
        f"{serve['no_mesh_prefill_ms']:.1f} ms), launches "
        f"{serve['launches']}, flash kernel ms {serve['kernel_ms']}, errs "
        f"{serve['errs']}; logits {logits}; {SIZE1_TICKS} ticks "
        f"{[round(t['max_abs_diff_to_one_rank'], 6) for t in ticks]} max "
        f"abs from no mesh; collectives {coll['calls']} calls, bytes "
        f"{coll['bytes']}; device idle share of a warm prefill "
        f"{serve['idle_share']} | {card['smi']}")

    cfg = get_config(SIZE1_TRAIN_ARCH)
    batch = train_batch(cfg.vocab_size, 1, SIZE1_TRAIN_S)
    train = {"no_mesh": size1_train_steps(None, batch, device),
             "mesh": size1_train_steps(mesh, batch, device)}
    a, b = train["mesh"], train["no_mesh"]
    for t in (a, b):
        t["idle_share"] = 1 - t["profile"]["device_busy_ms"] \
            / t["profile"]["profiled_wall_ms"]
    assert abs(a["loss"][0] - b["loss"][0]) <= \
        SIZE1_LOSS_RTOL * abs(b["loss"][0]), train
    for k in ("loss", "grad_norm"):
        for x, y in zip(a[k], b[k]):
            assert abs(x - y) <= MESH_TRAIN_RTOL * abs(y), (k, train)
    log(f"phase 24 (g) {SIZE1_TRAIN_ARCH} whole, two bf16 steps at 1 x "
        f"{SIZE1_TRAIN_S} on the 1 x 1 NCCL mesh: losses {a['loss']!r} "
        f"(no mesh {b['loss']!r}), grad norms {a['grad_norm']!r} (no mesh "
        f"{b['grad_norm']!r}), step ms cold, warm "
        f"{[round(x, 1) for x in a['step_ms']]} (no mesh "
        f"{[round(x, 1) for x in b['step_ms']]}); device idle share of a "
        f"warm step {a['idle_share']:.3f} (no mesh {b['idle_share']:.3f}) "
        f"| {card['smi']}")
    out = {"serve": serve, "train": train,
           "seconds": time.perf_counter() - t0}
    log(f"phase 24 (g) took {out['seconds']:.1f} s")
    return out


def lm_kernel_records(lm: dict, fe: dict, lm_mesh: dict) -> list:
    """The ``kernels`` records of the LM path: times, bound and errors of
    the timed bf16 prefill (phase 13), with the fp32 (phase 12) and 32k
    (phase 14) errors and the 32k times beside them; flash also carries
    phase 23's two prefills under ``paths``, and both phase 24's sharded
    prefill (per rank)."""
    recs = []
    for name, src, line in (
            ("flash_attention", "flash_attention.cu",
             "src/repro/kernels/flash/flash_attention.py:74"),
            ("ssd_scan", "ssd_scan.cu", "src/repro/kernels/ssd/ssd.py:67")):
        t, tl = lm["bf16"]["times"][name], lm["long"]["times"][name]
        recs.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}",
            "replaces": line,
            "launches": lm["bf16"]["launches"][name],
            "max_abs_err": lm["bf16"]["errs"][name],
            "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "mean_abs_out": lm["bf16"]["mean_abs_out"][name],
            "value_at_max_err": lm["bf16"]["value_at_max_err"][name],
            "long_value_at_max_err": lm["long"]["value_at_max_err"][name],
            "max_abs_err_fp32": lm["fp32"]["kernel_errs"][name],
            "long_ms": tl["kernel_ms"],
            "long_max_abs_err": lm["long"]["errs"][name],
            "long_bound_ms": tl["bound_ms"],
            "long_library_ms": tl["library_ms"],
            "tflops": t["tflops"],
            "ratio_to_library": t["ratio_to_library"],
            "long_tflops": tl["tflops"],
            "long_ratio_to_library": tl["ratio_to_library"],
            "ms_per_launch": t["kernel_ms"] / t["calls"],
            "long_ms_per_launch": tl["kernel_ms"] / tl["calls"],
            "bound_share": t["bound_ms"] / t["kernel_ms"],
            "long_bound_share": tl["bound_ms"] / tl["kernel_ms"],
        })
    recs[0]["paths"] = {f"{fe[k]['arch']}_prefill": fe[k]["flash"]
                        for k in ("audio", "vision")}
    for rec in recs:
        rec.setdefault("paths", {})[
            f"sharded_prefill_{lm_mesh['mesh']['layout'].replace(' ', '_')}"
        ] = [{"launches": r["prefill"]["launches"][rec["name"]],
              "max_abs_err": r["prefill"]["errs"][rec["name"]],
              "ms": r["prefill"]["kernel_ms"][rec["name"]]}
             for r in lm_mesh["mesh"]["ranks"]]
    g = lm_mesh["size1"]["serve"]
    t = g["kernel_times"]["flash_attention"]
    recs[0]["paths"]["size1_granite_prefill_1x1_nccl"] = {
        "launches": g["launches"]["flash_attention"],
        "max_abs_err": g["errs"]["flash_attention"],
        "ms": t["kernel_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"]}
    return recs


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
    work = work_model(plan, *x.shape, x.element_size())
    log(f"plan m={M} d={D}: {schema.algorithm}, {plan.num_reducers} "
        f"reducers, bucket widths {plan.bucket_widths()} with "
        f"{[b.R for b in plan.buckets]} reducers, "
        f"{sum(b.R * b.width ** 2 for b in plan.buckets)} Gram entries, "
        f"{work['ops']} FLOP over valid pairs i <= j; host plan_a2a "
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
    some = phase_some_pairs(x, x_np, w)
    stream = phase_stream_a2a(x_np, w)
    stream_x2y = phase_stream_x2y(skew)
    one_rank = phase_sharded_one_rank(x, x_np, w, schema, skew)
    free_cuda()
    ranks = phase_ranks(skew)
    free_cuda()
    mesh = phase_mesh(x, schema, ranks)
    free_cuda()
    lm = {"fp32": phase_lm_fp32(), "bf16": phase_lm_bf16(),
          "long": phase_lm_long(), "decode": phase_lm_decode()}
    free_cuda()                          # the 12.37 B serving model is gone
    train = {"card_vs_cpu": phase_train_card_vs_cpu(),
             "full": phase_train_full(work_dir=TRAIN_WORK_DIR),
             "refusal": phase_train_refusal()}
    free_cuda()
    t0 = time.perf_counter()
    fe = {"audio": phase_fe_audio(), "vision": phase_fe_vision(),
          "card_vs_cpu": phase_fe_card_vs_cpu()}
    fe["seconds"] = time.perf_counter() - t0
    log(f"phase 23 (encoder, cross-attention, frontends) took "
        f"{fe['seconds']:.1f} s")
    free_cuda()
    t0 = time.perf_counter()
    probe = phase_mesh_probe()
    lm_mesh = {"probe": probe, "mesh": phase_lm_mesh(probe),
               "pipeline": phase_pipeline(), "dryrun": phase_lm_dryrun()}
    free_cuda()
    from repro_torch.launch.mesh import make_mesh
    with one_rank_nccl():
        mesh11 = make_mesh((1, 1), ("data", "model"), device_type="cuda")
        lm_mesh["memory"] = phase_lm_memory(lm_mesh["dryrun"], card, mesh11)
        lm_mesh["size1"] = phase_size1(mesh11, card)
    lm_mesh["seconds"] = time.perf_counter() - t0
    log(f"phase 24 (LM sharding, GPipe, LM dry run) took "
        f"{lm_mesh['seconds']:.1f} s")

    tot = timing["totals"]
    bound_ms, bound_by = bound(work, PEAK_FP32_CUDA_CORES)
    b16_ms, b16_by = bound(work, PEAK_BF16_TENSOR)
    log(f"bound fp32 {bound_ms:.4f} ms ({bound_by}); bf16 {b16_ms:.4f} ms "
        f"({b16_by}); kernel fp32 at {bound_ms / tot['kernel_fp32']:.3f} "
        f"of its bound, bf16 at {b16_ms / tot['kernel_bf16']:.3f}; fp32 "
        f"kernel / torch.bmm {tot['kernel_fp32'] / tot['bmm']:.3f}; the "
        f"schedule stages {tot['modelled_gather_bytes'] / 1e9:.3f} GB of "
        f"table rows from L2 per fp32 request (modelled from the plan)")
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
        "bf16_ms": tot["kernel_bf16"],
        "ratio_to_bmm": tot["kernel_fp32"] / tot["bmm"],
        "buckets": fgg_buckets(timing, timing_new),
        "paths": {
            "some_pairs": {k: some[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by")} | {
                "launches": some["launches"]["fused_gather_gram"],
                "max_abs_err": some["errs"]["float32"]},
            "stream_a2a_cold": {
                "launches": stream["load"]["launches"]["fused_gather_gram"],
                "max_abs_err": stream["load"]["kernel_err"]},
            "sharded_a2a_1rank": path_record(one_rank["a2a"]),
            f"sharded_a2a_{RANKS}ranks": ranks_record(ranks, "sharded_a2a",
                                                      "fused_gather_gram"),
            "mesh_a2a_1rank": mesh_record(mesh["one_rank"]["fused"]),
            f"mesh_a2a_{RANKS}ranks": mesh_ranks_record(
                ranks, "fused_a2a", "fused_gather_gram"),
            f"stream_mesh_{RANKS}ranks_cold": mesh_ranks_record(
                ranks, "stream", "fused_gather_gram")},
        "ptxas": build_s["ptxas"]["fused_gather_gram"],
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
        b_ms, b_by = bound(rect_work(
            rplan, xt.shape[0] + yt.shape[0], xt.shape[1], xt.element_size()),
            PEAK_FP32_CUDA_CORES)
        rect_paths[name] = {
            "launches": launches["fused_gather_gram_rect"],
            "ms": t["kernel_fp32"], "bf16_ms": t["kernel_bf16"],
            "plain_ms": t["plain"], "bmm_pregathered_ms": t["bmm"],
            "ratio_to_bmm": t["ratio_to_bmm"],
            "bound_ms": b_ms, "bound_by": b_by,
            "warm_request_s": t.get("warm_request_s"),
            "buckets": [{k: r[k] for k in (
                "width", "ywidth", "R", "tiles", "kernel_fp32_ms",
                "kernel_bf16_ms", "bmm_ms", "ratio_to_bmm", "bound_ms",
                "bound_share")}
                for r in timing_new[name.replace("x2y_", "")]["buckets"]]}
        log(f"rect kernel on {name}: {launches['fused_gather_gram_rect']} "
            f"launches, {t['kernel_fp32']:.4f} ms fp32 vs bound "
            f"{b_ms:.4f} ms ({b_by}), share {b_ms / t['kernel_fp32']:.3f}")
    rect_paths["stream_x2y_cold"] = {
        "launches": stream_x2y["launches"]["fused_gather_gram_rect"],
        "max_abs_err": stream_x2y["errs"]["float32"]}
    rect_paths["sharded_x2y_1rank"] = path_record(one_rank["x2y"])
    for path in ("sharded_x2y", "coded_a2a"):
        rect_paths[f"{path}_{RANKS}ranks"] = ranks_record(
            ranks, path, "fused_gather_gram_rect")
    rect_errs = [x2y_skew["errs"], x2y_bal["errs"], stream_x2y["errs"]] + [
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
        "ptxas": build_s["ptxas"]["fused_gather_gram_rect"],
    })
    pt = timing_new["pairwise_gram"]["totals"]
    p_ms, p_by = bound(pairwise_work(plan, x.shape[1], x.element_size()),
                       PEAK_FP32_CUDA_CORES)
    log(f"pairwise_gram on the use_kernel=True bucketed path: "
        f"{pgram['launches']['pairwise_gram']} launches, "
        f"{pt['kernel_fp32']:.4f} ms fp32 vs bound {p_ms:.4f} ms ({p_by}), "
        f"share {p_ms / pt['kernel_fp32']:.3f}; torch.bmm {pt['bmm']:.4f} ms "
        f"(kernel / bmm {pt['ratio_to_bmm']:.3f})")
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
        "bf16_ms": pt["kernel_bf16"],
        "ratio_to_library": pt["ratio_to_bmm"],
        "buckets": [{k: r[k] for k in ("width", "R", "kernel_fp32_ms",
                                       "bmm_ms", "ratio_to_bmm",
                                       "bound_ms", "bound_share")}
                    for r in timing_new["pairwise_gram"]["buckets"]],
        "paths": {"stream_a2a_deltas": {
            "launches": stream["pairwise_gram"]["launches"],
            "max_abs_err": stream["pairwise_gram"]["max_abs_err"],
            "ms": stream["pairwise_gram"]["ms"],
            "plain_ms": stream["pairwise_gram"]["plain_ms"],
            "warmup_launches": stream["load"]["launches"]["pairwise_gram"]},
            "mesh_dense_1rank": mesh_record(mesh["one_rank"]["dense"]),
            "mesh_bucketed_1rank": mesh_record(
                mesh["one_rank"]["bucketed"]),
            f"stream_mesh_{RANKS}ranks_deltas": mesh_ranks_record(
                ranks, "stream", "pairwise_gram")},
        "ptxas": build_s["ptxas"]["pairwise_gram"],
    })
    kernels += lm_kernel_records(lm, fe, lm_mesh)
    for rec in kernels:
        if rec["name"] in ("flash_attention", "ssd_scan"):
            rec["ptxas"] = build_s["ptxas"][rec["name"]]
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
            "some_pairs": some, "stream_a2a": stream,
            "stream_x2y": stream_x2y, "sharded_one_rank": one_rank,
            "ranks": ranks, "mesh": mesh, "lm": lm, "train": train,
            "frontends": fe, "lm_mesh": lm_mesh,
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
