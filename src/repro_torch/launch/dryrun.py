"""LM dry run: every (arch x shape x mesh) cell's step on the meta device
over the fake backend (port of ``repro.launch.dryrun``).

The reference forces 512 host devices and lowers + compiles each cell
against abstract inputs.  Here the process joins a FAKE process group of
256 (single pod, 16 x 16) or 512 (multi-pod, 2 x 16 x 16) ranks — its
collectives do nothing — and runs the cell's step once on meta tensors:
the model built on meta at full size, its parameters (or train state) and
cache distributed by the rules as DTensors, train = loss + backward +
AdamW, prefill = forward, decode = ``decode_step``.  Nothing is
allocated.  Success proves the sharding config is coherent;
``launch.op_analysis`` counts this rank's FLOPs, HBM bytes and collective
bytes op by op, and ``launch.roofline.analyze_step`` turns them into the
reference's row on an H100's peaks.  ``memory_per_device`` is this rank's
bytes, counted on meta during that step (``op_analysis``: each storage
rounded as the CUDA caching allocator rounds it): ``argument_bytes`` and
``output_bytes`` the local shards of the step's arguments and results,
``peak_bytes`` the arguments plus the largest live allocation during the
step, ``temp_bytes`` that allocation less what the step still holds when
it returns (never below 0).  Records say ``"peak_counted_on": "meta"``;
``chip_smoke.py``'s phase 24 (f) holds the count against
``torch.cuda.max_memory_allocated`` on the card.

The module initialises the fake group itself (one per mesh size) and
refuses to run in a process that already has a real group.  Decode runs at
position 0 of a fresh ``seq``-long cache: its attention reads the whole
cache under a mask, as the reference's does at any position.

Usage:
  python -m repro_torch.launch.dryrun --arch mixtral-8x7b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--mesh pod|multipod|both]
  python -m repro_torch.launch.dryrun --all --no-skip-existing
Results: build/dryrun_lm/<arch>__<shape>__<mesh>.json (never
benchmarks/results/dryrun/, which holds the reference's records).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from ..configs.base import SHAPES, get_config, list_archs
from ..models import build_model
from ..models.lm import distribute_model
from ..train import AdamWConfig, init_state, make_train_step
from .mesh import make_mesh, make_production_mesh
from .op_analysis import count_ops, tensor_bytes
from .roofline import analyze_step
from .rules import rules_for
from .specs import default_flags, input_specs, shape_applicable

__all__ = ["lower_cell", "run_cell", "cell_step", "memory_fields", "main",
           "RESULTS_DIR"]

RESULTS_DIR = os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "build", "dryrun_lm"))


def fake_world(world_size: int) -> None:
    """Make the default group a fake one of ``world_size`` ranks (this
    process is rank 0).  A real group already there is refused."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is initialised: the "
                               "dry run runs in a process of its own")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    leaves = torch.utils._pytree.tree_leaves(tree)
    return int(sum(tensor_bytes(t.to_local() if isinstance(t, DTensor)
                                else t) for t in leaves))


def _draw_inputs(specs: dict, vocab: int, device, seed: int = 0) -> dict:
    """Real tensors on ``device`` in place of the meta ``specs``: tokens
    and targets below ``vocab``, a mask of ones, embeddings ~ N(0, 0.02²),
    all from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, t in specs.items():
        if k == "mask":
            v = torch.ones(t.shape, dtype=t.dtype)
        elif t.dtype.is_floating_point:
            v = (torch.randn(t.shape, generator=g) * 0.02).to(t.dtype)
        else:
            v = torch.randint(0, vocab, t.shape, generator=g, dtype=t.dtype)
        out[k] = v.to(device)
    return out


def cell_step(cfg, shape: str, flags, mesh=None, *, seq_batch=None,
              device="meta", seed: int = 0):
    """One cell's step on ``device``: ``(run, arguments)``.  ``run()``
    runs it once (train = loss + backward + AdamW from a fresh state,
    prefill = forward, decode = ``decode_step`` at position 0);
    ``arguments`` is what it takes: the train state and batch, or the
    parameters, the decode cache and the batch.  With ``mesh`` the
    parameters are DTensors placed by the rules.  ``seq_batch`` replaces
    ``SHAPES[shape]``'s sequence and global batch.  Off meta the weights
    and the batch are drawn from ``seed``."""
    seq, batch, kind = SHAPES[shape]
    if seq_batch is not None:
        seq, batch = seq_batch
    rules = None if mesh is None else rules_for(cfg, mesh, flags)
    model = build_model(cfg, flags, rules, device=device, seed=seed)
    if mesh is not None:
        model = distribute_model(model, mesh, rules)
    specs = input_specs(cfg, shape, flags, seq_batch=seq_batch)
    if torch.device(device).type != "meta":
        specs = _draw_inputs(specs, cfg.vocab_size, device, seed)
    if kind == "train":
        opt_cfg = AdamWConfig(
            moment_dtype="bfloat16" if cfg.param_count() > 100e9
            else "float32")
        state = init_state(model, opt_cfg)
        step = make_train_step(model, opt_cfg)
        return (lambda: step(state, specs)), (state, specs)
    params = dict(model.named_parameters())
    if kind == "prefill":
        def run():
            with torch.no_grad():
                return model(specs)[0]
        return run, (params, specs)
    cache = model.init_cache(batch, seq)
    b = dict(specs, pos=0)
    return (lambda: model.decode_step(cache, b)), (params, cache, b)


def memory_fields(arguments, out, stats) -> dict:
    """The reference's ``memory_per_device`` from one counted step: the
    arguments' and outputs' local bytes, ``peak_bytes`` = arguments + the
    largest live allocation, ``temp_bytes`` = that allocation less what is
    still live at the end (``launch.op_analysis``)."""
    argument = _local_bytes(arguments)
    return {"argument_bytes": argument, "output_bytes": _local_bytes(out),
            "temp_bytes": max(0, stats.live_peak - stats.live_end),
            "peak_bytes": argument + stats.live_peak}


def lower_cell(arch: str, shape: str, multi_pod: bool, flags=None,
               opt_overrides=None, mesh_shape=None, cfg=None,
               seq_batch=None):
    """Run one cell's step on meta; returns ``(OpStats, context)``.
    ``mesh_shape`` (``(shape, axis names)``) replaces the production mesh,
    e.g. a small fake mesh for a test; ``cfg`` replaces the registry's
    ``arch`` and ``seq_batch`` (``(seq, global batch)``) ``SHAPES``' entry,
    e.g. a cut config at a size one card holds."""
    if cfg is None:
        cfg = get_config(arch)
    if mesh_shape is None:
        fake_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod)
    else:
        fake_world(int(np.prod(mesh_shape[0])))
        mesh = make_mesh(*mesh_shape)
    n_dev = mesh.size()
    if flags is None:
        flags = default_flags(cfg, shape, mesh)
    if opt_overrides:
        flags = dataclasses.replace(flags, **opt_overrides)
    run, arguments = cell_step(cfg, shape, flags, mesh, seq_batch=seq_batch)
    out, stats = count_ops(run)
    return stats, dict(cfg=cfg, mesh=mesh, n_dev=n_dev, flags=flags,
                       memory=memory_fields(arguments, out, stats))


def run_cell(arch: str, shape: str, multi_pod: bool,
             skip_existing: bool = True, opt_overrides=None,
             tag: str = "", results_dir: str = RESULTS_DIR,
             mesh_shape=None) -> dict:
    """One cell's record (``ok``, ``skipped`` or ``error``), also written
    to ``results_dir/<arch>__<shape>__<mesh><tag>.json``."""
    mesh_name = "multipod_2x16x16" if multi_pod else "pod_16x16"
    if mesh_shape is not None:
        mesh_name = "x".join(map(str, mesh_shape[0]))
    results_dir = os.path.abspath(results_dir)
    if os.sep + os.path.join("benchmarks", "results", "dryrun") in \
            results_dir + os.sep:
        raise ValueError("benchmarks/results/dryrun/ holds the reference's "
                         "records; the port writes under build/")
    os.makedirs(results_dir, exist_ok=True)
    out_path = os.path.join(
        results_dir, f"{arch}__{shape}__{mesh_name}{tag}.json")
    if skip_existing and os.path.exists(out_path):
        with open(out_path) as f:
            return json.load(f)
    cfg = get_config(arch)
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
               "status": "skipped", "reason": reason}
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1)
        return rec
    t0 = time.time()
    try:
        stats, ctx = lower_cell(arch, shape, multi_pod,
                                opt_overrides=opt_overrides,
                                mesh_shape=mesh_shape)
        rep = analyze_step(
            stats, arch=arch, shape=shape, mesh_name=mesh_name,
            num_devices=ctx["n_dev"], cfg=ctx["cfg"], memory=ctx["memory"])
        rec = {"status": "ok", "step_s": round(time.time() - t0, 1),
               "flags": dataclasses.asdict(ctx["flags"]),
               "peak_counted_on": "meta", **rep.row()}
    except Exception as e:  # noqa: BLE001 — record the failure verbatim
        rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-2000:],
               "step_s": round(time.time() - t0, 1)}
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return rec


def cell_line(rec: dict, mp: bool) -> str:
    line = (f"[{rec['status']:7s}] {rec.get('arch', ''):28s} "
            f"{rec.get('shape', ''):12s} {'multipod' if mp else 'pod':8s} "
            f"t={rec.get('step_s', 0):6.1f}s")
    if rec["status"] == "ok":
        line += (f" bottleneck={rec['bottleneck']:10s} "
                 f"frac={rec['roofline_fraction']:.3f}")
    elif rec["status"] == "error":
        line += " " + rec["error"][:120]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=[*SHAPES, None])
    ap.add_argument("--mesh", default="both",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true", default=True)
    ap.add_argument("--no-skip-existing", dest="skip_existing",
                    action="store_false")
    ap.add_argument("--out-dir", default=RESULTS_DIR)
    args = ap.parse_args(argv)

    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if args.shape is None else [args.shape]
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]
    failures = 0
    t0 = time.time()
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_cell(arch, shape, mp,
                               skip_existing=args.skip_existing,
                               results_dir=args.out_dir)
                rec.setdefault("arch", arch)
                rec.setdefault("shape", shape)
                failures += rec["status"] == "error"
                print(cell_line(rec, mp), flush=True)
    print(f"done in {time.time() - t0:.1f} s; {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
