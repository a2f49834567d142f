"""Rank programs for the port's multi-process tests, and the checks that
the sharded and coded tests share with the card tests.

``repro_torch.compat.run_local_group`` spawns each rank as a fresh process
that imports this module by name, so it imports only the port: JAX stays in
the parent test, which holds what the ranks return against the reference.
"""

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pairwise import fused_gather_gram as fgg
from repro_torch.mapreduce import executors as port_ex
from repro_torch.mapreduce import (make_executor, pairwise_similarity,
                                   x2y_similarity)
from repro_torch.obs import LEDGER, REGISTRY
from repro_torch.serve import PairwiseService


def _coded_ledger(before: float) -> dict:
    """The last coded ledger record and the all-to-all bytes sent since
    ``before``."""
    rec = [r for r in LEDGER.records() if r.executor == "coded"][-1]
    return {"measured_over_predicted": rec.measured_over_predicted,
            "replication": rec.replication, "anomaly": rec.anomaly,
            "assembled_bytes": rec.assembled_bytes,
            "assembly_bytes_per_shard": rec.meta["assembly_bytes_per_shard"],
            "all_to_all_bytes": REGISTRY.counter_total(
                "collective.bytes", op="all_to_all") - before}


def assert_one_rect_finish_path(run, metric, x, y):
    """``run()`` (a sharded or coded request on the tables ``x`` / ``y``)
    lets the rect kernel's wrapper finish: its answer is bit for bit the
    composition those executors made before (every launch raw, then
    ``finish_rect_blocks`` with ``rect_table_norms``), every launch passes
    the metric, no ``out`` and the tables' norms positionally, and each
    counts one ``fused.finish{shape=rect}``: in the kernel's epilogue on a
    card up to 32 x 32, in torch beyond it and on the CPU."""
    real, calls = port_ex.fused_gather_gram_rect, []

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    def old(x, y, xidx, xmask, yidx, ymask, metric=None, out=None,
            norms=None):
        g = real(x, y, xidx, xmask, yidx, ymask)
        return fgg.finish_rect_blocks(g, xidx, xmask, yidx, ymask,
                                      *fgg.rect_table_norms(x, y, metric),
                                      metric)

    def finished():
        return [REGISTRY.counter_total("fused.finish", where=w, shape="rect")
                for w in ("kernel", "torch")]
    start = finished()
    port_ex.fused_gather_gram_rect = spy
    try:
        now = run()
    finally:
        port_ex.fused_gather_gram_rect = real
    counts = [b - a for a, b in zip(start, finished())]
    port_ex.fused_gather_gram_rect = old
    try:
        before = run()
    finally:
        port_ex.fused_gather_gram_rect = real
    nan = before.isnan()
    assert torch.equal(now.isnan(), nan)
    assert torch.equal(now[~nan].view(torch.int32),
                       before[~nan].view(torch.int32))
    in_kernel = sum(x.is_cuda and max(a[2].shape[1], a[4].shape[1]) <= 32
                    for a, _kw in calls)
    assert calls and counts == [in_kernel, len(calls) - in_kernel]
    norms = fgg.rect_table_norms(x, y, metric)
    for args, kwargs in calls:
        assert not kwargs and len(args) == 9
        assert args[6] == metric and args[7] is None
        for got, want in zip(args[8], norms):
            assert (got is want is None) or torch.equal(got, want)


def cpu_paths(rank, world, name, pairs_cases, x2y_case):
    """Executor ``name`` ("sharded", or "coded" at its default r=2) on the
    CPU: A2A on each ``(w, x)`` of ``pairs_cases`` over the default group
    (``mesh=None``), then X2Y on ``x2y_case`` with the group passed as
    ``mesh``."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    out = {"pairs": {}}
    for kind, (w, x) in pairs_cases.items():
        ex = make_executor(name)
        before = REGISTRY.counter_total("collective.bytes", op="all_to_all")
        s, _, _ = pairwise_similarity(x, q=1.0, weights=w, executor=ex,
                                      device="cpu")
        out["pairs"][kind] = {"sims": s.numpy(), "stats": ex.stats()}
        if name == "coded":
            out["pairs"][kind]["ledger"] = _coded_ledger(before)
    wx, wy, x, y = x2y_case
    ex = make_executor(name)
    s, _, _ = x2y_similarity(x, y, q=1.0, wx=wx, wy=wy, executor=ex,
                             mesh=dist.group.WORLD, device="cpu")
    out["x2y"] = {"sims": s.numpy(), "stats": ex.stats()}
    svc = PairwiseService(q=1.0, executor=name, mesh=dist.group.WORLD,
                          device="cpu")
    s, info = svc.x2y(x, y, wx, wy)
    out["service"] = {"sims": s.numpy(),
                      **{k: info[k] for k in ("sharded", "coded")
                         if k in info}}
    return out


def fail_on_rank_one(rank, world):
    """Rank 1 raises; rank 0 returns."""
    if rank == 1:
        raise ValueError("rank one gives up")
    return rank


class KernelSpy:
    """Records every launch of the two Gram kernels the executors make,
    with its operands and output, to hold each against its plain version
    afterwards."""

    def __init__(self):
        self.calls = []
        self._orig = (port_ex.fused_gather_gram,
                      port_ex.fused_gather_gram_rect)

    def __enter__(self):
        sq, rect = self._orig

        def spy_sq(*args):
            out = sq(*args)
            self.calls.append(("fused_gather_gram", args, out))
            return out

        def spy_rect(*args):
            out = rect(*args)
            self.calls.append(("fused_gather_gram_rect", args, out))
            return out
        port_ex.fused_gather_gram = spy_sq
        port_ex.fused_gather_gram_rect = spy_rect
        return self

    def __exit__(self, *exc):
        port_ex.fused_gather_gram, port_ex.fused_gather_gram_rect = self._orig

    def max_errs(self) -> dict:
        """Per kernel: launches and the largest difference from the plain
        version on the same operands (asserted within fp32 tolerance)."""
        plain = {"fused_gather_gram": _square_plain,
                 "fused_gather_gram_rect": _rect_plain}
        out = {}
        for name, args, got in self.calls:
            want = plain[name](*args)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
            n, err = out.get(name, (0, 0.0))
            out[name] = (n + 1, max(err, float((got - want).abs().max())
                                    if got.numel() else 0.0))
        return out


def _square_plain(x, idx, mask, metric=None, out=None):
    """The square kernel's plain version, its metric finished in torch
    (``out``, where the kernel wrote, is not needed)."""
    g = fgg.fused_gather_gram_ref(x, idx, mask)
    return g if metric is None else fgg.finish_fused_blocks(g, mask, metric)


def _rect_plain(x, y, xidx, xmask, yidx, ymask, metric=None, out=None,
                norms=None):
    """The rect kernel's plain version, its metric finished in torch
    (``out``, where the kernel wrote, is not needed)."""
    g = fgg.fused_gather_gram_rect_ref(x, y, xidx, xmask, yidx, ymask)
    if metric is None:
        return g
    return fgg.finish_rect_blocks(
        g, xidx, xmask.bool(), yidx, ymask.bool(),
        *(norms or fgg.rect_table_norms(x, y, metric)), metric)


def cuda_paths(rank, world, w, x, wx, wy, xx, yy):
    """Sharded and coded A2A and sharded X2Y on ``cuda:0`` over a gloo
    group: every kernel launch held against its plain version, and the
    ``nvcc`` runs of this process."""
    torch.set_num_threads(1)
    xt = torch.from_numpy(x).cuda()
    out = {}
    with KernelSpy() as spy:
        for name in ("sharded", "coded"):
            s, _, _ = pairwise_similarity(xt, q=1.0, weights=w,
                                          executor=name)
            out[name] = s.cpu().numpy()
        s, _, _ = x2y_similarity(torch.from_numpy(xx).cuda(),
                                 torch.from_numpy(yy).cuda(), q=1.0, wx=wx,
                                 wy=wy, executor="sharded")
        out["sharded_x2y"] = s.cpu().numpy()
    torch.cuda.synchronize()
    out["kernels"] = spy.max_errs()
    out["launches"] = _build.launch_counts()
    out["builds"] = _build.build_counts()
    return out


# ------------------------------------------------- reducer rows over a group
MESH_PATHS = (("dense", False), ("bucketed", False), ("bucketed", True),
              ("fused", False))
MESH_METRICS = ("dot", "cosine")


def ledger_fields(rec) -> dict:
    """The fields of a comm-ledger record (either package's)."""
    return {k: getattr(rec, k) for k in (
        "executor", "workload", "predicted_rows", "lb_rows", "plan_slots",
        "measured_slots", "d", "itemsize", "replication", "assembled_bytes",
        "local_bytes", "residual_bytes", "anomaly", "meta")}


def _gathers() -> float:
    return REGISTRY.counter_total("collective.calls", op="all_gather")


def mesh_paths(rank, world, pairs_case, x2y_case):
    """``dense``, ``bucketed`` (also ``use_kernel=True``) and ``fused`` on
    the CPU with the default group passed as ``mesh``: A2A on
    ``pairs_case = (w, x)`` and X2Y on ``x2y_case = (wx, wy, x, y)``, each
    with the dot and cosine metrics.  Per path: the matrices, the
    all-gathers it made, its ledger records and (rank 0) its plans' arrays;
    then the same A2A with ``mesh=None`` (which must make no collective),
    and a plan not padded to the group's size (which must raise)."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist

    from repro_torch.core import plan_a2a
    from repro_torch.mapreduce import build_plan
    from repro_torch.mapreduce.allpairs import _block_fn
    torch.set_num_threads(1)
    group = dist.group.WORLD
    w, x = pairs_case
    wx, wy, xx, yy = x2y_case
    out = {}
    for name, uk in MESH_PATHS:
        for metric in MESH_METRICS:
            ex = make_executor(name)
            seq, before = LEDGER.seq, _gathers()
            s, plan, _ = pairwise_similarity(
                x, q=1.0, weights=w, metric=metric, executor=ex, mesh=group,
                use_kernel=uk, device="cpu")
            sx, xplan, _ = x2y_similarity(
                xx, yy, q=1.0, wx=wx, wy=wy, metric=metric, executor=ex,
                mesh=group, use_kernel=uk, device="cpu")
            rec = {"pairs": s.numpy(), "x2y": sx.numpy(),
                   "all_gathers": _gathers() - before,
                   "ledger": [ledger_fields(r)
                              for r in LEDGER.records(seq)]}
            if rank == 0:
                rec["plans"] = (dataclasses.asdict(plan),
                                dataclasses.asdict(xplan))
            before = _gathers()
            local, _, _ = pairwise_similarity(
                x, q=1.0, weights=w, metric=metric, executor=name,
                use_kernel=uk, device="cpu")
            rec["local"] = local.numpy()
            rec["local_all_gathers"] = _gathers() - before
            out[(name, uk, metric)] = rec
    plan = build_plan(plan_a2a(w, 1.0))
    uneven = [b.R for b in plan.buckets if b.R % world]
    assert uneven, "the profile's plan must have a bucket to refuse"
    for name, uk in MESH_PATHS:
        try:
            make_executor(name).run_pairs(x, plan, _block_fn("dot", uk),
                                          len(w), mesh=group, device="cpu")
        except ValueError as e:
            out[("uneven", name, uk)] = str(e)
    return out


def stream_paths(rank, world, x, w, rows, row_weight):
    """``PairwiseService(executor='streaming', mesh=group)`` on the CPU:
    ``load_table`` then one ``add_input`` per row of ``rows``; the last
    matrix, the live ids and the table, and the executor's stats."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    svc = PairwiseService(1.0, executor="streaming",
                          mesh=dist.group.WORLD, device="cpu")
    sims, _ = svc.load_table(x, w)
    infos = []
    for row in rows:
        sims, info = svc.add_input(row, row_weight)
        infos.append(info["recompute_fraction"])
    act = svc._planner.active_ids()
    return {"sims": sims.numpy(), "active": act,
            "table": svc._table[act],
            "weights": svc._planner.active_weights(),
            "recompute_fractions": infos, "stats": svc.executor_stats(),
            "all_gathers": _gathers()}


def dryrun_paths(rank, world, m, d, q):
    """The engine's dry run on the CPU over the default group: the
    planner's dense, bucketed, fused and sharded rows and the naive row
    (plans padded to the group's size), the coded frontier, then the
    streaming delta (local), on the reference's Zipf profile; and the
    bytes of the sharded all-gather's tensor from the stacked groups."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.launch import dryrun_engine as de
    from repro_torch.launch.roofline import H100_SXM
    torch.set_num_threads(1)
    group = dist.group.WORLD
    kw = dict(device="cpu", hw=H100_SXM)
    w = de.profile(m, q, True)
    rows, schema, plan, _ = de.engine_rows(w, q, m, d, group, **kw)
    coded = de.analyze_coded(plan, m, d,
                             f"coded-frontier[{schema.algorithm}]", group,
                             **kw)
    stream = de.analyze_streaming(w, q, m, d, "streaming-delta[insert]",
                                  **kw)
    ex = make_executor("sharded")
    groups = ex._groups_for(plan, ex.partition(plan, world))
    local = sum(int(np.prod(i.shape[1:])) * i.shape[2] for i, _k, _r in
                groups)
    return {"rows": rows + [coded, stream],
            "sharded_gather_tensor_bytes": world * local * 4,
            "report": de.report_lines(rows + [coded, stream])}


# ------------------------------------------------- LM stack on a DeviceMesh

def pipeline_paths(rank, world, cases):
    """GPipe over the default group: stage ``rank`` holds ``w[rank]`` of
    each case ``(w (S, D, D), x (M, Bm, D))``; the stage is
    ``tanh(h @ w)``."""
    from repro_torch.parallel import pipeline_apply
    torch.set_num_threads(1)
    return {name: pipeline_apply(lambda p, h: torch.tanh(h @ p),
                                 torch.from_numpy(w[rank]),
                                 torch.from_numpy(x)).numpy()
            for name, (w, x) in cases.items()}


def _lm_batch(arch, case):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg, {k: torch.from_numpy(v) for k, v in case.items()}


def lm_mesh_paths(rank, world, serve_cases, train_case, ckpt_dir):
    """The LM stack on a 2 x 2 ('data', 'model') mesh of the default
    group, fp32, weights from ``build_model(..., seed=0)``: per arch of
    ``serve_cases`` the prefill logits (kernel route) and ``n`` decode
    steps' logits; for ``train_case`` two train steps under each of FSDP
    off / on x ZeRO-1 off / on (metrics, gathered parameters and moments,
    every state leaf's placements against ``make_state_shardings``); the
    ZeRO-1 state saved through ``CheckpointManager`` (rank 0 writes) and
    restored onto a (4, 1) mesh by ``restore(shardings=)``."""
    from repro_torch.launch.mesh import make_local_mesh, make_mesh
    from repro_torch.launch.rules import rules_for
    from repro_torch.models import RuntimeFlags, build_model
    from repro_torch.models.lm import distribute_model
    from repro_torch.train import AdamWConfig, CheckpointManager, \
        init_state, make_train_step, state_from_reference, \
        state_to_reference
    from repro_torch.train.checkpoint import reference_shardings
    from repro_torch.train.train_step import make_state_shardings
    torch.set_num_threads(1)
    mesh = make_local_mesh(model=2)
    out = {"prefill": {}, "decode": {}, "train": {}}

    def model_on(arch, mesh, seed=0, **kw):
        cfg = _lm_batch(arch, {})[0]
        flags = RuntimeFlags(param_dtype="float32", compute_dtype="float32",
                             **kw)
        rules = rules_for(cfg, mesh, flags)
        return distribute_model(build_model(cfg, flags, rules, device="cpu",
                                            seed=seed), mesh, rules)

    for arch, (case, n) in serve_cases.items():
        cfg, batch = _lm_batch(arch, case)
        m = model_on(arch, mesh)
        with torch.no_grad():
            out["prefill"][arch] = m(batch)[0].full_tensor().numpy()
            B = batch["tokens"].shape[0]
            cache = m.init_cache(B, n)
            extra = {"enc_out": m._encode(batch["audio_embeds"])} \
                if "audio_embeds" in batch else {}
            steps = []
            for t in range(n):
                lg, cache = m.decode_step(cache, {
                    "tokens": batch["tokens"][:, t:t + 1], "pos": t,
                    **extra})
                steps.append(lg.full_tensor().numpy())
            out["decode"][arch] = steps

    arch, case = train_case
    _, batch = _lm_batch(arch, case)
    opt = AdamWConfig(warmup_steps=1)
    for fsdp in (False, True):
        for zero1 in (False, True):
            m = model_on(arch, mesh, use_pallas=False, fsdp=fsdp,
                         zero1=zero1)
            state = init_state(m, opt)
            step = make_train_step(m, opt)
            mets = []
            for _ in range(2):
                state, met = step(state, batch)
                mets.append({k: float(v) for k, v in met.items()})
            want = make_state_shardings(m, mesh, m.rules, zero1=zero1)
            rec = {"metrics": mets,
                   "params": {k: p.full_tensor().detach().numpy()
                              for k, p in state["params"].items()},
                   "opt": {k: {n: t.full_tensor().numpy()
                               for n, t in state["opt"][k].items()}
                           for k in ("m", "v")},
                   "placements_ok": all(
                       tuple(state[g][n].placements) == want[g][n]
                       for g in ("params",) for n in state[g]) and all(
                       tuple(state["opt"][k][n].placements)
                       == want["opt"][k][n]
                       for k in ("m", "v") for n in state["opt"][k]),
                   "local_bytes": {n: t.to_local().numel()
                                   for n, t in state["opt"]["m"].items()}}
            out["train"][(fsdp, zero1)] = rec
            if zero1 and not fsdp:
                mgr = CheckpointManager(ckpt_dir)
                mgr.save(2, state_to_reference(m, state))
                mesh41 = make_mesh((4, 1), ("data", "model"))
                m41 = model_on(arch, mesh41, seed=1, use_pallas=False,
                               zero1=True)
                sh = make_state_shardings(m41, mesh41, m41.rules)
                tree, _ = mgr.restore(device="cpu", shardings=(
                    reference_shardings(m41, sh, mesh41)))
                st = state_from_reference(m41, tree)
                out["restored"] = {
                    "params": {k: p.full_tensor().detach().numpy()
                               for k, p in st["params"].items()},
                    "opt": {k: {n: t.full_tensor().numpy()
                                for n, t in st["opt"][k].items()}
                            for k in ("m", "v")},
                    "step": int(st["step"]),
                    "placements_ok": all(
                        tuple(st["params"][n].placements)
                        == sh["params"][n] for n in st["params"]) and all(
                        tuple(st["opt"][k][n].placements)
                        == sh["opt"][k][n]
                        for k in ("m", "v") for n in st["opt"][k])}
    return out


def lm_size1_paths(rank, world, serve_cases, train_cases):
    """The LM stack on meshes with a size-1 axis, or a size-1 dim split
    unevenly, of the default group, fp32, weights from ``build_model(...,
    seed=0)``.  ``serve_cases``: ``{name: (arch, mesh shape, batch, n)}``
    -> prefill logits (kernel route), ``n`` decode steps' logits and every
    parameter's placements; ``train_cases``: ``{name: (arch, mesh shape,
    batch, zero1)}`` -> two train steps' metrics, the gathered parameters
    and moments, and whether every state leaf is placed as
    ``make_state_shardings`` says; or ``{'refused': message}`` where the
    step raised ``ValueError`` (a batch the data axes do not divide)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.rules import rules_for
    from repro_torch.models import RuntimeFlags, build_model
    from repro_torch.models.lm import distribute_model
    from repro_torch.train import AdamWConfig, init_state, make_train_step
    from repro_torch.train.train_step import make_state_shardings
    torch.set_num_threads(1)
    axes = ("data", "model")

    def model_on(arch, shape, **kw):
        cfg = _lm_batch(arch, {})[0]
        mesh = make_mesh(shape, axes)
        flags = RuntimeFlags(param_dtype="float32", compute_dtype="float32",
                             **kw)
        rules = rules_for(cfg, mesh, flags)
        return distribute_model(build_model(cfg, flags, rules, device="cpu",
                                            seed=0), mesh, rules), mesh

    out = {"serve": {}, "train": {}}
    for name, (arch, shape, case, n) in serve_cases.items():
        _, batch = _lm_batch(arch, case)
        m, _ = model_on(arch, shape)
        rec = {"placements": {k: tuple(repr(p) for p in t.placements)
                              for k, t in m.named_parameters()}}
        with torch.no_grad():
            rec["prefill"] = m(batch)[0].full_tensor().numpy()
            cache = m.init_cache(batch["tokens"].shape[0], n)
            rec["decode"] = []
            for t in range(n):
                lg, cache = m.decode_step(cache, {
                    "tokens": batch["tokens"][:, t:t + 1], "pos": t})
                rec["decode"].append(lg.full_tensor().numpy())
        out["serve"][name] = rec

    opt = AdamWConfig(warmup_steps=1)
    for name, (arch, shape, case, zero1) in train_cases.items():
        _, batch = _lm_batch(arch, case)
        m, mesh = model_on(arch, shape, use_pallas=False, zero1=zero1)
        state = init_state(m, opt)
        step = make_train_step(m, opt)
        mets = []
        try:
            for _ in range(2):
                state, met = step(state, batch)
                mets.append({k: float(v) for k, v in met.items()})
        except ValueError as e:         # an uneven split, refused
            out["train"][name] = {"refused": str(e)}
            continue
        want = make_state_shardings(m, mesh, m.rules, zero1=zero1)
        out["train"][name] = {
            "metrics": mets,
            "params": {k: p.full_tensor().detach().numpy()
                       for k, p in state["params"].items()},
            "opt": {k: {n: t.full_tensor().numpy()
                        for n, t in state["opt"][k].items()}
                    for k in ("m", "v")},
            "placements_ok": all(
                tuple(p.placements) == want["params"][n]
                for n, p in state["params"].items()) and all(
                tuple(t.placements) == want["opt"][k][n]
                for k in ("m", "v") for n, t in state["opt"][k].items())}
    return out
