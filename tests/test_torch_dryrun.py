"""The port's analysis package (``repro_torch.launch``) against the JAX
package, on the CPU.

* ``fused_traffic_model`` returns the reference's dict on three plans.
* The work models and ``bound`` moved into ``launch.roofline`` give the
  numbers of the formulas ``chip_smoke.py`` carried before (copied here)
  on the m=256 benchmark profile, so its phases print the same bounds.
* The engine's dry run on 4 gloo ranks (spawned once for this file; the
  rank program is ``tests/_torch_ranks.py::dryrun_paths``) against the
  reference's dry run on a 4-device mesh in a subprocess (its module sets
  ``XLA_FLAGS`` at import, so it never runs in this process): every record
  has every key of the reference's record, and every field the reference
  takes from the plan has the reference's value; the coded frontier's
  measured assembly bytes equal ``coded_assembly_model``'s at the 4-byte
  Gram entries the exchange moves, on every rank; the sharded record's
  collective bytes are the all-gather tensor's in the ring accounting.
* ``obs_report --demo --device cpu``: the ledger summary and event counts
  equal the reference's demo; ``render`` runs; ``--trace`` writes a Chrome
  trace that loads.
"""

import contextlib
import importlib
import io
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro.kernels.pairwise.fused_gather_gram as ref_fgg
import repro.mapreduce as ref_mr
import repro_torch.mapreduce as port_mr
from repro.core import plan_a2a as ref_plan_a2a
from repro_torch.compat import run_local_group
from repro_torch.core import plan_a2a, plan_x2y
from repro_torch.kernels.pairwise import fused_gather_gram as fgg
from repro_torch.launch import roofline as rl
from repro_torch.launch.dryrun_engine import profile
from repro_torch.mapreduce.executors import coded_assembly_model

import _torch_ranks

RANKS = 4
M, D, Q = 48, 8, 4.0


# ------------------------------------------------------ fused_traffic_model
@pytest.mark.parametrize("kind", ["uniform", "zipf", "one-giant"])
def test_fused_traffic_model_equals_reference(kind):
    rng = np.random.default_rng(7)
    w = {"uniform": lambda: rng.uniform(0.05, 0.33, 64),
         "zipf": lambda: np.clip(rng.zipf(1.7, 64) / 24.0, 0.02, 0.45),
         "one-giant": lambda: np.concatenate(
             [[0.8], rng.uniform(0.02, 0.1, 63)])}[kind]()
    ref = ref_mr.build_plan(ref_plan_a2a(w, 1.0))
    plan = port_mr.build_plan(plan_a2a(w, 1.0))
    for d, itemsize, bl in ((256, 2, 128), (2048, 4, 128), (16, 2, 8)):
        assert fgg.fused_traffic_model(plan.buckets, d, itemsize, bl) == \
            ref_fgg.fused_traffic_model(ref.buckets, d, itemsize, bl)


# --------------------------------------------- work models: the old formulas
def _old_bucket_work(x, b):
    n = b.mask.sum(axis=1).astype(np.int64)
    return {"ops": x.shape[1] * int((n * (n + 1)).sum()),
            "bytes": b.R * b.width * 5 + b.R * b.width * b.width * 4}


def _old_work_model(x, plan):
    works = [_old_bucket_work(x, b) for b in plan.buckets]
    return {"ops": sum(w["ops"] for w in works),
            "bytes": x.shape[0] * x.shape[1] * x.element_size()
            + sum(w["bytes"] for w in works)}


def _old_rect_bucket_work(x, b):
    nx = b.mask.sum(axis=1).astype(np.int64)
    ny = b.ymask.sum(axis=1).astype(np.int64)
    return {"ops": 2 * x.shape[1] * int((nx * ny).sum()),
            "bytes": b.R * (b.width + b.ywidth) * 5
            + b.R * b.width * b.ywidth * 4}


def _old_rect_work(x, y, plan):
    works = [_old_rect_bucket_work(x, b) for b in plan.buckets]
    return {"ops": sum(w["ops"] for w in works),
            "bytes": (x.shape[0] + y.shape[0]) * x.shape[1] * x.element_size()
            + sum(w["bytes"] for w in works)}


def _old_pairwise_bucket_work(x, b):
    d, item = x.shape[1], x.element_size()
    return {"ops": b.R * b.width * (b.width + 1) * d,
            "bytes": b.R * b.width * d * item + b.R * b.width * b.width * 4}


def _old_pairwise_work(x, plan):
    works = [_old_pairwise_bucket_work(x, b) for b in plan.buckets]
    return {k: sum(w[k] for w in works) for k in ("ops", "bytes")}


def _old_bound(work, peak_ops):
    t_ops = work["ops"] / peak_ops * 1e3
    t_bytes = work["bytes"] / 3.35e12 * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


@pytest.fixture(scope="module")
def m256():
    """chip_smoke's benchmark profile at m=256 (Zipf a=1.6 / 32, q=1.0,
    seed 0) in fp32 and bf16, and an X2Y plan on its two halves."""
    rng = np.random.default_rng(0)
    w = np.clip(rng.zipf(1.6, 256).astype(np.float64) / 32.0, 0.01, 0.45)
    x = torch.from_numpy(rng.normal(size=(256, 64)).astype(np.float32))
    plan = port_mr.build_plan(plan_a2a(w, 1.0))
    xplan = port_mr.build_x2y_plan(plan_x2y(w[:192], w[192:], 1.0), 192)
    return {"x": x, "plan": plan, "xplan": xplan}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("model", ["bucket_work", "work_model",
                                   "rect_bucket_work", "rect_work",
                                   "pairwise_bucket_work", "pairwise_work"])
def test_moved_work_models_keep_the_old_formulas(m256, model, dtype):
    x = m256["x"].to(dtype)
    plan, xplan = m256["plan"], m256["xplan"]
    xt, yt = x[:192], x[192:]
    d, isz = x.shape[1], x.element_size()
    got, want = {
        "bucket_work": lambda: (
            [rl.bucket_work(b, d) for b in plan.buckets],
            [_old_bucket_work(x, b) for b in plan.buckets]),
        "work_model": lambda: (rl.work_model(plan, *x.shape, isz),
                               _old_work_model(x, plan)),
        "rect_bucket_work": lambda: (
            [rl.rect_bucket_work(b, d) for b in xplan.buckets],
            [_old_rect_bucket_work(xt, b) for b in xplan.buckets]),
        "rect_work": lambda: (rl.rect_work(xplan, 256, d, isz),
                              _old_rect_work(xt, yt, xplan)),
        "pairwise_bucket_work": lambda: (
            [rl.pairwise_bucket_work(b, d, isz) for b in plan.buckets],
            [_old_pairwise_bucket_work(x, b) for b in plan.buckets]),
        "pairwise_work": lambda: (rl.pairwise_work(plan, d, isz),
                                  _old_pairwise_work(x, plan)),
    }[model]()
    assert got == want
    for g, v in zip(got if isinstance(got, list) else [got],
                    want if isinstance(want, list) else [want]):
        for peak in (rl.PEAK_FP32_CUDA_CORES, rl.PEAK_BF16_TENSOR):
            assert rl.bound(g, peak) == _old_bound(v, peak)


def test_hw_peaks_and_unknown_devices():
    assert rl.H100_SXM.peak_flops == 989e12
    assert rl.H100_SXM.peak_fp32_flops == 67e12
    assert rl.H100_SXM.hbm_bw == 3.35e12 and rl.H100_SXM.link_bw == 450e9
    assert (rl.PEAK_FP32_CUDA_CORES, rl.PEAK_BF16_TENSOR, rl.PEAK_HBM) == (
        67e12, 989e12, 3.35e12)
    with pytest.raises(ValueError, match="not a CUDA card"):
        rl.HW.for_device("cpu")


def test_combine_stats_sums():
    a = rl.Stats(1.0, 2.0, 3.0, 1, {"all-gather": 3.0})
    b = rl.Stats(10.0, 20.0, 30.0, 2, {"all-gather": 1.0, "all-to-all": 29})
    s = rl.combine_stats([a, b])
    assert (s.flops, s.hbm_bytes, s.collective_bytes, s.collective_ops) == (
        11.0, 22.0, 33.0, 3)
    assert s.collective_by_kind == {"all-gather": 4.0, "all-to-all": 29}


def test_dryrun_refuses_the_reference_results_dir():
    from repro_torch.launch import dryrun_engine as de
    with pytest.raises(ValueError, match="does not write under"):
        de.main(["--device", "cpu", "--out",
                 str(de.FORBIDDEN_OUT / "engine_a2a.json")])


# ------------------------------------------------------- the engine dry run
_REF_SCRIPT = textwrap.dedent("""
    import json
    import numpy as np
    from repro.launch import dryrun_engine as de
    from repro.compat import make_mesh
    from repro.core import naive_pairs, plan_a2a
    from repro.mapreduce.engine import build_plan
    m, d, q, S = {m}, {d}, {q}, {S}
    rng = np.random.default_rng(0)
    w = np.clip(rng.zipf(1.6, m) / 16.0, 0.05, q * 0.45)
    mesh = make_mesh((S,), ("shard",))
    schema = plan_a2a(w, q)
    plan_opt = build_plan(schema, pad_reducers_to=S)
    plan_nv = build_plan(naive_pairs(w, q), pad_reducers_to=S)
    bucketed = de.analyze_bucketed(plan_opt, m, d, mesh,
                                   f"planner-bucketed[{{schema.algorithm}}]")
    rows = [de.analyze(plan_opt, m, d, mesh,
                       f"planner[{{schema.algorithm}}]"), bucketed,
            de.analyze_fused(plan_opt, m, d, mesh,
                             f"planner-fused[{{schema.algorithm}}]",
                             bucketed_rec=bucketed),
            de.analyze_sharded(plan_opt, m, d, mesh,
                               f"planner-sharded[{{schema.algorithm}}]"),
            de.analyze(plan_nv, m, d, mesh, "naive-all-pairs")]
    base = rows[-1]
    for r in rows:
        r["shuffle_bytes_vs_naive"] = (
            r["hbm_bytes_per_device"] / max(base["hbm_bytes_per_device"], 1))
        r["comm_cost_vs_naive"] = (
            r["schema_comm_cost_rows"] / base["schema_comm_cost_rows"])
    rows.append(de.analyze_coded(plan_opt, m, d,
                                 f"coded-frontier[{{schema.algorithm}}]",
                                 num_shards=S))
    rows.append(de.analyze_streaming(w, q, m, d, "streaming-delta[insert]"))
    print("REF_ROWS", json.dumps(rows, default=float))
""")

# fields the reference takes from the plan, per kind of record
PLAN_FIELDS = ["reducers", "slots", "padded_elements",
               "schema_comm_cost_rows", "comm_cost_vs_naive",
               "bucket_widths", "padding_savings", "fused_model",
               "schema_comm_bytes", "schema_lower_bound_bytes", "num_shards",
               "balance_factor", "shipped_rows_per_shard_max",
               "shipped_rows_per_shard_mean", "padded_elements_per_shard_max",
               "schema_lb_bytes_per_shard", "best_replication", "edit",
               "dirty_reducers", "recompute_fraction", "gap_drift",
               "delta_comm_bytes", "replan_comm_bytes",
               "delta_vs_replan_bytes"]
FRONTIER_FIELDS = ["replication", "model_assembly_bytes_per_shard",
                   "local_fraction", "shipped_bytes"]


@pytest.fixture(scope="module")
def dryruns():
    env = {"PYTHONPATH": "src", "PATH": os.environ.get("PATH", ""),
           "JAX_PLATFORMS": os.environ.get("JAX_PLATFORMS", "cpu"),
           "HOME": os.environ.get("HOME", "/tmp")}
    ref = subprocess.Popen(
        [sys.executable, "-c", _REF_SCRIPT.format(m=M, d=D, q=Q, S=RANKS)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=os.path.join(os.path.dirname(__file__), ".."))
    try:
        ranks = run_local_group(_torch_ranks.dryrun_paths, RANKS, M, D, Q,
                                timeout_s=120.0)
        out, err = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    line = [x for x in out.splitlines() if x.startswith("REF_ROWS ")]
    assert ref.returncode == 0 and line, out + err
    return json.loads(line[0][len("REF_ROWS "):]), ranks


def _same(got, want, what):
    if isinstance(want, float) or isinstance(got, float):
        assert got == pytest.approx(want, rel=1e-12, abs=0.0), what
    elif isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _same(got[k], want[k], f"{what}.{k}")
    else:
        assert got == want, (what, got, want)


@pytest.mark.parametrize("row", range(7))
def test_dryrun_records_have_the_reference_keys_and_plan_fields(dryruns,
                                                                row):
    ref_rows, ranks = dryruns
    want = ref_rows[row]
    for res in ranks:
        got = res["rows"][row]
        assert got["name"] == want["name"]
        missing = set(want) - set(got)
        assert not missing, (want["name"], missing)
        for k in PLAN_FIELDS:
            if k in want:
                _same(got[k], want[k], f"{want['name']}.{k}")
        for gp, wp in zip(got.get("pareto_frontier", []),
                          want.get("pareto_frontier", [])):
            assert not set(wp) - set(gp), set(wp) - set(gp)
            for k in FRONTIER_FIELDS:
                _same(gp[k], wp[k], f"{want['name']}.frontier.{k}")
        assert got["device_ms"] is None and got["peak_alloc_bytes"] is None
        if "measured_by" in got:
            assert set(got["measured_by"].values()) <= {"model", "counter"}


def test_dryrun_coded_measured_bytes_equal_the_model(dryruns):
    """Every rank's measured all-to-all bytes per shard (counters, ring
    accounting) equal ``coded_assembly_model``'s at 4-byte entries, and
    the reference's HLO-measured bytes for the same exchange."""
    ref_rows, ranks = dryruns
    w = profile(M, Q, True)
    plan = port_mr.build_plan(plan_a2a(w, Q), pad_reducers_to=RANKS)
    ref_coded = ref_rows[5]
    for res in ranks:
        coded = res["rows"][5]
        assert coded["num_shards"] == RANKS
        assert len(coded["pareto_frontier"]) == len(
            ref_coded["pareto_frontier"])
        for p, rp in zip(coded["pareto_frontier"],
                         ref_coded["pareto_frontier"]):
            model = coded_assembly_model(plan, RANKS, p["replication"], M,
                                         itemsize=4)
            assert p["measured_assembly_bytes_per_shard"] == \
                model["assembly_bytes_per_shard"]
            assert p["model_assembly_bytes_per_shard_fp32"] == \
                model["assembly_bytes_per_shard"]
            assert p["measured_assembly_bytes_per_shard"] == \
                rp["measured_assembly_bytes_per_shard"]


def test_dryrun_sharded_collective_bytes_are_the_all_gathers(dryruns):
    _, ranks = dryruns
    for res in ranks:
        rec = res["rows"][3]
        assert rec["num_shards"] == RANKS
        tensor = res["sharded_gather_tensor_bytes"]
        assert rec["collective_tensor_bytes"] == tensor
        assert rec["collective_bytes_per_device"] == \
            tensor * (RANKS - 1) / RANKS
        assert rec["measured_by"]["collective_bytes_per_device"] == \
            "counter"


def test_dryrun_report_prints_every_row(dryruns):
    _, ranks = dryruns
    lines = ranks[0]["report"]
    for rec in ranks[0]["rows"]:
        assert any(line.startswith(rec["name"]) for line in lines)
    assert any("device_ms=n/a" in line for line in lines)


def test_dryrun_main_on_the_cpu(tmp_path):
    from repro_torch.launch import dryrun_engine as de
    out = tmp_path / "dry.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert de.main(["--device", "cpu", "--m", "32", "--d", "8", "--q",
                        "4", "--zipf", "--out", str(out)]) == 0
    rows = json.loads(out.read_text())
    assert [r["name"].split("[")[0] for r in rows] == [
        "planner", "planner-bucketed", "planner-fused", "planner-sharded",
        "naive-all-pairs", "coded-frontier", "streaming-delta"]
    assert "wrote" in buf.getvalue()


# ------------------------------------------------------------- obs report
# entries the demo may add to a cache; the caps are raised by this much
# above what the process already holds, so the demo evicts nothing
DEMO_CACHE_ROOM = 64


def _make_room(pkg: str):
    """Room in package ``pkg``'s caches for the demo, through their public
    functions: the jit / upload LRU and the block cache get caps above
    their present size plus ``DEMO_CACHE_ROOM``, ``PLAN_CACHE`` is
    cleared.  Earlier test files on the same worker may have filled either
    package's LRU, and an eviction is an event the other package's demo
    does not emit.  Returns a function that restores the caps."""
    mr = importlib.import_module(f"{pkg}.mapreduce")
    core = importlib.import_module(f"{pkg}.core")
    jit, blk = mr.jit_cache_stats(), mr.block_cache_stats()
    mr.configure_jit_cache(jit["size"] + DEMO_CACHE_ROOM)
    mr.configure_block_cache(blk["max_size"] + DEMO_CACHE_ROOM)
    core.PLAN_CACHE.clear()

    def restore():
        mr.configure_jit_cache(jit["max_size"])
        mr.configure_block_cache(blk["max_size"])
    return restore


def _demo_doc(report, obs):
    """The demo's document, with the ledger records the demo took (the
    ledger's sequence number counts every record the process took)."""
    port = "repro_torch" in report.__name__
    restore = _make_room("repro_torch" if port else "repro")
    try:
        obs.reset_all()
        seq = obs.LEDGER.seq
        report.run_demo(**({"device": "cpu"} if port else {}))
        doc = report.gather()
    finally:
        restore()
    doc["ledger"]["records"] -= seq
    return doc


def _demo_matches_reference(tmp_path):
    import repro.launch.obs_report as ref_report
    import repro.obs as ref_obs
    import repro_torch.obs as port_obs
    from repro_torch.launch import obs_report
    want = _demo_doc(ref_report, ref_obs)
    got = _demo_doc(obs_report, port_obs)
    assert got["ledger"]["summary"] == want["ledger"]["summary"]
    assert got["ledger"]["records"] == want["ledger"]["records"] == 2
    assert got["events"]["counts"] == want["events"]["counts"]
    text = obs_report.render(got)
    assert "== obs report ==" in text and "fused/pairs" in text
    trace = tmp_path / "t.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert obs_report.main(["--demo", "--device", "cpu", "--json",
                                "--trace", str(trace)]) == 0
    doc = json.loads(buf.getvalue())
    assert doc["trace"]["exported_to"] == str(trace)
    spans = json.loads(trace.read_text())
    assert spans["traceEvents"], spans
    port_obs.reset_all()


def test_obs_report_demo_matches_reference(tmp_path):
    _demo_matches_reference(tmp_path)


def test_obs_report_demo_after_a_full_reference_jit_cache(tmp_path):
    """The comparison after earlier work filled the reference's jit LRU to
    its cap, as test files that ran before on the same worker can: the
    demo must still emit the same events as the port's."""
    import repro.mapreduce.engine as ref_engine
    cap = ref_engine.jit_cache_stats()["max_size"]
    keys = [("filler", i) for i in range(cap)]
    for k in keys:
        ref_engine._cache_get(k, lambda: None)
    try:
        assert ref_engine.jit_cache_stats()["size"] == cap
        _demo_matches_reference(tmp_path)
    finally:
        for k in keys:
            ref_engine._JIT_CACHE.pop(k, None)
            ref_engine._JIT_CACHE_HITS.pop(k, None)
