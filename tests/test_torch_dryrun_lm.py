"""The LM dry run (``repro_torch.launch.dryrun``) and its per-op counts
(``launch.op_analysis``), on the CPU.

The dry run joins a fake process group of its own, so it runs in a
subprocess (never in the pytest worker, where a default group would
change what later test files on that worker see):
* one smoke-config cell per kind on a 2 x 2 fake mesh —
  ``stablelm-1.6b-smoke`` prefill_32k, ``jamba-1.5-large-398b-smoke``
  train_4k (attention, Mamba, MoE; loss, backward and AdamW),
  ``granite-34b-smoke`` decode_32k (one KV head, the cache's sequence
  over 'model') — is ``ok`` and its row holds every ``RooflineReport``
  field;
* the dense prefill's FLOPs, over the 4 devices, equal ``model_flops``
  plus the plain attention's 4·B·S²·H·D per layer within 5% of their sum;
* ``run_cell`` writes under ``build/`` and refuses
  ``benchmarks/results/dryrun/``; the module refuses a real group;
* ``main()`` runs a full-size cell on the production pod mesh.
In this process, ``OpCounter`` counts a GEMM and the plain grouped
attention exactly as written out by hand.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.op_analysis import count_ops
from repro_torch.launch.roofline import RooflineReport
from repro_torch.models.layers import _grouped_attention

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELLS = [("stablelm-1.6b-smoke", "prefill_32k"),
         ("jamba-1.5-large-398b-smoke", "train_4k"),
         ("granite-34b-smoke", "decode_32k")]

SCRIPT = textwrap.dedent("""
    import json, sys
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    out = {"cells": {}}
    for arch, shape in json.loads(sys.argv[2]):
        out["cells"][arch + "/" + shape] = dryrun.run_cell(
            arch, shape, False, skip_existing=False,
            results_dir=sys.argv[1], mesh_shape=((2, 2), ("data", "model")))
    rec = dryrun.run_cell("stablelm-1.6b-smoke", "decode_32k", False,
                          skip_existing=False,
                          mesh_shape=((2, 2), ("data", "model")))
    out["default_dir"] = [dryrun.RESULTS_DIR, rec["status"]]
    try:
        dryrun.run_cell("stablelm-1.6b-smoke", "decode_32k", False,
                        results_dir="benchmarks/results/dryrun")
    except ValueError:
        out["refused_reference_dir"] = True
    dist.destroy_process_group()
    dist.init_process_group("gloo", init_method="file://" + sys.argv[3],
                            rank=0, world_size=1)
    try:
        dryrun.fake_world(4)
    except RuntimeError:
        out["refused_real_group"] = True
    print("RESULT " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dry")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(tmp / "out"), json.dumps(CELLS),
         str(tmp / "store")], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("RESULT ")]
    assert proc.returncode == 0 and lines, proc.stdout + proc.stderr
    return json.loads(lines[-1][len("RESULT "):]), tmp


@pytest.mark.parametrize("cell", [f"{a}/{s}" for a, s in CELLS])
def test_smoke_cell_per_kind_is_ok(dry, cell):
    out, tmp = dry
    rec = out["cells"][cell]
    assert rec["status"] == "ok", rec.get("error")
    fields = {f.name for f in dataclasses.fields(RooflineReport)}
    assert fields <= set(rec), fields - set(rec)
    assert rec["mesh"] == "2x2" and rec["num_devices"] == 4
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["collectives"]["ops"] > 0
    mem = rec["memory_per_device"]
    assert mem["argument_bytes"] > 0
    assert all(isinstance(mem[k], int) for k in (
        "argument_bytes", "output_bytes", "temp_bytes", "peak_bytes")), mem
    assert mem["peak_bytes"] >= mem["argument_bytes"]
    assert mem["temp_bytes"] >= 0
    assert rec["peak_counted_on"] == "meta"
    arch, shape = cell.split("/")
    assert (tmp / "out" / f"{arch}__{shape}__2x2.json").exists()


def test_prefill_flops_agree_with_model_flops(dry):
    out, _ = dry
    rec = out["cells"]["stablelm-1.6b-smoke/prefill_32k"]
    cfg = get_config("stablelm-1.6b-smoke")
    seq, batch, _ = SHAPES["prefill_32k"]
    layers = sum(k["mixer"] == "attn" for k in cfg.layer_kinds())
    attn = 4.0 * batch * seq * seq * cfg.num_heads * cfg.head_dim_() \
        * layers
    counted = rec["flops_per_device"] * rec["num_devices"]
    want = rec["model_flops_global"] + attn
    assert abs(counted - want) <= 0.05 * want, (counted, want)


def test_run_cell_writes_only_under_build(dry):
    out, _ = dry
    assert pathlib.Path(out["default_dir"][0]) == ROOT / "build" / \
        "dryrun_lm"
    assert out["default_dir"][1] == "ok"
    assert out["refused_reference_dir"]
    assert out["refused_real_group"]
    assert not (ROOT / "benchmarks" / "results" / "dryrun" /
                "stablelm-1.6b-smoke__decode_32k__2x2.json").exists()


def test_main_runs_a_production_cell(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "stablelm-1.6b", "--shape", "decode_32k", "--mesh", "pod",
         "--out-dir", str(tmp_path)], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[ok     ] stablelm-1.6b" in proc.stdout
    rec = json.loads((tmp_path /
                      "stablelm-1.6b__decode_32k__pod_16x16.json").read_text())
    assert rec["num_devices"] == 256 and rec["flags"]["use_pallas"] is False


def test_op_counter_by_hand():
    x, w = torch.randn(8, 32), torch.randn(32, 16)
    _, st = count_ops(lambda: x @ w)
    assert st.flops == 2 * 8 * 32 * 16
    assert st.hbm_bytes == (8 * 32 + 32 * 16 + 8 * 16) * 4
    B, S, H, Hkv, D = 2, 16, 4, 2, 8
    q = torch.randn(B, S, H, D)
    k, v = torch.randn(B, S, Hkv, D), torch.randn(B, S, Hkv, D)
    _, st = count_ops(lambda: _grouped_attention(
        q, k, v, causal=True, window=0, q_pos=torch.arange(S), kv_len=S))
    # QK and PV products, the scale's multiply, the positions' subtract
    assert st.flops == 4 * B * H * S * S * D + B * H * S * S + S * S
    assert st.collective_ops == 0
