"""Layouts with a mesh axis of size 1, where a size-1 tensor dim (global
batch 1, Granite's one KV head) is named on it: ``parallel.placements``
makes such a mesh dim ``Replicate()``, which is the same layout as
``Shard`` there and which DTensor's view rules take.

* The fake-backend grid (one subprocess, ``launch.dryrun.lower_cell`` on
  meta, every config cut to at most 2 layers, ``(seq, batch)`` of
  ``(64, batch)``): every smoke config at global batch 1 on a 1 x 1
  ('data', 'model') mesh for each shape the reference's
  ``shape_applicable`` allows; ``granite-34b-smoke`` at batch 2 on 1 x 1
  and 1 x 4, and at batch 4 on 4 x 1; ``stablelm-1.6b-smoke`` at batch 1
  on 1 x 4 and on a 1 x 1 x 1 ('pod', 'data', 'model') mesh.  Each lowers
  and gives the memory fields.  A batch the data axes do not divide
  (batch 1 on 2 x 2, Granite's batch 2 on 4 x 1) is refused with a
  message naming the dim and the axes, as the reference's jit refuses it.
* In the same subprocess, each 1 x 1 batch-1 cell's step on real CPU
  tensors (fp32, ``(16, 1)``) on the fake one-rank mesh against the same
  step with no mesh, and ``placements`` on that mesh; ``placements`` and
  ``check_even`` on stub meshes of other shapes.
* On 4 gloo ranks (one spawn, ``tests/_torch_ranks.py::lm_size1_paths``),
  fp32: Granite's prefill and 4 decode steps on (4, 1) ('model' of 1
  holds its one KV head); Granite on (1, 4), where 'model' does not divide
  the KV head and the rules replicate it; two ``mixtral-8x7b-smoke`` train
  steps at global batch 1 on (1, 4) under ZeRO-1 ('data' of 1); a batch-1
  train step on (2, 2), refused.  Against the one-rank port at
  ``MESH_TOL`` (serving) and ``STATE_TOL`` (train metrics and state), and,
  prefill and the first step's loss, against the reference at
  ``REF_TOL``: the tolerances of ``tests/test_torch_lm_sharded.py``.
"""

import json
import os
import pathlib
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import make_mesh as ref_make_mesh
from repro.configs.base import get_config as ref_config
from repro.launch.specs import shape_applicable as ref_shape_applicable
from repro.models import RuntimeFlags as RefFlags
from repro.models import build_model as ref_build
from repro.parallel.sharding import ShardingRules as RefRules
from repro.train import AdamWConfig as RefAdam
from repro.train import make_train_step as ref_train_step
from repro.train.optimizer import adamw_init as ref_adamw_init
from repro_torch.compat import run_local_group
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.models import RuntimeFlags, build_model, \
    export_reference_params
from repro_torch.parallel.sharding import check_even, placements
from repro_torch.train import AdamWConfig, init_state, make_train_step

import _torch_ranks

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESH_TOL = dict(rtol=1e-4, atol=1e-4)
REF_TOL = dict(rtol=2e-3, atol=2e-3)
STATE_TOL = dict(rtol=1e-5, atol=1e-5)
DM = ("data", "model")
GRANITE, MIXTRAL, STABLELM = ("granite-34b-smoke", "mixtral-8x7b-smoke",
                              "stablelm-1.6b-smoke")
KINDS = ("train_4k", "prefill_32k", "decode_32k")

# (arch, shape, global batch, mesh shape, axis names)
ONE_BY_ONE = [(a + "-smoke", s, 1, (1, 1), DM) for a in list_archs()
              for s in SHAPES
              if ref_shape_applicable(ref_config(a + "-smoke"), s)[0]]
CELLS = ONE_BY_ONE + [
    *((GRANITE, s, b, m, DM) for b, m in ((2, (1, 1)), (2, (1, 4)),
                                          (4, (4, 1))) for s in KINDS),
    *((STABLELM, s, 1, m, ax) for m, ax in (((1, 4), DM),
                                            ((1, 1, 1), ("pod",) + DM))
      for s in KINDS)]
# batches the data axes do not divide: (cell, dim size, axes, ranks)
REFUSED = [((STABLELM, "train_4k", 1, (2, 2), DM), 1, "('data',)", 2),
           ((GRANITE, "train_4k", 2, (4, 1), DM), 2, "('data',)", 4)]


def _key(cell) -> str:
    arch, shape, b, mesh, axes = cell
    return f"{arch}/{shape}/b{b}/{'x'.join(map(str, mesh))}/{len(axes)}"


GRID_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import default_flags
    from repro_torch.parallel.sharding import placements

    def cut(arch):
        cfg = get_config(arch)
        return dataclasses.replace(cfg, num_layers=min(2, cfg.num_layers))

    out = {"cells": {}, "values": {}}
    for key, (arch, shape, b, mesh, axes) in json.loads(sys.argv[1]):
        try:
            _, ctx = dryrun.lower_cell(arch, shape, False,
                                       mesh_shape=(tuple(mesh), tuple(axes)),
                                       cfg=cut(arch), seq_batch=(64, b))
            out["cells"][key] = {"status": "ok", "memory": ctx["memory"],
                                 "layers": ctx["cfg"].num_layers}
        except ValueError as e:
            out["cells"][key] = {"status": "refused", "error": str(e)}

    # the 1 x 1 batch-1 steps on CPU tensors, with and without the mesh
    dryrun.fake_world(1)
    mesh = make_mesh((1, 1), ("data", "model"))
    out["placements"] = [repr(p) for p in placements(
        mesh, (("data",), None, "model"))]
    for key, (arch, shape) in json.loads(sys.argv[2]):
        cfg = cut(arch)
        flags = dataclasses.replace(default_flags(cfg, shape, mesh),
                                    param_dtype="float32",
                                    compute_dtype="float32")
        got = []
        for m in (None, mesh):
            run, _ = dryrun.cell_step(cfg, shape, flags, m,
                                      seq_batch=(16, 1), device="cpu")
            res = run()
            if shape == "train_4k":             # (state, metrics)
                got.append({k: float(v) for k, v in res[1].items()})
                continue
            if shape != "prefill_32k":          # decode: (logits, cache)
                res = res[0]
            full = res.full_tensor() if m is not None else res
            got.append(full.float().tolist())
        out["values"][key] = got
    print("RESULT " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def grid():
    cells = [(_key(c), c) for c in CELLS + [c for c, *_ in REFUSED]]
    steps = [(_key(c), c[:2]) for c in ONE_BY_ONE]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-c", GRID_SCRIPT, json.dumps(cells),
         json.dumps(steps)], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("RESULT ")]
    assert proc.returncode == 0 and lines, proc.stdout + proc.stderr
    return json.loads(lines[-1][len("RESULT "):])


@pytest.mark.parametrize("cell", CELLS, ids=_key)
def test_cell_lowers_with_memory_fields(grid, cell):
    rec = grid["cells"][_key(cell)]
    assert rec["status"] == "ok", rec
    assert rec["layers"] <= 2
    mem = rec["memory"]
    assert set(mem) == {"argument_bytes", "output_bytes", "temp_bytes",
                        "peak_bytes"}
    assert mem["peak_bytes"] - mem["temp_bytes"] >= \
        mem["argument_bytes"] > 0


@pytest.mark.parametrize("cell,size,axes,ranks", REFUSED,
                         ids=[_key(c) for c, *_ in REFUSED])
def test_uneven_batch_is_refused(grid, cell, size, axes, ranks):
    rec = grid["cells"][_key(cell)]
    assert rec["status"] == "refused", rec
    assert rec["error"].startswith(
        f"dim 0 ('batch') of size {size} does not divide over mesh axes "
        f"{axes} of {ranks} ranks"), rec["error"]


def test_size1_mesh_dims_are_replicated(grid):
    assert grid["placements"] == ["Replicate()", "Replicate()"]


def _stub_mesh(shape, axes):
    return types.SimpleNamespace(mesh_dim_names=axes,
                                 mesh=torch.empty(shape))


# (mesh shape, axes, spec) -> the placements, as reprs
PLACED = [
    ((1, 4), DM, (("data",), "model"), ("Replicate()", "Shard(dim=1)")),
    ((4, 1), DM, ("data", "model"), ("Shard(dim=0)", "Replicate()")),
    ((2, 2), DM, ("data", "model"), ("Shard(dim=0)", "Shard(dim=1)")),
    ((1, 1, 1), ("pod",) + DM, (("pod", "data"), None, "model"),
     ("Replicate()",) * 3),
    ((2, 1, 4), ("pod",) + DM, (("pod", "data"), None, "model"),
     ("Shard(dim=0)", "Replicate()", "Shard(dim=2)")),
]


@pytest.mark.parametrize("shape,axes,spec,want", PLACED)
def test_placements_replicate_on_size1_mesh_dims(shape, axes, spec, want):
    got = placements(_stub_mesh(shape, axes), spec)
    assert tuple(repr(p) for p in got) == want


@pytest.mark.parametrize("shape,axes,spec,dims,ok", [
    ((2, 2), DM, ("data", None), (2, 8), True),
    ((2, 2), DM, ("data", None), (1, 8), False),
    ((4, 1), DM, ("data", "model"), (4, 1), True),
    ((4, 1), DM, ("data", "model"), (2, 1), False),
    ((2, 1, 4), ("pod",) + DM, (("pod", "data"), "model"), (2, 4), True),
    ((2, 1, 4), ("pod",) + DM, (("pod", "data"), "model"), (2, 6), False),
])
def test_check_even(shape, axes, spec, dims, ok):
    mesh = _stub_mesh(shape, axes)
    pl = placements(mesh, spec)
    if ok:
        check_even(dims, mesh, pl, ("batch", "x"))
    else:
        with pytest.raises(ValueError, match=r"^dim \d \('(batch|x)'\)"):
            check_even(dims, mesh, pl, ("batch", "x"))


@pytest.mark.parametrize("cell", ONE_BY_ONE, ids=_key)
def test_one_by_one_step_equals_no_mesh(grid, cell):
    no_mesh, mesh = grid["values"][_key(cell)]
    if cell[1] == "train_4k":
        assert set(mesh) == set(no_mesh)
        for k, v in no_mesh.items():
            np.testing.assert_allclose(mesh[k], v, **STATE_TOL, err_msg=k)
    else:
        np.testing.assert_allclose(np.asarray(mesh), np.asarray(no_mesh),
                                   **MESH_TOL)


# ------------------------------------------------------------ gloo ranks

S, N_DEC = 8, 4


def _batch(arch, B, train=False, seed=0):
    cfg = get_config(arch)
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64)
    out = {"tokens": tok}
    if train:
        out["targets"] = np.roll(tok, -1, axis=1)
        out["mask"] = np.ones((B, S), np.float32)
    return out


SERVE = {"granite_4x1": (GRANITE, (4, 1), _batch(GRANITE, 4), N_DEC),
         "granite_1x4": (GRANITE, (1, 4), _batch(GRANITE, 2), N_DEC)}
TRAIN = {"mixtral_b1_1x4": (MIXTRAL, (1, 4), _batch(MIXTRAL, 1, True),
                            True),
         "mixtral_b1_2x2": (MIXTRAL, (2, 2), _batch(MIXTRAL, 1, True),
                            True)}


@pytest.fixture(scope="module")
def ranks():
    return run_local_group(_torch_ranks.lm_size1_paths, 4, SERVE, TRAIN,
                           timeout_s=300.0)


def _port(arch, **kw):
    flags = RuntimeFlags(param_dtype="float32", compute_dtype="float32",
                         **kw)
    return build_model(get_config(arch), flags, device="cpu", seed=0)


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _ref_model(arch):
    flags = RefFlags(param_dtype="float32", compute_dtype="float32",
                     remat="none")
    return ref_build(ref_config(arch), flags,
                     RefRules.create(ref_make_mesh((1,), ("data",))))


def _ref_params(model):
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                        export_reference_params(model))


@pytest.mark.parametrize("name", list(SERVE))
def test_granite_prefill_and_decode(ranks, name):
    arch, _, case, n = SERVE[name]
    model, batch = _port(arch), _t(case)
    with torch.no_grad():
        want = model(batch)[0].numpy()
        cache = model.init_cache(case["tokens"].shape[0], n)
        steps = []
        for t in range(n):
            lg, cache = model.decode_step(cache, {
                "tokens": batch["tokens"][:, t:t + 1], "pos": t})
            steps.append(lg.numpy())
    for r in ranks:
        rec = r["serve"][name]
        np.testing.assert_allclose(rec["prefill"], want, **MESH_TOL)
        for got, w in zip(rec["decode"], steps):
            np.testing.assert_allclose(got, w, **MESH_TOL)
    ref = _ref_model(arch)
    got, _, _ = ref.forward(_ref_params(model),
                            {k: jnp.asarray(v) for k, v in case.items()})
    np.testing.assert_allclose(ranks[0]["serve"][name]["prefill"],
                               np.asarray(got), **REF_TOL)


@pytest.mark.parametrize("name", list(SERVE))
def test_granite_kv_head_is_whole_on_every_rank(ranks, name):
    """On (4, 1) 'model' of 1 holds the one KV head whole; on (1, 4) the
    rules replicate it, as 'model' does not divide it.  Either way every
    KV weight is ``Replicate()`` on every mesh dim."""
    pl = ranks[0]["serve"][name]["placements"]
    kv = [k for k in pl if k.split(".")[-1] in ("wk", "wv")]
    assert kv and all(pl[k] == ("Replicate()", "Replicate()") for k in kv)
    # the query heads split over a 'model' of 4, and only there
    wq = [pl[k] for k in pl if k.endswith(".wq")]
    split = name == "granite_1x4"
    assert wq and all((p[1] != "Replicate()") == split for p in wq)


@pytest.fixture(scope="module")
def one_rank_train():
    arch, _, case, _ = TRAIN["mixtral_b1_1x4"]
    model = _port(arch, use_pallas=False)
    opt = AdamWConfig(warmup_steps=1)
    state, step = init_state(model, opt), make_train_step(model, opt)
    mets = []
    for _ in range(2):
        state, met = step(state, case)
        mets.append({k: float(v) for k, v in met.items()})
    return state, mets


def test_batch1_train_on_a_size1_data_axis(ranks, one_rank_train):
    state, mets = one_rank_train
    for r in ranks:
        rec = r["train"]["mixtral_b1_1x4"]
        assert rec["placements_ok"]
        for got, want in zip(rec["metrics"], mets):
            for k in ("loss", "ce", "aux", "grad_norm", "lr"):
                np.testing.assert_allclose(got[k], want[k], **STATE_TOL,
                                           err_msg=k)
        for k, p in state["params"].items():
            np.testing.assert_allclose(rec["params"][k],
                                       p.detach().numpy(), **STATE_TOL,
                                       err_msg=k)
        for g in ("m", "v"):
            for k, t in state["opt"][g].items():
                np.testing.assert_allclose(rec["opt"][g][k], t.numpy(),
                                           **STATE_TOL, err_msg=k)


def test_batch1_first_loss_against_the_reference(ranks):
    arch, _, case, _ = TRAIN["mixtral_b1_1x4"]
    model = _port(arch, use_pallas=False)
    params = _ref_params(model)
    opt = RefAdam(warmup_steps=1)
    state = {"params": params, "opt": ref_adamw_init(params, opt),
             "step": jnp.zeros((), jnp.int32)}
    _, met = jax.jit(ref_train_step(_ref_model(arch), opt))(
        state, {k: jnp.asarray(v) for k, v in case.items()})
    got = ranks[0]["train"]["mixtral_b1_1x4"]["metrics"][0]
    np.testing.assert_allclose(got["loss"], float(met["loss"]), **REF_TOL)


def test_batch1_over_two_data_ranks_is_refused(ranks):
    for r in ranks:
        msg = r["train"]["mixtral_b1_2x2"].get("refused", "")
        assert msg.startswith("dim 0 ('batch') of size 1 does not divide "
                              "over mesh axes ('data',) of 2 ranks"), msg
