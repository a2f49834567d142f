"""The LM stack on a 2 x 2 ('data', 'model') DeviceMesh of 4 gloo ranks,
fp32 on the CPU, against the port on one rank and the JAX package.

The ranks (spawned once for this file; ``tests/_torch_ranks.py::
lm_mesh_paths``) and this process build the same weights with
``build_model(..., seed=0)``; the reference gets them through
``export_reference_params``.
* Prefill logits (the kernel route: flash and SSD on each rank's local
  heads, their plain versions on the CPU) and 4 decode steps of
  ``jamba-1.5-large-398b-smoke`` (attention, Mamba, MoE),
  ``mixtral-8x7b-smoke`` (experts over 'model'), ``gemma3-4b-smoke``
  (windows, ring cache), ``granite-34b-smoke`` (one KV head, replicated
  while the query heads split) and ``whisper-large-v3-smoke`` (encoder and
  cross-attention): against the one-rank port at rtol = atol = 1e-4 (the
  same fp32 math, summed in another order across shards; observed
  <= 1e-5) and, prefill, against the reference at rtol = atol = 2e-3 (the
  reference's model-level tolerance, as ``tests/test_torch_lm.py``).
* Two train steps of ``mixtral-8x7b-smoke`` under FSDP off / on x ZeRO-1
  off / on: every metric against the one-rank port's at rtol 1e-5, and
  the first step's loss and grad norm against the reference's; gathered
  parameters and moments at rtol = atol = 1e-5; every state leaf placed
  as ``make_state_shardings`` says and each ZeRO-1 moment's local size
  the shard's.
* The ZeRO-1 state saved sharded, restored onto a (4, 1) mesh by
  ``restore(shardings=)``: bit-equal to what was saved; the reference's
  ``CheckpointManager`` reads the same directory.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import make_mesh as ref_make_mesh
from repro.configs.base import get_config as ref_config
from repro.models import RuntimeFlags as RefFlags
from repro.models import build_model as ref_build
from repro.parallel.sharding import ShardingRules as RefRules
from repro.train import AdamWConfig as RefAdam
from repro.train import make_train_step as ref_train_step
from repro.train.checkpoint import CheckpointManager as RefCkpt
from repro.train.optimizer import adamw_init as ref_adamw_init
from repro_torch.compat import run_local_group
from repro_torch.configs import get_config
from repro_torch.models import RuntimeFlags, build_model, \
    export_reference_params
from repro_torch.train import AdamWConfig, init_state, make_train_step

import _torch_ranks

SERVE = ["jamba-1.5-large-398b-smoke", "mixtral-8x7b-smoke",
         "gemma3-4b-smoke", "granite-34b-smoke", "whisper-large-v3-smoke"]
TRAIN = "mixtral-8x7b-smoke"
B, S, N_DEC = 2, 8, 4
MESH_TOL = dict(rtol=1e-4, atol=1e-4)
REF_TOL = dict(rtol=2e-3, atol=2e-3)
STATE_TOL = dict(rtol=1e-5, atol=1e-5)


def _batch(arch, seed=0, train=False):
    cfg = get_config(arch)
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64)
    out = {"tokens": tok}
    if cfg.frontend == "audio":
        out["audio_embeds"] = rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if train:
        out["targets"] = np.roll(tok, -1, axis=1)
        out["mask"] = np.ones((B, S), np.float32)
    return out


def _port(arch, **kw):
    flags = RuntimeFlags(param_dtype="float32", compute_dtype="float32",
                         **kw)
    return build_model(get_config(arch), flags, device="cpu", seed=0)


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("ckpt")
    serve = {a: (_batch(a), N_DEC) for a in SERVE}
    res = run_local_group(_torch_ranks.lm_mesh_paths, 4, serve,
                          (TRAIN, _batch(TRAIN, train=True)), str(ckpt),
                          timeout_s=300.0)
    return res, ckpt


def _ref_model(arch):
    flags = RefFlags(param_dtype="float32", compute_dtype="float32",
                     remat="none")
    return ref_build(ref_config(arch), flags,
                     RefRules.create(ref_make_mesh((1,), ("data",))))


def _ref_params(model):
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                        export_reference_params(model))


@pytest.mark.parametrize("arch", SERVE)
def test_prefill_on_the_mesh(ranks, arch):
    res, _ = ranks
    model = _port(arch)
    batch = _batch(arch)
    with torch.no_grad():
        want = model(_t(batch))[0].numpy()
    for r in res:
        np.testing.assert_allclose(r["prefill"][arch], want, **MESH_TOL)
    ref = _ref_model(arch)
    got, _, _ = ref.forward(_ref_params(model),
                            {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(res[0]["prefill"][arch], np.asarray(got),
                               **REF_TOL)


@pytest.mark.parametrize("arch", SERVE)
def test_decode_on_the_mesh(ranks, arch):
    res, _ = ranks
    model = _port(arch)
    batch = _t(_batch(arch))
    cache = model.init_cache(B, N_DEC)
    extra = {"enc_out": model._encode(batch["audio_embeds"])} \
        if "audio_embeds" in batch else {}
    for t in range(N_DEC):
        want, cache = model.decode_step(cache, {
            "tokens": batch["tokens"][:, t:t + 1], "pos": t, **extra})
        for r in res:
            np.testing.assert_allclose(r["decode"][arch][t], want.numpy(),
                                       **MESH_TOL)


@pytest.fixture(scope="module")
def one_rank_train():
    model = _port(TRAIN, use_pallas=False)
    opt = AdamWConfig(warmup_steps=1)
    state = init_state(model, opt)
    step = make_train_step(model, opt)
    mets = []
    for _ in range(2):
        state, met = step(state, _batch(TRAIN, train=True))
        mets.append({k: float(v) for k, v in met.items()})
    return model, state, mets


def test_one_rank_train_step_against_the_reference(one_rank_train):
    """The first step's loss and grad norm of the reference's train step
    on the same weights, which the mesh steps are held to through the
    one-rank port."""
    model = _port(TRAIN, use_pallas=False)
    ref = _ref_model(TRAIN)
    params = _ref_params(model)
    opt = RefAdam(warmup_steps=1)
    state = {"params": params, "opt": ref_adamw_init(params, opt),
             "step": jnp.zeros((), jnp.int32)}
    _, met = jax.jit(ref_train_step(ref, opt))(
        state, {k: jnp.asarray(v) for k, v in
                _batch(TRAIN, train=True).items()})
    mets = one_rank_train[2]
    np.testing.assert_allclose(mets[0]["loss"], float(met["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(mets[0]["grad_norm"],
                               float(met["grad_norm"]), rtol=1e-4)


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("zero1", [False, True])
def test_train_steps_on_the_mesh(ranks, one_rank_train, fsdp, zero1):
    res, _ = ranks
    _, state, mets = one_rank_train
    for r in res:
        rec = r["train"][(fsdp, zero1)]
        for got, want in zip(rec["metrics"], mets):
            for k in ("loss", "ce", "aux", "grad_norm", "lr"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                           err_msg=k)
        for k, p in state["params"].items():
            np.testing.assert_allclose(rec["params"][k],
                                       p.detach().numpy(), **STATE_TOL,
                                       err_msg=k)
        for g in ("m", "v"):
            for k, t in state["opt"][g].items():
                np.testing.assert_allclose(rec["opt"][g][k], t.numpy(),
                                           **STATE_TOL, err_msg=k)
        assert rec["placements_ok"]
    # ZeRO-1 splits each moment over the 2 data ranks where a dim divides
    rec = res[0]["train"][(False, True)]
    full = {k: t.numel() for k, t in state["opt"]["m"].items()}
    split = [k for k in full if rec["local_bytes"][k] < full[k]]
    assert split and all(rec["local_bytes"][k] * 2 <= full[k]
                         for k in split)


def test_checkpoint_restored_onto_another_mesh(ranks):
    res, ckpt = ranks
    saved = res[0]["train"][(False, True)]
    for r in res:
        got = r["restored"]
        assert got["step"] == 2 and got["placements_ok"]
        for k, a in saved["params"].items():
            np.testing.assert_array_equal(got["params"][k], a)
        for g in ("m", "v"):
            for k, a in saved["opt"][g].items():
                np.testing.assert_array_equal(got["opt"][g][k], a)
    tree, manifest = RefCkpt(str(ckpt)).restore(2)
    assert manifest["step"] == 2 and int(tree["step"]) == 2
    model = _port(TRAIN, use_pallas=False)
    mine = export_reference_params(model, {k: torch.from_numpy(v) for k, v
                                           in saved["params"].items()})
    leaves = jax.tree_util.tree_leaves_with_path(mine)
    assert leaves
    for path, t in leaves:
        want = tree["params"]
        for p in path:
            want = want[p.key]
        np.testing.assert_array_equal(np.asarray(want), t.numpy())
