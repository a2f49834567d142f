"""The port's training path against the JAX package, on the same weights.

Both packages run in fp32 on the CPU; the JAX parameters (and moments) are
carried across by ``load_reference_params`` / ``export_reference_params``
and every batch is seeded through numpy.  The reference trains only
through ``use_pallas=False`` (its kernels have no backward), and so does
the port.  Each reference computation is compiled once per module.

Tolerances: train states (parameters, moments, metrics after three steps)
and gradients at rtol 2e-3 / atol 2e-4, ``tests/test_train_step.py``'s
parameter tolerance.  The exception is the 16-layer
``jamba-1.5-large-398b-smoke``: each of its layers agrees with the
reference's to ~1e-7 on the same input, but the random-init stack
amplifies that to 1.7e-5 of the logits (the serving test holds them at the
reference's model-level rtol = atol = 2e-3, ``tests/test_arch_smoke.py``)
and further in the backward, to ~3e-4 of the embedding table's gradient
(entries up to ~4, absolute differences to 1.3e-3).  Its gradients are
held at that model-level tolerance; its train states, each step started
from the reference's previous state, at the train-state tolerance.  The
MoE backward (router, dispatch, experts, the balance loss) is held at the
train-state tolerance on ``mixtral-8x7b-smoke`` (2 layers, 4 experts, no
Mamba), which is not chaotic.  ``whisper-large-v3-smoke`` carries
``audio_embeds`` in its batches (the encoder's gradient crosses every
remat mode through the decoder's cross-attention) and
``internvl2-26b-smoke`` ``image_embeds``; the other decoder-only configs
(granite, llama4-maverick, the two stablelms) are held as the rest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import make_mesh
from repro.configs.base import ArchConfig as JaxArchConfig
from repro.configs.base import get_config as jax_config
from repro.models import RuntimeFlags as JaxFlags
from repro.models import build_model as jax_build
from repro.models.layers import rms_norm as jax_rms_norm
from repro.parallel.sharding import ShardingRules
from repro.train import make_train_step as jax_train_step
from repro.train.optimizer import AdamWConfig as JaxAdamWConfig
from repro.train.optimizer import adamw_init as jax_adamw_init
from repro.train.optimizer import adamw_update as jax_adamw_update
from repro_torch.configs import ArchConfig, get_config
from repro_torch.kernels.flash.flash_attention import flash_attention_heads
from repro_torch.kernels.ssd.ssd import ssd_scan_heads
from repro_torch.models import RuntimeFlags, build_model, \
    export_reference_params, load_reference_params, reference_paths, \
    reference_ranks
from repro_torch.models.blocks import _dots_policy
from repro_torch.models.layers import rms_norm
from repro_torch.serve import BatchedServer, Request
from repro_torch.train import AdamWConfig, adamw_update, init_state, \
    make_train_step, state_from_reference

TOL = dict(rtol=2e-3, atol=2e-4)
MODEL_TOL = dict(rtol=2e-3, atol=2e-3)
TINY = dict(name="tiny", family="dense", num_layers=2, d_model=32,
            num_heads=2, num_kv_heads=2, head_dim=16, d_ff=64,
            vocab_size=128)
ARCHS = ["tiny", "jamba-1.5-large-398b-smoke", "mixtral-8x7b-smoke",
         "mamba2-370m-smoke", "gemma3-4b-smoke", "whisper-large-v3-smoke",
         "internvl2-26b-smoke", "granite-34b-smoke",
         "llama4-maverick-400b-a17b-smoke", "stablelm-1.6b-smoke",
         "stablelm-3b-smoke"]
FRONTENDS = ["whisper-large-v3-smoke", "internvl2-26b-smoke"]
GRAD_TOL = {"jamba-1.5-large-398b-smoke": MODEL_TOL}
B, S = 4, 16


def _configs(arch):
    if arch == "tiny":
        return JaxArchConfig(**TINY), ArchConfig(**TINY)
    return jax_config(arch), get_config(arch)


_REF: dict = {}


def reference(arch, compression="none"):
    """(JAX model, params, numpy tree), built once per (arch,
    compression); the weights do not depend on the compression."""
    key = (arch, compression)
    if key not in _REF:
        f = JaxFlags(param_dtype="float32", compute_dtype="float32",
                     remat="none", grad_compression=compression)
        rules = ShardingRules.create(make_mesh((1,), ("data",)))
        model = jax_build(_configs(arch)[0], f, rules)
        params = model.init(jax.random.key(0))
        _REF[key] = (model, params, jax.tree.map(np.asarray, params))
    return _REF[key]


def port(arch, **flags):
    """The port's model on the reference's weights, trainable."""
    f = RuntimeFlags(param_dtype="float32", compute_dtype="float32",
                     use_pallas=False, **flags)
    model = build_model(_configs(arch)[1], f, device="cpu")
    return load_reference_params(model, reference(arch)[2]).requires_grad_(
        True)


def batch(arch, seed=0):
    """A seeded batch: random tokens and targets, ~20% of the mask off,
    and the stub frontend's embeddings (``audio_embeds`` (B, S_enc, d) or
    ``image_embeds`` (B, F, d)) for an audio or vision config."""
    cfg = _configs(arch)[1]
    V = cfg.vocab_size
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, V, (B, S)).astype(np.int32),
           "targets": rng.integers(0, V, (B, S)).astype(np.int32),
           "mask": (rng.random((B, S)) > 0.2).astype(np.float32)}
    if cfg.frontend == "audio":
        out["audio_embeds"] = rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision":
        out["image_embeds"] = rng.normal(
            size=(B, cfg.num_frontend_tokens, cfg.d_model)).astype(
                np.float32)
    return out


def torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def assert_trees_close(got, want, tol, what):
    want = dict(_leaves(jax.tree.map(np.asarray, want)))
    got = dict(_leaves(got))
    assert set(got) == set(want), what
    for k, a in got.items():
        np.testing.assert_allclose(a.detach().float().numpy(), want[k],
                                   err_msg=f"{what} {k}", **tol)


# ------------------------------------------------------------------ rms_norm

@pytest.mark.parametrize("dtype,tol", [
    ("float32", dict(rtol=1e-5, atol=1e-6)),
    ("bfloat16", dict(rtol=2e-2, atol=2e-3))])
def test_rms_norm_vjp_matches_reference(dtype, tol):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    gamma = (0.3 * rng.normal(size=16)).astype(np.float32)
    g = rng.normal(size=(2, 5, 16)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    out, vjp = jax.vjp(lambda a, b: jax_rms_norm(a, b, 1e-5),
                       jnp.asarray(x, jdt), jnp.asarray(gamma))
    want_dx, want_dg = vjp(jnp.asarray(g, jdt))
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    tg = torch.from_numpy(gamma).requires_grad_(True)
    got = rms_norm(tx, tg, 1e-5)
    got.backward(torch.from_numpy(g).to(tdt))
    assert got.dtype == tdt and tx.grad.dtype == tdt
    assert tg.grad.dtype == torch.float32
    for a, b in ((got, out), (tx.grad, want_dx), (tg.grad, want_dg)):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   np.asarray(b, np.float32), **tol)


# ----------------------------------------------------------- loss and grads

_GRADS: dict = {}


def reference_grads(arch):
    """The reference's (loss, metrics, grads) on ``batch(arch)``, once."""
    if arch not in _GRADS:
        jm, params, _ = reference(arch)
        b = {k: jnp.asarray(v) for k, v in batch(arch).items()}
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            jm.loss, has_aux=True))(params, b)
        _GRADS[arch] = (loss, metrics, grads)
    return _GRADS[arch]


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, remat):
    want_loss, want_metrics, want_grads = reference_grads(arch)
    model = port(arch, remat=remat)
    loss, metrics = model.loss(torch_batch(batch(arch)))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    for k in ("ce", "aux", "tokens"):
        np.testing.assert_allclose(float(metrics[k].detach()),
                                   float(want_metrics[k]), **TOL)
    grads = export_reference_params(
        model, {n: p.grad for n, p in model.named_parameters()})
    assert_trees_close(grads, want_grads, GRAD_TOL.get(arch, TOL),
                       f"{arch} remat={remat} grad")


def test_remat_changes_no_number():
    """'none', 'full' and 'dots' give the same loss and gradients (the
    recompute repeats the same operations on the same inputs)."""
    arch = "jamba-1.5-large-398b-smoke"
    out = []
    for remat in ("none", "full", "dots"):
        model = port(arch, remat=remat)
        loss, _ = model.loss(torch_batch(batch(arch)))
        loss.backward()
        out.append((loss.item(), {n: p.grad.clone()
                                  for n, p in model.named_parameters()}))
    for loss, grads in out[1:]:
        assert loss == out[0][0]
        for n, g in grads.items():
            torch.testing.assert_close(g, out[0][1][n], rtol=1e-6,
                                       atol=1e-7)


def test_dots_policy_tells_projections_from_batched_products():
    """A product without batch dimensions reaches ``bmm`` with a batch of 1
    and is saved; the attention scores and the experts (batch dimensions)
    are recomputed; a 2-D ``@`` reaches ``mm`` and is saved."""
    from torch.utils.checkpoint import CheckpointPolicy
    bmm, mm = torch.ops.aten.bmm.default, torch.ops.aten.mm.default
    proj = (torch.zeros(1, 10, 8), torch.zeros(1, 8, 12))
    scores = (torch.zeros(4, 15, 4), torch.zeros(4, 4, 7))
    assert _dots_policy(None, bmm, *proj) == CheckpointPolicy.MUST_SAVE
    assert _dots_policy(None, bmm, *scores) == \
        CheckpointPolicy.PREFER_RECOMPUTE
    assert _dots_policy(None, mm, torch.zeros(3, 4), torch.zeros(4, 2)) \
        == CheckpointPolicy.MUST_SAVE
    assert _dots_policy(None, torch.ops.aten.exp.default,
                        torch.zeros(3)) == CheckpointPolicy.PREFER_RECOMPUTE


# ---------------------------------------------------------------- train step

OPT = dict(warmup_steps=0, peak_lr=1e-3)
STEPS = 3
_STATES: dict = {}


def reference_states(arch, microbatch, compression):
    """The reference's train state and metrics after each of ``STEPS``
    jitted steps on seeded batches, once per case."""
    key = (arch, microbatch, compression)
    if key not in _STATES:
        jm, params, _ = reference(arch, compression)
        cfg = JaxAdamWConfig(**OPT)
        state = {"params": params, "opt": jax_adamw_init(params, cfg),
                 "step": jnp.zeros((), jnp.int32)}
        step = jax.jit(jax_train_step(jm, cfg, microbatch=microbatch))
        out = []
        for i in range(STEPS):
            state, metrics = step(state, {k: jnp.asarray(v) for k, v in
                                          batch(arch, 10 + i).items()})
            out.append((state, metrics))
        _STATES[key] = out
    return _STATES[key]


TRAIN_CASES = [("tiny", 1, "none"), ("tiny", 2, "none"),
               ("tiny", 1, "bf16"), ("tiny", 2, "bf16"),
               ("tiny", 1, "int8"), ("tiny", 2, "int8"),
               ("jamba-1.5-large-398b-smoke", 2, "none"),
               ("mixtral-8x7b-smoke", 1, "none"),
               ("mamba2-370m-smoke", 1, "none"),
               ("gemma3-4b-smoke", 2, "none"),
               ("whisper-large-v3-smoke", 2, "none"),
               ("internvl2-26b-smoke", 2, "none")]


@pytest.mark.parametrize("arch,microbatch,compression", TRAIN_CASES)
def test_train_steps_match_reference(arch, microbatch, compression):
    """Three steps from the same weights.  jamba-smoke starts each step
    from the reference's previous state: its MoE routing turns the
    packages' rounding differences into a different expert choice within
    a few free-running steps (with microbatch 1 the third step's grad norm
    then differs by 4.5%, while the same step from the same state agrees
    to 2e-6)."""
    want = reference_states(arch, microbatch, compression)
    model = port(arch, grad_compression=compression)
    state = init_state(model, AdamWConfig(**OPT))
    step = make_train_step(model, AdamWConfig(**OPT), microbatch=microbatch)
    for i in range(STEPS):
        if arch == "jamba-1.5-large-398b-smoke" and i:
            state = state_from_reference(
                model, jax.tree.map(np.asarray, want[i - 1][0]))
        state, metrics = step(state, batch(arch, 10 + i))
        want_state, want_metrics = want[i]
        assert int(state["step"]) == int(want_state["step"]) == i + 1
        for k in ("loss", "ce", "aux", "tokens", "grad_norm", "lr"):
            np.testing.assert_allclose(float(metrics[k]),
                                       float(want_metrics[k]), **TOL,
                                       err_msg=f"step {i} {k}")
    what = f"{arch} mb={microbatch} {compression}"
    assert_trees_close(export_reference_params(model, state["params"]),
                       want_state["params"], TOL, f"{what} params")
    for k in ("m", "v"):
        assert_trees_close(export_reference_params(model, state["opt"][k]),
                           want_state["opt"][k], TOL, f"{what} {k}")


def test_decay_follows_the_reference_rank():
    """mamba2-smoke scans both layers, so the reference's leaves of the
    norms' gammas and of ``a_log`` / ``dt_bias`` / ``d_skip`` / ``norm``
    have rank 2 and are decayed; ``ln_f`` has rank 1 and is not.  A zero
    gradient isolates the decay: the port's update equals the reference's,
    and deciding by the port's own (1-D) ranks would leave ``d_skip`` at
    1."""
    arch = "mamba2-370m-smoke"
    _, params, tree = reference(arch)
    cfg = dict(weight_decay=0.1, peak_lr=0.1, warmup_steps=0)
    zeros = jax.tree.map(jnp.zeros_like, params)
    want, _, _ = jax_adamw_update(
        zeros, jax_adamw_init(params, JaxAdamWConfig(**cfg)), params,
        jnp.asarray(1000), JaxAdamWConfig(**cfg))
    model = port(arch)
    ranks = reference_ranks(model)
    assert {n: r for n, r in ranks.items()} == {
        n: np.ndim(a) for n, a in _port_named(model, tree).items()}
    for own_ranks in (False, True):
        model = port(arch)
        state = init_state(model, AdamWConfig(**cfg))
        grads = {n: torch.zeros_like(p) for n, p in state["params"].items()}
        adamw_update(grads, state["opt"], state["params"], 1000,
                     AdamWConfig(**cfg), None if own_ranks else ranks)
        got = export_reference_params(model)
        if not own_ranks:
            assert_trees_close(got, want, dict(rtol=1e-6, atol=0),
                               "zero-grad step")
        else:
            d_skip = got["stack"]["pos0"]["mixer"]["d_skip"]
            assert torch.equal(d_skip, torch.ones_like(d_skip))
    assert float(np.max(np.asarray(
        want["stack"]["pos0"]["mixer"]["d_skip"]))) < 1.0
    np.testing.assert_array_equal(np.asarray(want["ln_f"]), tree["ln_f"])


@pytest.mark.parametrize("arch", FRONTENDS)
def test_decay_follows_the_reference_rank_across_the_encoder(arch):
    """whisper-smoke: the decoder's stacked ``ln_cross`` and the encoder's
    stacked gammas have rank 2 in the reference and are decayed;
    ``enc_ln_f`` has rank 1 and is not.  internvl2-smoke: the plain
    decoder stack under a vision frontend.  The gammas start at 0.5 (the
    init's zeros would hide any decay); a zero gradient isolates it."""
    _, params, tree = reference(arch)

    def half_gammas(t):
        return {k: half_gammas(v) if isinstance(v, dict) else
                (np.full_like(np.asarray(v), 0.5)
                 if k.startswith(("ln", "enc_ln")) else v)
                for k, v in t.items()}

    params = jax.tree.map(jnp.asarray, half_gammas(tree))
    cfg = dict(weight_decay=0.1, peak_lr=0.1, warmup_steps=0)
    zeros = jax.tree.map(jnp.zeros_like, params)
    want, _, _ = jax_adamw_update(
        zeros, jax_adamw_init(params, JaxAdamWConfig(**cfg)), params,
        jnp.asarray(1000), JaxAdamWConfig(**cfg))
    model = load_reference_params(port(arch), jax.tree.map(np.asarray,
                                                           params))
    ranks = reference_ranks(model)
    assert ranks == {n: np.ndim(a) for n, a in _port_named(
        model, jax.tree.map(np.asarray, params)).items()}
    state = init_state(model, AdamWConfig(**cfg))
    grads = {n: torch.zeros_like(p) for n, p in state["params"].items()}
    adamw_update(grads, state["opt"], state["params"], 1000,
                 AdamWConfig(**cfg), ranks)
    got = export_reference_params(model)
    assert_trees_close(got, want, dict(rtol=1e-6, atol=0), "zero-grad step")
    assert float(np.max(np.asarray(want["stack"]["pos0"]["ln1"]))) < 0.5
    if get_config(arch).encoder_layers:
        assert ranks["layers.0.ln_cross"] == 2 and ranks["enc_ln_f"] == 1
        assert float(np.max(np.asarray(
            want["stack"]["pos0"]["ln_cross"]))) < 0.5
        assert float(np.max(np.asarray(
            want["enc_stack"]["pos0"]["ln2"]))) < 0.5
        np.testing.assert_array_equal(np.asarray(want["enc_ln_f"]), 0.5)
        assert torch.all(got["enc_ln_f"] == 0.5)


def _port_named(model, tree):
    """Each port parameter's reference leaf (the whole stacked array)."""
    flat = dict(_leaves(tree))
    return {n: flat[path] for n, (path, _) in
            reference_paths(model).items()}


# ------------------------------------------------------ kernels and serving

def test_kernel_wrappers_refuse_autograd():
    """Neither LM kernel has a backward: with autograd on and an operand
    that requires grad the wrappers raise (on the CPU too, where they
    would run the differentiable plain version); without either they
    run."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 8, 2, 64)).astype(
        np.float32)) for _ in range(3))
    x = torch.from_numpy(rng.normal(size=(1, 8, 2, 4)).astype(np.float32))
    la = -torch.rand(1, 8, 2)
    bc = torch.from_numpy(rng.normal(size=(1, 8, 2, 3)).astype(np.float32))
    calls = {"flash": lambda a: flash_attention_heads(a, k, v),
             "ssd": lambda a: ssd_scan_heads(a, la, bc, bc)}
    args = {"flash": q, "ssd": x}
    for name, call in calls.items():
        call(args[name])                                  # nothing trainable
        leaf = args[name].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match=r"use_pallas=False"):
            call(leaf)
        with torch.no_grad():
            call(leaf)


@pytest.mark.parametrize("arch", ["gemma3-4b-smoke", "mamba2-370m-smoke",
                                  "whisper-large-v3-smoke",
                                  "internvl2-26b-smoke"])
def test_loss_on_the_kernel_route_raises(arch):
    model = build_model(get_config(arch), RuntimeFlags(
        param_dtype="float32", compute_dtype="float32", use_pallas=True),
        device="cpu").requires_grad_(True)
    with pytest.raises(RuntimeError, match=r"ROADMAP"):
        model.loss(torch_batch(batch(arch)))


def test_serving_builds_no_graph():
    """With trainable weights, ``decode_step`` and ``BatchedServer`` still
    build no autograd graph."""
    model = build_model(ArchConfig(**TINY), RuntimeFlags(
        param_dtype="float32", compute_dtype="float32"),
        device="cpu").requires_grad_(True)
    assert all(p.requires_grad for p in model.parameters())
    seen = []
    decode = model.decode_step

    def spy(cache, b):
        logits, cache = decode(cache, b)
        seen.append(logits)
        assert all(not t.requires_grad for c in cache
                   for t in c["mixer"].values()
                   if isinstance(t, torch.Tensor))
        return logits, cache

    model.decode_step = spy
    server = BatchedServer(model, batch_slots=2, max_len=16, device="cpu")
    for i in range(3):
        server.submit(Request(rid=i, prompt=np.arange(1, 4 + i,
                                                      dtype=np.int32),
                              max_new_tokens=3))
    server.run()
    assert seen and all(t.grad_fn is None and not t.requires_grad
                        for t in seen)
