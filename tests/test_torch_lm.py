"""The port's LM serving path against the JAX package, on the same weights.

Each reduced (``-smoke``) config is built in both packages in fp32; the JAX
parameters are carried across with ``load_reference_params``.  Prefill
logits and step-by-step ``decode_step`` logits are held against the
reference's ``use_pallas=False`` path (its kernel route through attention
raises ``NameError`` at ``models/layers.py:279``), at rtol = atol = 2e-3,
the reference's own model-level tolerance (``tests/test_arch_smoke.py``):

* ``jamba-1.5-large-398b-smoke``: 16 layers in 2 scanned blocks of 8
  (attention, Mamba, MoE), so it covers unstacking and MoE dispatch;
* ``gemma3-4b-smoke``: sliding windows and the ring-buffer cache;
* ``mamba2-370m-smoke``: also against the reference with
  ``use_pallas=True`` (the Pallas SSD kernel in interpret mode);
* ``whisper-large-v3-smoke``: the encoder (non-causal attention), the
  decoder's cross-attention, and decode on a precomputed ``enc_out``;
* ``internvl2-26b-smoke``: image embeds prepended to the prompt (their
  rows cut from the logits), and decode after an image prefill into the
  cache;
* the other decoder-only configs: ``granite-34b-smoke`` (MQA, the gelu
  MLP), ``llama4-maverick-400b-a17b-smoke`` (top-1 MoE every other layer),
  ``mixtral-8x7b-smoke`` (MoE decode), ``stablelm-1.6b-smoke`` and
  ``stablelm-3b-smoke``.

The port takes its kernel route (``use_pallas=True``; the kernels' plain
versions on the CPU) and the non-kernel route (``False``), and the int8
KV cache.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import make_mesh
from repro.configs.base import get_config as jax_config
from repro.models import RuntimeFlags as JaxFlags
from repro.models import build_model as jax_build
from repro.parallel.sharding import ShardingRules
from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.models import RuntimeFlags, build_model, \
    export_reference_params, load_reference_params

TOL = dict(rtol=2e-3, atol=2e-3)
ARCHS = ["jamba-1.5-large-398b-smoke", "gemma3-4b-smoke",
         "mamba2-370m-smoke", "whisper-large-v3-smoke",
         "internvl2-26b-smoke", "granite-34b-smoke",
         "llama4-maverick-400b-a17b-smoke", "mixtral-8x7b-smoke",
         "stablelm-1.6b-smoke", "stablelm-3b-smoke"]
FRONTENDS = ["whisper-large-v3-smoke", "internvl2-26b-smoke"]
B, S = 2, 16
PROMPT = 4           # internvl2's image prefill: the image and 4 tokens

_REF: dict = {}


def reference(arch):
    """(JAX model, params, numpy tree), built once per arch."""
    if arch not in _REF:
        flags = JaxFlags(param_dtype="float32", compute_dtype="float32",
                         remat="none")
        rules = ShardingRules.create(make_mesh((1,), ("data",)))
        model = jax_build(jax_config(arch), flags, rules)
        params = model.init(jax.random.key(0))
        _REF[arch] = (model, params, jax.tree.map(np.asarray, params))
    return _REF[arch]


def port(arch, **flags):
    f = RuntimeFlags(param_dtype="float32", compute_dtype="float32",
                     **flags)
    model = build_model(get_config(arch), f, device="cpu")
    return load_reference_params(model, reference(arch)[2])


def tokens(arch, seed=0):
    cfg = get_config(arch)
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def frontend(arch, seed=0) -> dict:
    """The stub frontends' precomputed embeddings (numpy, seeded):
    ``audio_embeds`` (B, S_enc, d) or ``image_embeds`` (B, F, d); none for
    a decoder-only config."""
    cfg = get_config(arch)
    rng = np.random.default_rng(100 + seed)
    if cfg.frontend == "audio":
        return {"audio_embeds": rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)}
    if cfg.frontend == "vision":
        return {"image_embeds": rng.normal(
            size=(B, cfg.num_frontend_tokens, cfg.d_model)).astype(
                np.float32)}
    return {}


def both(batch: dict):
    """A numpy batch as the reference's (jnp) and the port's (torch)."""
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_pallas", [True, False])
def test_prefill_matches_reference(arch, use_pallas):
    jm, params, _ = reference(arch)
    jb, tb = both({"tokens": tokens(arch), **frontend(arch)})
    want, _, want_aux = jm.forward(params, jb)
    model = port(arch, use_pallas=use_pallas)
    before = _build.launch_counts()
    got, cache, aux = model(tb)
    assert _build.launch_counts() == before      # CPU: plain versions only
    assert cache is None
    assert got.shape == (B, S, get_config(arch).padded_vocab())
    _close(got, want)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


def test_chunked_scan_matches_reference():
    arch = "jamba-1.5-large-398b-smoke"
    jm, params, _ = reference(arch)
    tok = tokens(arch, 1)
    want, _, _ = jm.forward(params, {"tokens": jnp.asarray(tok)})
    got, _, _ = port(arch, use_pallas=False, ssd_impl="chunked")(
        {"tokens": torch.from_numpy(tok).long()})
    _close(got, want)


def test_mamba_kernel_route_matches_reference_kernel_route():
    """On an SSM-only config the reference's ``use_pallas=True`` route
    works (Pallas SSD in interpret mode): it and the port's kernel route
    agree."""
    arch = "mamba2-370m-smoke"
    jm, params, _ = reference(arch)
    jk = dataclasses.replace(jm, flags=dataclasses.replace(
        jm.flags, use_pallas=True))
    tok = tokens(arch, 2)
    want, _, _ = jk.forward(params, {"tokens": jnp.asarray(tok)})
    got, _, _ = port(arch)({"tokens": torch.from_numpy(tok).long()})
    _close(got, want)


@pytest.mark.parametrize("arch,kv_quant", [(a, "none") for a in ARCHS] + [
    (a, "int8") for a in ARCHS if not a.startswith("mamba2")])
def test_decode_steps_match_reference(arch, kv_quant):
    """Step-by-step decode.  whisper-smoke decodes on each package's own
    ``_encode`` output (held against each other first); internvl2-smoke
    first prefills the image and ``PROMPT`` tokens into the cache in one
    call (``'pos'`` an array, as the reference allows), then decodes."""
    jm, params, _ = reference(arch)
    jm = dataclasses.replace(jm, flags=dataclasses.replace(
        jm.flags, kv_quant=kv_quant))
    model = port(arch, kv_quant=kv_quant)
    tok = tokens(arch, 3)
    max_len = 24 + get_config(arch).num_frontend_tokens   # > gemma-smoke's
    jc = jm.init_cache(B, max_len)                        # window: ring wraps
    cache = model.init_cache(B, max_len)
    if kv_quant == "int8":
        attn = [c["mixer"] for c in cache if "k" in c["mixer"]]
        assert attn and all(c["k"].dtype == torch.int8 for c in attn)
    extra, steps = {}, [(t, t + 1, t) for t in range(S)]
    fe = frontend(arch, 3)
    if "audio_embeds" in fe:
        jenc = jm._encode(params, jnp.asarray(fe["audio_embeds"]))
        tenc = model._encode(torch.from_numpy(fe["audio_embeds"]))
        _close(tenc, jenc)
        extra = ({"enc_out": jenc}, {"enc_out": tenc})
    if "image_embeds" in fe:
        F = fe["image_embeds"].shape[1]
        steps = [(0, PROMPT, np.arange(F + PROMPT))] + [
            (t, t + 1, F + t) for t in range(PROMPT, S)]
    step = jax.jit(jm.decode_step)
    for i, (lo, hi, pos) in enumerate(steps):
        b = {"tokens": tok[:, lo:hi], "pos": np.asarray(pos, np.int32)}
        if i == 0 and "image_embeds" in fe:
            b["image_embeds"] = fe["image_embeds"]
        jb, tb = both(b)
        if not np.ndim(pos):
            tb["pos"] = int(pos)
        if extra:
            jb.update(extra[0])
            tb.update(extra[1])
        want, jc = step(params, jc, jb)
        got, cache = model.decode_step(cache, tb)
        assert got.shape == (B, hi - lo, get_config(arch).padded_vocab())
        _close(got, want)


def test_ring_buffer_is_the_window():
    cfg = get_config("gemma3-4b-smoke")
    cache = port("gemma3-4b-smoke").init_cache(B, 64)
    lens = [c["mixer"]["k"].shape[1] for c in cache]
    kinds = cfg.layer_kinds()
    assert lens == [cfg.window if k["window"] else 64 for k in kinds]


def test_decode_matches_teacher_forcing():
    """Greedy decode logits == prefill logits position by position (a
    config without MoE: capacity drops differ between S=1 and S>1)."""
    model = port("gemma3-4b-smoke")
    tok = torch.from_numpy(tokens("gemma3-4b-smoke", 4)).long()
    want, _, _ = model({"tokens": tok})
    cache = model.init_cache(B, S)
    outs = []
    for t in range(S):
        lg, cache = model.decode_step(cache, {"tokens": tok[:, t:t + 1],
                                              "pos": t})
        outs.append(lg[:, 0])
    torch.testing.assert_close(torch.stack(outs, dim=1), want, **TOL)


@pytest.mark.parametrize("arch", FRONTENDS)
def test_decode_matches_teacher_forcing_with_frontends(arch):
    """The prefill (kernel route) with the frontend's embeds against
    decode: whisper-smoke step by step on the ``_encode`` output,
    internvl2-smoke after an image + ``PROMPT``-token prefill into the
    cache."""
    model = port(arch)
    tok = torch.from_numpy(tokens(arch, 4)).long()
    fe = {k: torch.from_numpy(v) for k, v in frontend(arch, 4).items()}
    want, _, _ = model({"tokens": tok, **fe})
    cache = model.init_cache(B, S + get_config(arch).num_frontend_tokens)
    outs, start = [], 0
    if "audio_embeds" in fe:
        fe = {"enc_out": model._encode(fe["audio_embeds"])}
    else:
        F = fe["image_embeds"].shape[1]
        lg, cache = model.decode_step(cache, {
            "tokens": tok[:, :PROMPT], "pos": torch.arange(F + PROMPT),
            **fe})
        outs, start, fe = list(lg.unbind(1)), PROMPT, {}
    F = get_config(arch).num_frontend_tokens       # text token t is at F + t
    for t in range(start, S):
        lg, cache = model.decode_step(cache, {"tokens": tok[:, t:t + 1],
                                              "pos": F + t, **fe})
        outs.append(lg[:, 0])
    torch.testing.assert_close(torch.stack(outs, dim=1), want, **TOL)


def test_load_reference_params_checks_every_leaf():
    arch = "mamba2-370m-smoke"
    tree = reference(arch)[2]
    model = build_model(get_config(arch), device="cpu")
    bad = jax.tree.map(lambda a: a, tree)
    bad["ln_f"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="ln_f"):
        load_reference_params(model, bad)
    short = jax.tree.map(lambda a: a, tree)
    del short["stack"]["pos0"]["mixer"]["w_x"]
    with pytest.raises(ValueError, match="w_x"):
        load_reference_params(model, short)


def test_bf16_reference_weights_carry_across():
    """JAX's bfloat16 leaves (ml_dtypes arrays) load bit for bit."""
    arch = "mamba2-370m-smoke"
    tree = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                        reference(arch)[2])
    model = build_model(get_config(arch), RuntimeFlags(), device="cpu")
    load_reference_params(model, tree)
    want = tree["stack"]["pos0"]["mixer"]["w_x"][1]
    got = model.layers[1].mixer["w_x"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))


@pytest.mark.parametrize("arch", FRONTENDS)
def test_load_reference_params_checks_the_new_leaves(arch):
    """The encoder's stacked leaves, ``enc_ln_f`` and the decoder's
    ``cross`` / ``ln_cross`` load from their reference paths, and export
    back to the same tree; a missing or misshapen one raises."""
    tree = reference(arch)[2]
    model = port(arch)
    exported = export_reference_params(model)
    flat = dict(_leaves(tree))
    got = dict(_leaves(exported))
    assert set(got) == set(flat)
    for k, a in flat.items():
        np.testing.assert_array_equal(got[k].numpy(), a, err_msg=k)
    if get_config(arch).encoder_layers:
        assert {"enc_stack", "enc_ln_f"} <= set(tree)
        assert "cross" in tree["stack"]["pos0"]
        bad = jax.tree.map(lambda a: a, tree)
        del bad["enc_ln_f"]
        with pytest.raises(ValueError, match="enc_ln_f"):
            load_reference_params(model, bad)
        bad = jax.tree.map(lambda a: a, tree)
        bad["stack"]["pos0"]["ln_cross"] = np.zeros((1, 3), np.float32)
        with pytest.raises(ValueError, match="ln_cross"):
            load_reference_params(model, bad)
        bad = jax.tree.map(lambda a: a, tree)
        del bad["enc_stack"]["pos0"]["mixer"]["wk"]
        with pytest.raises(ValueError, match=r"enc_layers\.0\.mixer\.wk"):
            load_reference_params(model, bad)
    else:
        assert set(tree) == {"embed", "stack", "ln_f"}
        bad = jax.tree.map(lambda a: a, tree)
        bad["enc_ln_f"] = np.zeros(get_config(arch).d_model, np.float32)
        with pytest.raises(ValueError, match="enc_ln_f"):
            load_reference_params(model, bad)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_configs_are_the_reference_configs():
    """The copied registry gives the reference's configs field for field,
    and the same parameter counts."""
    from repro.configs.base import list_archs as jax_archs
    from repro_torch.configs import list_archs
    assert list_archs() == jax_archs()
    for arch in list_archs():
        for name in (arch, arch + "-smoke"):
            ours, ref = get_config(name), jax_config(name)
            assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
            assert ours.param_count() == ref.param_count()
            assert ours.layer_kinds() == ref.layer_kinds()


def test_mamba_hands_the_scan_broadcast_views():
    """The prefill passes one B and one C to every head as stride-0 views
    with unit-stride rows, which the kernel reads as they are (no per-head
    copy), and x with unit-stride rows."""
    from repro_torch.kernels.ssd import ops as ssd_ops
    seen = []
    orig = ssd_ops.ssd_scan_heads

    def spy(x, la, b, c, **kw):
        seen.append((x, b, c))
        return orig(x, la, b, c, **kw)

    ssd_ops.ssd_scan_heads = spy
    try:
        tok = np.random.default_rng(5).integers(0, 256, (2, 40))
        port("mamba2-370m-smoke")({"tokens": torch.from_numpy(tok)})
    finally:
        ssd_ops.ssd_scan_heads = orig
    assert len(seen) == get_config("mamba2-370m-smoke").num_layers
    for x, b, c in seen:
        assert x.stride(-1) == 1
        for t in (b, c):
            assert t.stride(2) == 0 and t.stride(-1) == 1
