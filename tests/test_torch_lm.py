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
  ``use_pallas=True`` (the Pallas SSD kernel in interpret mode).

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
    load_reference_params

TOL = dict(rtol=2e-3, atol=2e-3)
ARCHS = ["jamba-1.5-large-398b-smoke", "gemma3-4b-smoke",
         "mamba2-370m-smoke"]
B, S = 2, 16

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


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_pallas", [True, False])
def test_prefill_matches_reference(arch, use_pallas):
    jm, params, _ = reference(arch)
    tok = tokens(arch)
    want, _, want_aux = jm.forward(params, {"tokens": jnp.asarray(tok)})
    model = port(arch, use_pallas=use_pallas)
    before = _build.launch_counts()
    got, cache, aux = model({"tokens": torch.from_numpy(tok).long()})
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
    jm, params, _ = reference(arch)
    jm = dataclasses.replace(jm, flags=dataclasses.replace(
        jm.flags, kv_quant=kv_quant))
    model = port(arch, kv_quant=kv_quant)
    tok = tokens(arch, 3)
    max_len = 24                 # > gemma-smoke's window of 8: ring wraps
    jc = jm.init_cache(B, max_len)
    cache = model.init_cache(B, max_len)
    if kv_quant == "int8":
        attn = [c["mixer"] for c in cache if "k" in c["mixer"]]
        assert attn and all(c["k"].dtype == torch.int8 for c in attn)
    step = jax.jit(jm.decode_step)
    for t in range(S):
        want, jc = step(params, jc, {"tokens": jnp.asarray(tok[:, t:t + 1]),
                                     "pos": jnp.asarray(t, jnp.int32)})
        got, cache = model.decode_step(
            cache, {"tokens": torch.from_numpy(tok[:, t:t + 1]).long(),
                    "pos": t})
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


@pytest.mark.parametrize("arch", ["whisper-large-v3-smoke",
                                  "internvl2-26b-smoke"])
def test_encoder_and_frontend_configs_are_not_ported_yet(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(get_config(arch), device="cpu")


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
