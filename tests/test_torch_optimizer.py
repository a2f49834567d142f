"""The port's AdamW, schedule, global norm and gradient compression: the
cases of ``tests/test_optimizer.py``, each also held against the
reference's function on the same inputs (numpy in, both packages on the
CPU).  ``cosine_lr`` and ``global_norm`` are property tests (they skip
without ``hypothesis``) and also run on fixed examples."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.train import optimizer as ref_opt
from repro.train.train_step import _compress as ref_compress
from repro_torch.train.optimizer import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    cosine_lr,
    global_norm,
)
from repro_torch.train.train_step import _compress, _compress_all

TOL = dict(rtol=2e-3, atol=2e-4)


def _np(t):
    return t.detach().float().numpy()


def quad(params):
    return torch.sum(torch.square(params["w"] - 3.0)) \
        + torch.sum(torch.square(params["b"] + 1.0))


def ref_quad(params):
    return jnp.sum(jnp.square(params["w"] - 3.0)) \
        + jnp.sum(jnp.square(params["b"] + 1.0))


def run_both(cfg_kw, params_np, loss, ref_loss, steps, compress=None):
    """``steps`` AdamW steps on ``loss`` in both packages from the same
    numpy parameters; returns (port params, reference params)."""
    cfg, rcfg = AdamWConfig(**cfg_kw), ref_opt.AdamWConfig(**cfg_kw)
    params = {k: torch.tensor(v, requires_grad=True)
              for k, v in params_np.items()}
    opt = adamw_init(params, cfg)
    rparams = {k: jnp.asarray(v) for k, v in params_np.items()}
    ropt = ref_opt.adamw_init(rparams, rcfg)
    rgrad = jax.jit(jax.grad(ref_loss))
    for step in range(steps):
        grads = dict(zip(params, torch.autograd.grad(
            loss(params), list(params.values()))))
        rg = rgrad(rparams)
        if compress:
            grads = {k: _compress(g, compress) for k, g in grads.items()}
            rg = jax.tree.map(lambda x: ref_compress(x, compress), rg)
        adamw_update(grads, opt, params, step, cfg)
        rparams, ropt, _ = ref_opt.adamw_update(rg, ropt, rparams,
                                                jnp.asarray(step), rcfg)
    return params, rparams


class TestAdamW:
    def test_converges_on_quadratic(self):
        cfg = dict(peak_lr=0.1, warmup_steps=5, total_steps=300,
                   weight_decay=0.0)
        params, ref = run_both(cfg, {"w": np.zeros((4, 4), np.float32),
                                     "b": np.zeros((4,), np.float32)},
                               quad, ref_quad, 300)
        assert quad(params).item() < 1e-2
        for k in params:
            np.testing.assert_allclose(_np(params[k]), np.asarray(ref[k]),
                                       **TOL)

    def test_clipping_caps_update(self):
        cfg = AdamWConfig(clip_norm=1.0)
        params = {"w": torch.zeros(8)}
        opt = adamw_init(params, cfg)
        g = {"w": torch.full((8,), 1e6)}
        _, _, metrics = adamw_update(g, opt, params, 0, cfg)
        assert float(metrics["grad_norm"]) > 1e5   # norm reported pre-clip
        rp = {"w": jnp.zeros((8,))}
        rcfg = ref_opt.AdamWConfig(clip_norm=1.0)
        rnew, ropt, rmetrics = ref_opt.adamw_update(
            {"w": jnp.full((8,), 1e6)}, ref_opt.adamw_init(rp, rcfg), rp,
            jnp.asarray(0), rcfg)
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   float(rmetrics["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(metrics["lr"]),
                                   float(rmetrics["lr"]), rtol=1e-6)
        np.testing.assert_allclose(_np(params["w"]), np.asarray(rnew["w"]),
                                   **TOL)
        for k in ("m", "v"):
            np.testing.assert_allclose(_np(opt[k]["w"]),
                                       np.asarray(ropt[k]["w"]), **TOL)

    def test_bf16_moments_roundtrip(self):
        cfg = AdamWConfig(moment_dtype="bfloat16", warmup_steps=0,
                          peak_lr=1e-2)
        params = {"w": torch.ones((16, 16), dtype=torch.bfloat16)}
        opt = adamw_init(params, cfg)
        assert opt["m"]["w"].dtype == torch.bfloat16
        g = {"w": torch.full((16, 16), 0.1, dtype=torch.bfloat16)}
        p2, opt2, _ = adamw_update(g, opt, params, 5, cfg)
        assert p2["w"].dtype == torch.bfloat16
        assert opt2["m"]["w"].dtype == opt2["v"]["w"].dtype == \
            torch.bfloat16
        assert bool((p2["w"].float() < 1.0).all())
        rcfg = ref_opt.AdamWConfig(moment_dtype="bfloat16", warmup_steps=0,
                                   peak_lr=1e-2)
        rp = {"w": jnp.ones((16, 16), jnp.bfloat16)}
        rp2, ropt2, _ = ref_opt.adamw_update(
            {"w": jnp.full((16, 16), 0.1, jnp.bfloat16)},
            ref_opt.adamw_init(rp, rcfg), rp, jnp.asarray(5), rcfg)
        np.testing.assert_array_equal(_np(p2["w"]),
                                      np.asarray(rp2["w"], np.float32))
        for k in ("m", "v"):
            np.testing.assert_array_equal(
                _np(opt2[k]["w"]), np.asarray(ropt2[k]["w"], np.float32))

    @given(st.integers(0, 10_000))
    @settings(max_examples=30, deadline=None)
    def test_cosine_schedule_bounds(self, step):
        cfg = AdamWConfig(peak_lr=1e-3, warmup_steps=100, total_steps=10_000)
        lr = float(cosine_lr(step, cfg))
        assert 0.0 <= lr <= cfg.peak_lr * (1 + 1e-5)   # f32 representation
        want = float(ref_opt.cosine_lr(jnp.asarray(step), ref_opt.AdamWConfig(
            peak_lr=1e-3, warmup_steps=100, total_steps=10_000)))
        np.testing.assert_allclose(lr, want, rtol=1e-6)

    @pytest.mark.parametrize("step", [0, 1, 50, 99, 100, 101, 5000, 9999,
                                      10_000, 20_000])
    def test_cosine_schedule_matches_reference(self, step):
        kw = dict(peak_lr=1e-3, warmup_steps=100, total_steps=10_000)
        lr = float(cosine_lr(torch.tensor(step, dtype=torch.int32),
                             AdamWConfig(**kw)))
        assert 0.0 <= lr <= kw["peak_lr"] * (1 + 1e-5)
        want = float(ref_opt.cosine_lr(jnp.asarray(step, jnp.int32),
                                       ref_opt.AdamWConfig(**kw)))
        np.testing.assert_allclose(lr, want, rtol=1e-6)

    def test_weight_decay_only_on_matrices(self):
        cfg = AdamWConfig(weight_decay=0.1, peak_lr=0.1, warmup_steps=0)
        params = {"w": torch.ones((4, 4)), "b": torch.ones((4,))}
        opt = adamw_init(params, cfg)
        zero_g = {"w": torch.zeros((4, 4)), "b": torch.zeros((4,))}
        p2, _, _ = adamw_update(zero_g, opt, params, 1000, cfg)
        assert float(torch.max(torch.abs(p2["b"] - 1.0))) < 1e-6  # no decay
        assert float(torch.max(p2["w"])) < 1.0                    # decayed
        rcfg = ref_opt.AdamWConfig(weight_decay=0.1, peak_lr=0.1,
                                   warmup_steps=0)
        rp = {"w": jnp.ones((4, 4)), "b": jnp.ones((4,))}
        rp2, _, _ = ref_opt.adamw_update(
            {"w": jnp.zeros((4, 4)), "b": jnp.zeros((4,))},
            ref_opt.adamw_init(rp, rcfg), rp, jnp.asarray(1000), rcfg)
        for k in ("w", "b"):
            np.testing.assert_allclose(_np(p2[k]), np.asarray(rp2[k]),
                                       rtol=1e-6)

    def test_ranks_decide_decay(self):
        """A 1-D parameter given rank 2 (a scanned leaf in the reference's
        tree) is decayed; a matrix given rank 1 is not."""
        cfg = AdamWConfig(weight_decay=0.1, peak_lr=0.1, warmup_steps=0)
        params = {"w": torch.ones((4, 4)), "b": torch.ones((4,))}
        opt = adamw_init(params, cfg)
        zero_g = {"w": torch.zeros((4, 4)), "b": torch.zeros((4,))}
        adamw_update(zero_g, opt, params, 1000, cfg, {"w": 1, "b": 2})
        assert bool((params["w"] == 1.0).all())
        assert bool((params["b"] < 1.0).all())


class TestGradCompression:
    @pytest.mark.parametrize("mode", ["bf16", "int8"])
    def test_compression_bounded_error(self, mode):
        rng = np.random.default_rng(0)
        g_np = rng.normal(size=(256,)).astype(np.float32)
        g = torch.from_numpy(g_np)
        gc = _compress(g, mode)
        rel = float(torch.linalg.norm(gc - g) / torch.linalg.norm(g))
        assert rel < (0.01 if mode == "bf16" else 0.05)
        np.testing.assert_array_equal(
            _np(gc), np.asarray(ref_compress(jnp.asarray(g_np), mode)))

    def test_int8_scale_is_taken_per_reference_leaf(self):
        """Slices of one stacked reference leaf share its scale: the
        compressed slices equal the reference's compression of the whole
        stacked leaf."""
        rng = np.random.default_rng(1)
        g = rng.normal(size=(3, 8, 5)).astype(np.float32)
        g[2] *= 10.0                      # one layer sets the leaf's max
        grads = {f"layers.{i}.w": torch.from_numpy(g[i]) for i in range(3)}
        paths = {k: ("stack/pos0/w", i) for i, k in enumerate(grads)}
        got = _compress_all(grads, "int8", paths)
        want = np.asarray(ref_compress(jnp.asarray(g), "int8"))
        for i, k in enumerate(grads):
            np.testing.assert_array_equal(_np(got[k]), want[i])

    def test_training_with_int8_compression_still_learns(self):
        """End-to-end: int8-compressed grads still descend the loss, on the
        reference's trajectory."""
        cfg = dict(peak_lr=0.05, warmup_steps=0, total_steps=200,
                   weight_decay=0.0)

        def loss(p):
            return torch.sum(torch.square(p["w"] - 3.0))

        params, ref = run_both(
            cfg, {"w": np.zeros((4, 4), np.float32)}, loss,
            lambda p: jnp.sum(jnp.square(p["w"] - 3.0)), 200,
            compress="int8")
        assert float(torch.max(torch.abs(params["w"] - 3.0))) < 0.2
        np.testing.assert_allclose(_np(params["w"]), np.asarray(ref["w"]),
                                   **TOL)


class TestGlobalNorm:
    @given(st.lists(st.floats(-10, 10), min_size=1, max_size=20))
    @settings(max_examples=30, deadline=None)
    def test_matches_numpy(self, vals):
        t = {"a": torch.tensor(vals, dtype=torch.float32)}
        got = float(global_norm(t))
        want = float(np.linalg.norm(np.asarray(vals, np.float32)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        ref = float(ref_opt.global_norm({"a": jnp.asarray(vals,
                                                          jnp.float32)}))
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_matches_reference_over_leaves(self, seed):
        """Several leaves of mixed dtypes, as a model's gradients are."""
        rng = np.random.default_rng(seed)
        leaves = {"a": rng.normal(size=(7, 3)).astype(np.float32),
                  "b": rng.normal(size=(5,)).astype(np.float32) * 10,
                  "c": rng.normal(size=(2, 2, 2)).astype(np.float32)}
        t = {k: torch.from_numpy(v) for k, v in leaves.items()}
        t["c"] = t["c"].to(torch.bfloat16)
        r = {k: jnp.asarray(v) for k, v in leaves.items()}
        r["c"] = r["c"].astype(jnp.bfloat16)
        np.testing.assert_allclose(float(global_norm(t)),
                                   float(ref_opt.global_norm(r)), rtol=1e-6)


def test_init_makes_zero_moments_in_the_moment_dtype():
    params = {"w": torch.ones((3, 2), dtype=torch.bfloat16),
              "b": torch.ones(2)}
    for dt in ("float32", "bfloat16"):
        opt = adamw_init(params, AdamWConfig(moment_dtype=dt))
        for k in ("m", "v"):
            for n, p in params.items():
                t = opt[k][n]
                assert t.shape == p.shape and t.dtype == getattr(torch, dt)
                assert not bool(t.any())
