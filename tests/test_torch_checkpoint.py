"""The port's checkpoints, elasticity policy and packed data: the cases of
``tests/test_fault_tolerance.py`` (an elastic restore becomes a restore
onto another device), checkpoints crossing between the packages both ways
(bf16 included, bit for bit), ``PackedLMDataset`` batch for batch against
the reference's, and the training driver's crash-safe resume."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JaxArchConfig
from repro.configs.base import get_config as jax_config
from repro.compat import make_mesh
from repro.data import PackedLMDataset as RefDataset
from repro.data import packing_efficiency as ref_packing_efficiency
from repro.models import RuntimeFlags as JaxFlags
from repro.models import build_model as jax_build
from repro.parallel.sharding import ShardingRules
from repro.train import CheckpointManager as RefCheckpointManager
from repro.train import elastic as ref_elastic
from repro.train.optimizer import AdamWConfig as RefAdamWConfig
from repro.train.optimizer import adamw_init as ref_adamw_init
from repro_torch.configs import ArchConfig, get_config
from repro_torch.data import PackedLMDataset, packing_efficiency
from repro_torch.launch.train_lm import Trainer
from repro_torch.models import RuntimeFlags, build_model, \
    export_reference_params
from repro_torch.train import AdamWConfig, CheckpointManager, init_state, \
    make_train_step, state_from_reference, state_to_reference
from repro_torch.train.elastic import (
    ElasticPolicy,
    StragglerMonitor,
    rescale_mesh_shape,
    scale_batch,
)
from repro_torch.train.optimizer import adamw_init, adamw_update


def tiny_state(seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn((8, 8), generator=g),
              "b": torch.zeros((8,), dtype=torch.bfloat16)}
    cfg = AdamWConfig()
    return {"params": params, "opt": adamw_init(params, cfg),
            "step": torch.zeros((), dtype=torch.int32)}, cfg


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _bits(a) -> np.ndarray:
    """A leaf's raw bits (bf16 as uint16), for bit-for-bit comparisons."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def assert_bit_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for k in got:
        g, w = _bits(got[k]), _bits(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


class TestCheckpoint:
    def test_save_restore_roundtrip(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2)
        state, _ = tiny_state()
        mgr.save(5, state, extra={"data": {"seed": 0, "cursor": 3}})
        restored, manifest = mgr.restore(template=state, device="cpu")
        assert manifest["step"] == 5
        np.testing.assert_array_equal(restored["params"]["w"].numpy(),
                                      state["params"]["w"].numpy())
        assert restored["params"]["b"].dtype == torch.bfloat16
        assert manifest["extra"]["data"]["cursor"] == 3
        assert_bit_equal(restored, state)

    def test_keep_n_gc(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2)
        state, _ = tiny_state()
        for s in (1, 2, 3, 4):
            mgr.save(s, state)
        steps = sorted(n for n in os.listdir(tmp_path)
                       if n.startswith("step_"))
        assert steps == ["step_00000003", "step_00000004"]

    def test_crash_mid_save_keeps_previous(self, tmp_path):
        """A leftover tmp dir (simulated crash) never corrupts latest."""
        mgr = CheckpointManager(str(tmp_path), keep=3)
        state, _ = tiny_state()
        mgr.save(1, state)
        os.makedirs(os.path.join(str(tmp_path), ".tmp_crashed"))
        assert mgr.latest_step() == 1
        restored, m = mgr.restore(device="cpu")
        assert m["step"] == 1

    def test_failed_save_leaves_no_tmp_dir(self, tmp_path, monkeypatch):
        """A save that raises midway removes its tmp dir and publishes
        nothing."""
        mgr = CheckpointManager(str(tmp_path), keep=3)
        state, _ = tiny_state()
        mgr.save(1, state)

        def boom(*a, **k):
            raise OSError("disk full")

        monkeypatch.setattr(np, "savez", boom)
        with pytest.raises(OSError):
            mgr.save(2, state)
        assert sorted(os.listdir(tmp_path)) == ["step_00000001"]
        assert mgr.latest_step() == 1

    def test_restore_onto_another_device(self, tmp_path):
        """Elastic restore: the same arrays, placed on the device the
        caller names (here the meta device: shapes and dtypes only)."""
        mgr = CheckpointManager(str(tmp_path), keep=1)
        state, _ = tiny_state()
        mgr.save(7, state)
        restored, _ = mgr.restore(template=state, device="meta")
        for k, t in _flat(restored).items():
            assert t.device.type == "meta"
            want = _flat(state)[k]
            assert t.shape == want.shape and t.dtype == want.dtype

    def test_restore_without_checkpoint(self, tmp_path):
        assert CheckpointManager(str(tmp_path)).restore(device="cpu") == \
            (None, None)

    def test_training_resumes_identically(self, tmp_path):
        """Optimizer state + checkpoint resume => the bitwise-same
        trajectory."""
        state, cfg = tiny_state()
        g = {"w": torch.ones((8, 8)) * 0.1,
             "b": torch.ones((8,), dtype=torch.bfloat16) * 0.1}

        def clone(s):
            return {"params": {k: v.clone() for k, v in s["params"].items()},
                    "opt": {m: {k: v.clone() for k, v in s["opt"][m].items()}
                            for m in ("m", "v")}, "step": s["step"].clone()}

        s_a = clone(state)
        for step in range(4):
            adamw_update(g, s_a["opt"], s_a["params"], step, cfg)
        mgr = CheckpointManager(str(tmp_path), keep=1)
        s_b = clone(state)
        for step in range(2):
            adamw_update(g, s_b["opt"], s_b["params"], step, cfg)
        s_b["step"] = torch.tensor(2, dtype=torch.int32)
        mgr.save(2, s_b)
        s_b, _ = mgr.restore(template=s_b, device="cpu")
        for step in range(2, 4):
            adamw_update(g, s_b["opt"], s_b["params"], step, cfg)
        assert_bit_equal(s_b["params"], s_a["params"])
        assert_bit_equal(s_b["opt"], s_a["opt"])


# ------------------------------------------------ across the two packages

LM = dict(name="tiny-ckpt", family="dense", num_layers=3, d_model=32,
          num_heads=2, num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=128)


def lm_states(moment_dtype):
    """The same bf16 weights in both packages after one port train step
    (so the moments are non-zero): (port model, port state, reference
    state tree with JAX arrays)."""
    flags = RuntimeFlags(param_dtype="bfloat16", compute_dtype="bfloat16",
                         use_pallas=False)
    model = build_model(ArchConfig(**LM), flags, device="cpu", seed=3)
    cfg = AdamWConfig(warmup_steps=0, peak_lr=1e-3, moment_dtype=moment_dtype)
    state = init_state(model, cfg)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 128, (2, 8)).astype(np.int32),
             "targets": rng.integers(0, 128, (2, 8)).astype(np.int32)}
    state, _ = make_train_step(model, cfg)(state, batch)
    ref = jax.tree.map(lambda t: jnp.asarray(_bits(t)).view(jnp.bfloat16)
                       if t.dtype == torch.bfloat16 else jnp.asarray(
                           t.detach().numpy()),
                       state_to_reference(model, state))
    return model, state, ref


def reference_template(moment_dtype):
    """The reference's own state tree for the same config (its layout and
    dtypes, other values)."""
    flags = JaxFlags(param_dtype="bfloat16", compute_dtype="bfloat16")
    jm = jax_build(JaxArchConfig(**LM), flags,
                   ShardingRules.create(make_mesh((1,), ("data",))))
    params = jm.init(jax.random.key(0))
    return {"params": params, "opt": ref_adamw_init(
        params, RefAdamWConfig(moment_dtype=moment_dtype)),
        "step": jnp.zeros((), jnp.int32)}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_port_checkpoint_restores_in_the_reference(tmp_path, moment_dtype):
    model, state, _ = lm_states(moment_dtype)
    CheckpointManager(str(tmp_path)).save(
        1, state_to_reference(model, state), extra={"data": {"seed": 0}})
    template = reference_template(moment_dtype)
    restored, manifest = RefCheckpointManager(str(tmp_path)).restore(
        template=template)
    assert manifest["step"] == 1 and manifest["extra"]["data"]["seed"] == 0
    assert jax.tree.structure(restored) == jax.tree.structure(
        jax.tree.map(np.asarray, template))
    for k, a in _flat(restored).items():
        assert str(np.asarray(a).dtype) == str(np.asarray(
            _flat(template)[k]).dtype), k
    assert_bit_equal(restored, state_to_reference(model, state))


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, moment_dtype):
    model, state, ref = lm_states(moment_dtype)
    RefCheckpointManager(str(tmp_path)).save(
        4, ref, extra={"data": {"seed": 0, "emitted": 4}})
    tree, manifest = CheckpointManager(str(tmp_path)).restore(device="cpu")
    assert manifest["step"] == 4
    fresh = build_model(ArchConfig(**LM), model.flags, device="cpu", seed=9)
    got = state_from_reference(fresh, tree)
    assert all(p.requires_grad for p in fresh.parameters())
    assert int(got["step"]) == 1
    assert_bit_equal(state_to_reference(fresh, got), jax.tree.map(
        np.asarray, ref))
    assert_bit_equal({n: p for n, p in fresh.named_parameters()},
                     {n: p for n, p in model.named_parameters()})


def test_manifest_matches_the_reference_layout(tmp_path):
    """Same keys, dtype names and shapes in both packages' manifests for
    the same state."""
    model, state, ref = lm_states("float32")
    CheckpointManager(str(tmp_path / "port")).save(
        3, state_to_reference(model, state))
    RefCheckpointManager(str(tmp_path / "ref")).save(3, ref)
    m = [json.loads((tmp_path / d / "step_00000003" /
                     "manifest.json").read_text()) for d in ("port", "ref")]
    for key in ("step", "keys", "dtypes", "shapes", "extra"):
        assert m[0][key] == m[1][key], key
    assert "bfloat16" in m[0]["dtypes"].values()


def test_export_restacks_scanned_layers():
    model, state, _ = lm_states("float32")
    tree = export_reference_params(model)
    wq = tree["stack"]["pos0"]["mixer"]["wq"]
    assert wq.shape == (3, 32, 2, 16)
    for i in range(3):
        assert torch.equal(wq[i], model.layers[i].mixer["wq"])
    assert set(tree) == {"embed", "stack", "ln_f"}


@pytest.mark.parametrize("arch", ["whisper-large-v3-smoke",
                                  "internvl2-26b-smoke"])
def test_encoder_and_frontend_checkpoints_cross_both_ways(tmp_path, arch):
    """A bf16 state after one train step with the frontend's embeds in the
    batch (non-zero moments on every leaf the step reaches, the encoder's
    and cross-attention's too): the port's checkpoint restores in the
    reference with its own tree's structure and dtypes, and the
    reference's save of it restores in a fresh port model, both bit for
    bit."""
    cfg = get_config(arch)
    flags = RuntimeFlags(param_dtype="bfloat16", compute_dtype="bfloat16",
                         use_pallas=False)
    model = build_model(cfg, flags, device="cpu", seed=3)
    opt = AdamWConfig(warmup_steps=0, peak_lr=1e-3)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 256, (2, 8)).astype(np.int32),
             "targets": rng.integers(0, 256, (2, 8)).astype(np.int32)}
    if cfg.frontend == "audio":
        batch["audio_embeds"] = rng.normal(
            size=(2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    else:
        batch["image_embeds"] = rng.normal(
            size=(2, cfg.num_frontend_tokens, cfg.d_model)).astype(
                np.float32)
    state, _ = make_train_step(model, opt)(init_state(model, opt), batch)
    tree = state_to_reference(model, state)
    if cfg.encoder_layers:
        assert {"enc_stack", "enc_ln_f"} <= set(tree["params"])
        assert {"cross", "ln_cross"} <= set(tree["params"]["stack"]["pos0"])
        assert float(tree["opt"]["m"]["enc_stack"]["pos0"]["mixer"]["wq"]
                     .float().abs().max()) > 0
    CheckpointManager(str(tmp_path / "port")).save(1, tree)
    jm = jax_build(jax_config(arch), JaxFlags(
        param_dtype="bfloat16", compute_dtype="bfloat16"),
        ShardingRules.create(make_mesh((1,), ("data",))))
    params = jm.init(jax.random.key(0))
    template = {"params": params, "opt": ref_adamw_init(
        params, RefAdamWConfig()), "step": jnp.zeros((), jnp.int32)}
    restored, _ = RefCheckpointManager(str(tmp_path / "port")).restore(
        template=template)
    assert jax.tree.structure(restored) == jax.tree.structure(
        jax.tree.map(np.asarray, template))
    for k, a in _flat(restored).items():
        assert str(np.asarray(a).dtype) == str(np.asarray(
            _flat(template)[k]).dtype), k
    assert_bit_equal(restored, tree)
    RefCheckpointManager(str(tmp_path / "ref")).save(2, restored)
    back, manifest = CheckpointManager(str(tmp_path / "ref")).restore(
        device="cpu")
    assert manifest["step"] == 2
    fresh = build_model(cfg, flags, device="cpu", seed=9)
    got = state_from_reference(fresh, back)
    assert_bit_equal(state_to_reference(fresh, got), tree)
    assert_bit_equal({n: p for n, p in fresh.named_parameters()},
                     {n: p for n, p in model.named_parameters()})


# ---------------------------------------------------------------- elastic

class TestElastic:
    def test_rescale_drops_replicas(self):
        pol = ElasticPolicy(min_data_parallel=2)
        new = rescale_mesh_shape({"pod": 2, "data": 16, "model": 16}, 30, pol)
        assert new == {"pod": 2, "data": 15, "model": 16}
        new = rescale_mesh_shape({"data": 16, "model": 16}, 12, pol)
        assert new == {"data": 12, "model": 16}

    def test_rescale_below_minimum(self):
        pol = ElasticPolicy(min_data_parallel=4)
        assert rescale_mesh_shape({"data": 16, "model": 16}, 3, pol) is None

    def test_batch_rescale_preserves_global(self):
        assert scale_batch(256, 16, 12) * 12 >= 256

    def test_straggler_eviction(self):
        pol = ElasticPolicy(straggler_factor=2.0, straggler_patience=3)
        mon = StragglerMonitor(4, pol, ema=0.0)
        for _ in range(5):
            for h in range(4):
                mon.observe(h, 10.0 if h != 2 else 50.0)
            evict = mon.update_flags()
        assert evict == [2]

    def test_healthy_fleet_no_eviction(self):
        pol = ElasticPolicy()
        mon = StragglerMonitor(8, pol)
        for _ in range(10):
            for h in range(8):
                mon.observe(h, 10.0 + 0.1 * h)
            assert mon.update_flags() == []

    @pytest.mark.parametrize("shape,healthy", [
        ({"pod": 2, "data": 16, "model": 16}, 30),
        ({"pod": 4, "data": 2, "model": 8}, 3),
        ({"data": 16, "model": 16}, 12), ({"data": 8}, 1),
        ({"data": 8, "model": 2}, 0)])
    def test_policy_matches_reference(self, shape, healthy):
        pol = ElasticPolicy(min_data_parallel=1)
        rpol = ref_elastic.ElasticPolicy(min_data_parallel=1)
        assert rescale_mesh_shape(shape, healthy, pol) == \
            ref_elastic.rescale_mesh_shape(shape, healthy, rpol)
        assert scale_batch(96, 8, max(healthy, 1)) == \
            ref_elastic.scale_batch(96, 8, max(healthy, 1))


# ------------------------------------------------------------------- data

class TestDataPipeline:
    def test_cursor_resume_reproduces_stream(self):
        ds1 = PackedLMDataset(vocab_size=512, seq_len=128, batch_size=4,
                              seed=3)
        it1 = iter(ds1)
        [next(it1) for _ in range(5)]
        state = ds1.state()
        after = [next(it1) for _ in range(2)]

        ds2 = PackedLMDataset(vocab_size=512, seq_len=128, batch_size=4,
                              seed=999)
        ds2.restore(state)
        it2 = iter(ds2)
        after2 = [next(it2) for _ in range(2)]
        for a, b in zip(after, after2):
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
            np.testing.assert_array_equal(a["mask"], b["mask"])

    @pytest.mark.parametrize("kw", [
        dict(vocab_size=512, seq_len=128, batch_size=4, seed=3),
        dict(vocab_size=2048, seq_len=256, batch_size=3, seed=0,
             docs_per_shot=64),
        dict(vocab_size=300, seq_len=64, batch_size=8, seed=7, pack=False)])
    def test_batches_equal_the_reference(self, kw):
        port_it, ref_it = iter(PackedLMDataset(**kw)), iter(RefDataset(**kw))
        for _ in range(6):
            a, b = next(port_it), next(ref_it)
            assert set(a) == set(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
            assert packing_efficiency(a) == ref_packing_efficiency(b)

    def test_resume_equals_the_reference_resume(self):
        kw = dict(vocab_size=512, seq_len=128, batch_size=4, seed=5)
        ref = RefDataset(**kw)
        it = iter(ref)
        [next(it) for _ in range(3)]
        port = PackedLMDataset(**dict(kw, seed=1))
        port.restore(ref.state())
        assert port.state() == ref.state()
        a, b = next(iter(port)), next(it)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


# ------------------------------------------------------- crash-safe resume

def test_trainer_resumes_bit_for_bit(tmp_path):
    """A run cut at a checkpoint and resumed in a fresh trainer ends in the
    same state, bit for bit, as one uninterrupted run."""
    cfg = ArchConfig(**LM)
    kw = dict(opt_cfg=AdamWConfig(warmup_steps=2, total_steps=6),
              batch=2, seq=32, device="cpu")
    whole = Trainer(cfg, **kw)
    whole.run(6, log=None)
    first = Trainer(cfg, ckpt_dir=str(tmp_path), ckpt_every=2, **kw)
    assert first.start == 0
    out = first.run(4, log=None)
    assert out["saved"] == [2, 4] and len(out["loss"]) == 4
    resumed = Trainer(cfg, ckpt_dir=str(tmp_path), ckpt_every=2, **kw)
    assert resumed.start == 4
    assert resumed.dataset.state() == first.dataset.state()
    assert_bit_equal(state_to_reference(resumed.model, resumed.state),
                     state_to_reference(first.model, first.state))
    out = resumed.run(6, log=None)
    assert out["saved"] == [6] and len(out["loss"]) == 2
    assert_bit_equal(state_to_reference(resumed.model, resumed.state),
                     state_to_reference(whole.model, whole.state))
