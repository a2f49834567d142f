"""The port's ``BatchedServer`` against the reference's, on the same
weights: wave batching gives the same tokens as the reference's server and
as sequential decode, handles queues longer than the slot count, and
respects ``max_len`` and ``eos_id`` (the cases of ``tests/test_serve.py``).
Greedy tokens are compared exactly: both packages decode the same fp32
model, whose logits agree to ~1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JaxArchConfig
from repro.launch.mesh import make_local_mesh
from repro.launch.rules import rules_for
from repro.models import RuntimeFlags as JaxFlags
from repro.models import build_model as jax_build
from repro.serve import BatchedServer as JaxServer
from repro.serve import Request as JaxRequest
from repro_torch.configs import ArchConfig
from repro_torch.models import RuntimeFlags, build_model, \
    load_reference_params
from repro_torch.serve import BatchedServer, Request

DIMS = dict(name="tiny-serve", family="dense", num_layers=2, d_model=32,
            num_heads=2, num_kv_heads=2, head_dim=16, d_ff=64,
            vocab_size=128)

_MODELS: dict = {}


def models():
    """(JAX model, JAX params, port model on the same weights), once."""
    if not _MODELS:
        cfg = JaxArchConfig(**DIMS)
        flags = JaxFlags(param_dtype="float32", compute_dtype="float32",
                         remat="none")
        jm = jax_build(cfg, flags, rules_for(cfg, make_local_mesh(), flags))
        params = jm.init(jax.random.key(0))
        pm = build_model(ArchConfig(**DIMS), RuntimeFlags(
            param_dtype="float32", compute_dtype="float32"),
            device="cpu")
        load_reference_params(pm, jax.tree.map(np.asarray, params))
        _MODELS.update(jax=jm, params=params, port=pm)
    return _MODELS["jax"], _MODELS["params"], _MODELS["port"]


def serve_both(prompts, n_new, slots, max_len, eos_id=None):
    jm, params, pm = models()
    jserver = JaxServer(jm, params, batch_slots=slots, max_len=max_len,
                        eos_id=eos_id)
    server = BatchedServer(pm, batch_slots=slots, max_len=max_len,
                           eos_id=eos_id, device="cpu")
    jreqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=n_new)
             for i, p in enumerate(prompts)]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=n_new)
            for i, p in enumerate(prompts)]
    for jr, r in zip(jreqs, reqs):
        jserver.submit(jr)
        server.submit(r)
    jserver.run()
    server.run()
    return jreqs, reqs


def sequential_decode(model, prompt, n_new, max_len):
    cache = model.init_cache(1, max_len)
    out = []
    for t in range(len(prompt) + n_new - 1):
        cur = prompt[t] if t < len(prompt) else out[-1]
        logits, cache = model.decode_step(
            cache, {"tokens": torch.tensor([[cur]]), "pos": t})
        if t >= len(prompt) - 1:
            out.append(int(torch.argmax(logits[0, -1])))
    return out


def test_matches_reference_server_and_sequential():
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 128, n).astype(np.int32) for n in (3, 5, 4, 3)]
    jreqs, reqs = serve_both(prompts, 4, slots=2, max_len=32)
    assert all(r.done for r in reqs)
    for jr, r, p in zip(jreqs, reqs, prompts):
        assert r.out == jr.out, (r.rid, r.out, jr.out)
        assert r.out == sequential_decode(models()[2], list(map(int, p)), 4,
                                          32)


def test_queue_larger_than_slots():
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 128, 2).astype(np.int32) for _ in range(7)]
    jreqs, reqs = serve_both(prompts, 2, slots=2, max_len=16)
    assert all(r.done and len(r.out) == 2 for r in reqs)
    assert [r.out for r in reqs] == [r.out for r in jreqs]


def test_max_len_cap():
    jreqs, reqs = serve_both([np.asarray([5, 6], np.int32)], 100, slots=1,
                             max_len=6)
    assert reqs[0].done and len(reqs[0].out) <= 6
    assert reqs[0].out == jreqs[0].out


def test_eos_stops_a_request():
    rng = np.random.default_rng(2)
    prompt = rng.integers(1, 128, 4).astype(np.int32)
    _, free = serve_both([prompt], 6, slots=1, max_len=32)
    eos = free[0].out[1]
    jreqs, reqs = serve_both([prompt], 6, slots=1, max_len=32, eos_id=eos)
    assert reqs[0].out == free[0].out[:free[0].out.index(eos) + 1]
    assert reqs[0].out == jreqs[0].out


def test_server_runs_where_the_model_lives():
    _, _, pm = models()
    with pytest.raises(ValueError, match="lives on"):
        BatchedServer(pm, batch_slots=1, max_len=8, device="meta")
    assert BatchedServer(pm, batch_slots=1, max_len=8,
                         device="cpu").device.type == "cpu"
