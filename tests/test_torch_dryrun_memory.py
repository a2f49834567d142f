"""The LM dry run's memory count (``launch.op_analysis.OpCounter``'s live
storages, ``launch.dryrun.memory_fields``), on the CPU.

* hand-worked sequences: each peak and end worked out below, in blocks of
  the CUDA caching allocator (a multiple of 512 B, at least 512 B);
* the counter on meta tensors equals the counter on real CPU tensors of
  the same step: exactly for a train, a prefill and a decode step of
  ``stablelm-1.6b-smoke``; within ``SSD_RTOL`` for ``mamba2-370m-smoke``
  train, where the meta run counts one iteration of the plain SSD loop
  ``n`` times (``meta_repeat``) and the CPU run runs all ``n``;
* a fake 2 x 2 mesh lowers a smoke cell's ``peak_bytes`` per rank below
  its 1 x 1 value (``lower_cell`` given a cut config and a shape of its
  own), and DTensor's shape inference on fake tensors adds nothing (both
  in a subprocess: the fake group never meets this one);
* a storage freed and a new one at the same address count apart.
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

from repro_torch.configs import get_config
from repro_torch.launch import op_analysis
from repro_torch.launch.dryrun import cell_step, memory_fields
from repro_torch.launch.op_analysis import block_bytes, count_ops
from repro_torch.launch.specs import default_flags

ROOT = pathlib.Path(__file__).resolve().parents[1]
KB16 = 64 * 64 * 4                  # one 64 x 64 fp32 matrix: 32 blocks
# the SSD loop's meta count against its CPU run: the chunked scan keeps
# its last chunk's state, which the loop drops (1.3% at 3 chunks of a
# smoke layer); the per-position scan agrees within 0.1%
SSD_RTOL = 0.02


def test_block_bytes_round_as_the_caching_allocator():
    assert [block_bytes(n) for n in (0, 1, 512, 513, 4000)] == \
        [0, 512, 512, 1024, 4096]


def test_matmul_chain_with_backward():
    x, w1, w2 = (torch.randn(64, 64, requires_grad=True) for _ in range(3))

    def chain():
        b = (x @ w1) @ w2
        return torch.autograd.grad(b.sum(), [w1, w2])

    _, st = count_ops(chain, device="cpu")
    # b's backward: a (saved), b, the sum and its ones (a block each),
    # grad_a and grad_w2 live at once; a is freed before grad_w1
    assert st.live_peak == 4 * KB16 + 2 * 512
    assert st.live_end == 2 * KB16                  # the two gradients


def test_chain_without_grad_frees_as_it_goes():
    x, w = torch.randn(64, 64), torch.randn(64, 64)

    def chain():
        a = x @ w
        b = a @ w
        del a
        return b @ w

    _, st = count_ops(chain, device="cpu")
    assert (st.live_peak, st.live_end) == (2 * KB16, KB16)


def test_in_place_updates_add_nothing():
    x = torch.randn(64, 64)

    def update():
        y = x * 2
        y.mul_(3).add_(1)
        x.add_(1)                   # an argument's storage: not counted
        return y

    _, st = count_ops(update, device="cpu")
    assert (st.live_peak, st.live_end) == (KB16, KB16)


def test_a_view_keeps_its_freed_base():
    def views():
        a = torch.empty(1000)       # 4000 B: 8 blocks
        v = a[:10]
        del a                       # v holds a's storage
        b = torch.empty(1000)
        del v
        return b

    _, st = count_ops(views, device="cpu")
    assert (st.live_peak, st.live_end) == (8192, 4096)


def test_allocating_factories_and_resize_count():
    def alloc():
        t = torch.empty(0)
        t.resize_(1000)             # 4000 B -> 4096
        return torch.empty(100), torch.empty(0), torch.empty(129), t

    _, st = count_ops(alloc, device="cpu")
    assert st.live_peak == st.live_end == 512 + 0 + 1024 + 4096


def test_only_the_counted_device():
    def both():
        return torch.empty(1000), torch.empty(1000, device="meta")

    _, st = count_ops(both, device="meta")
    assert st.live_peak == 4096


def test_a_storage_at_a_freed_address_is_new(monkeypatch):
    """A storage freed and a new one at its address count apart.  The
    allocator hands a freed address back only now and then (another
    object can take it, or it merges with a free neighbour), so here it
    comes back by design: once ``a`` is freed, the counter reads the
    address of every storage as ``a``'s.  Counted as ``a``, ``b`` would
    add nothing."""
    freed, real = [], op_analysis._address
    monkeypatch.setattr(op_analysis, "_address",
                        lambda st: freed[0] if freed else real(st))

    def reuse():
        a = torch.empty(1024, device="meta")
        key = real(a.untyped_storage())
        del a
        freed.append(key)
        return torch.empty(1024, device="meta")

    b, st = count_ops(reuse)
    assert op_analysis._address(b.untyped_storage()) == freed[0]
    assert (st.live_peak, st.live_end) == (4096, 4096)


def test_fake_tensors_are_not_counted():
    from torch._subclasses.fake_tensor import FakeTensorMode

    def fake():
        with FakeTensorMode():
            a = torch.empty(1000)
            return (a @ a.new_empty(1000, 10)).shape

    _, st = count_ops(fake, device="cpu")
    assert st.live_peak == 0


def _count(arch, shape, seq_batch, device, **over):
    cfg = get_config(arch)
    flags = dataclasses.replace(default_flags(cfg, shape), **over)
    run, args = cell_step(cfg, shape, flags, seq_batch=seq_batch,
                          device=device)
    out, st = count_ops(run, device=device)
    return memory_fields(args, out, st)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_meta_equals_cpu_exactly(shape):
    got = _count("stablelm-1.6b-smoke", shape, (64, 2), "meta")
    want = _count("stablelm-1.6b-smoke", shape, (64, 2), "cpu")
    assert got == want
    assert got["peak_bytes"] > got["argument_bytes"] > 0


@pytest.mark.parametrize("impl,seq", [("step", 64), ("chunked", 300)])
def test_meta_counts_the_ssd_loop_as_the_cpu_runs_it(impl, seq):
    got = _count("mamba2-370m-smoke", "train_4k", (seq, 2), "meta",
                 ssd_impl=impl)
    want = _count("mamba2-370m-smoke", "train_4k", (seq, 2), "cpu",
                  ssd_impl=impl)
    assert got["argument_bytes"] == want["argument_bytes"]
    peak = want["peak_bytes"] - want["argument_bytes"]
    assert abs(got["peak_bytes"] - want["peak_bytes"]) <= SSD_RTOL * peak, \
        (got, want)


MESH_SCRIPT = textwrap.dedent("""
    import dataclasses, json
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.op_analysis import count_ops
    out = {}
    cut = dataclasses.replace(get_config("stablelm-1.6b-smoke"),
                              num_layers=1)
    for shape in ((1, 1), (2, 2)):
        _, ctx = dryrun.lower_cell(
            "stablelm-1.6b-smoke", "train_4k", False,
            mesh_shape=(shape, ("data", "model")), cfg=cut,
            seq_batch=(64, 8))
        out["x".join(map(str, shape))] = ctx["memory"]
        out["layers"] = ctx["cfg"].num_layers
    mesh = make_mesh((2, 2), ("data", "model"))
    a = DTensor.from_local(torch.empty(32, 64, device="meta"), mesh,
                           [Shard(0), Replicate()])
    b = DTensor.from_local(torch.empty(64, 16, device="meta"), mesh,
                           [Replicate(), Replicate()])
    _, st = count_ops(lambda: a @ b)
    out["dtensor"] = [st.live_peak, st.live_end]
    print("RESULT " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def meshes():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", MESH_SCRIPT], env=env,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("RESULT ")]
    assert proc.returncode == 0 and lines, proc.stdout + proc.stderr
    return json.loads(lines[-1][len("RESULT "):])


def test_sharding_lowers_the_peak_per_rank(meshes):
    one, four = meshes["1x1"], meshes["2x2"]
    assert meshes["layers"] == 1            # lower_cell ran the cut config
    assert four["argument_bytes"] < one["argument_bytes"]
    assert four["peak_bytes"] < one["peak_bytes"]
    for mem in (one, four):
        assert mem["peak_bytes"] - mem["temp_bytes"] >= \
            mem["argument_bytes"]


def test_dtensor_counts_its_local_result_only(meshes):
    # the local product, 32 x 16 fp32: DTensor's shape inference on fake
    # tensors adds nothing
    assert meshes["dtensor"] == [2048, 2048]
