"""The square gather+Gram kernel's metric epilogue, and the fused
executor's one assembly vector that every bucket is written into.

On the CPU: ``fused_gather_gram(..., metric)`` is the plain version
finished in torch (``finish_fused_blocks``) and ``out`` receives it; each
bucket's slice of the vector ``[0.0, blocks_0.ravel(), ...]`` starts at the
base ``assembly._pair_source_map`` gives it and slot 0 reads 0.0; the
answer is the old composition's (finish, ``cat`` with the zero slot,
gather) exactly; the obs counter ``fused.finish`` counts one torch finish a
bucket and the executors' ``stats()`` keep their keys.  On a card
(``gpu``): the epilogue is bit for bit the torch finish of the raw
kernel's blocks (NaN positions included) at every width up to 32, wider
buckets take the torch finish, and a Zipf A2A request equals the old
composition, holds the bucketed oracle's tolerance and peaks lower.

    PYTHONPATH=src python -m pytest -q tests/test_torch_gram_epilogue.py
    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gram_epilogue.py
"""

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import plan_a2a
from repro_torch.kernels.pairwise import fused_gather_gram as fgg_mod
from repro_torch.kernels.pairwise.fused_gather_gram import (
    finish_fused_blocks,
    fused_gather_gram,
    fused_gather_gram_ref,
)
from repro_torch.launch import obs_report
from repro_torch.mapreduce import allpairs, executors
from repro_torch.mapreduce.allpairs import (
    _block_fn,
    _plan_for,
    pairwise_similarity,
)
from repro_torch.mapreduce.assembly import _pair_source_map
from repro_torch.mapreduce.engine import bucket_arrays
from repro_torch.mapreduce.executors import (
    FusedExecutor,
    ShardedExecutor,
)

METRICS = ["dot", "cosine", "l2"]
FP32 = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture(autouse=True)
def _clean_obs():
    obs.reset_all()
    yield
    obs.reset_all()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _finished(where: str) -> float:
    return obs.REGISTRY.counter_total("fused.finish", where=where)


def _inputs(seed, R, L, m, d, dev, dtype=torch.float32, outside=False):
    """Random rows at 70% valid slots, the last reducer all masked (a
    padding row) and, with ``outside``, one valid slot past the table."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, m, (R, L)).astype(np.int32))
    mask = torch.from_numpy(rng.uniform(size=(R, L)) < 0.7)
    mask[-1] = False
    if outside:
        idx[0, L - 1], mask[0, L - 1] = m, True
    return x.to(dev, dtype), idx.to(dev), mask.to(dev)


def _same_bits(got, want):
    """Equal bit for bit where finite or infinite, NaN at the same
    positions."""
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))


def _zipf_sizes(m, seed):
    """The benchmark's size profile: Zipf a = 1.6 over 32, clipped to
    [0.01, 0.45] of q = 1 (buckets 4 to 32 wide)."""
    rng = np.random.default_rng(seed)
    return np.clip(rng.zipf(1.6, m) / 32, 0.01, 0.45), rng


def _zipf_problem(m, d, seed=0, dev="cpu"):
    w, rng = _zipf_sizes(m, seed)
    x = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32))
    plan = _plan_for(plan_a2a(w, 1.0), pad_reducers_to=1, pad_slots_to=1)
    return x.to(dev), plan


def _srcmap(plan, m, dev):
    return torch.as_tensor(_pair_source_map(plan, m), device=dev).long()


def _composition(x, plan, m, metric, srcmap=None):
    """The fused request before the epilogue: the raw kernel (or plain
    version) per bucket, the torch finish, ``cat`` with the zero slot, and
    the gather through the source map."""
    if srcmap is None:
        srcmap = _srcmap(plan, m, x.device)
    blocks = [finish_fused_blocks(fused_gather_gram(x, idx, msk), msk,
                                  metric)
              for idx, msk, _ in bucket_arrays(plan, x.device)]
    return torch.cat([blocks[0].new_zeros(1)]
                     + [b.reshape(-1) for b in blocks])[srcmap]


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("L", [1, 3, 8, 33])
@pytest.mark.parametrize("metric", METRICS)
def test_cpu_metric_is_the_plain_version_finished_in_torch(metric, L):
    x, idx, mask = _inputs(L, 9, L, 40, 16, "cpu")
    got = fused_gather_gram(x, idx, mask, metric)
    want = finish_fused_blocks(fused_gather_gram_ref(x, idx, mask), mask,
                               metric)
    _same_bits(got, want)
    assert float(got[-1].abs().max()) == 0.0        # the padding row
    assert (_finished("torch"), _finished("kernel")) == (1, 0)


def test_cpu_raw_call_counts_no_finish():
    x, idx, mask = _inputs(0, 5, 4, 20, 8, "cpu")
    torch.testing.assert_close(fused_gather_gram(x, idx, mask),
                               fused_gather_gram_ref(x, idx, mask))
    assert (_finished("torch"), _finished("kernel")) == (0, 0)


@pytest.mark.parametrize("metric", [None, "cosine"])
def test_cpu_out_receives_the_result(metric):
    x, idx, mask = _inputs(1, 6, 5, 30, 8, "cpu")
    flat = torch.full((1 + 6 * 25 + 3,), 7.0)
    view = flat[1:1 + 6 * 25].view(6, 5, 5)
    got = fused_gather_gram(x, idx, mask, metric, view)
    assert got.data_ptr() == view.data_ptr()
    _same_bits(view, fused_gather_gram(x, idx, mask, metric))
    assert float(flat[0]) == 7.0 and flat[-3:].eq(7.0).all()


def test_wrapper_rejects_an_unknown_metric_or_a_wrong_out():
    x, idx, mask = _inputs(2, 3, 4, 10, 8, "cpu")
    with pytest.raises(ValueError, match="metric"):
        fused_gather_gram(x, idx, mask, "manhattan")
    for out in (torch.empty(3, 4, 5), torch.empty(3, 4, 4,
                                                  dtype=torch.float64),
                torch.empty(3, 4, 8)[..., :4]):
        with pytest.raises(ValueError, match="out"):
            fused_gather_gram(x, idx, mask, "dot", out)


def _spy_assembly(monkeypatch):
    seen = []
    real = executors._assemble_from_srcmap

    def spy(per_bucket, srcmap, flat=None):
        seen.append((per_bucket, srcmap, flat))
        return real(per_bucket, srcmap, flat)
    monkeypatch.setattr(executors, "_assemble_from_srcmap", spy)
    return seen


@pytest.mark.parametrize("metric", METRICS)
def test_flat_buffer_offsets_are_the_source_maps_bases(monkeypatch, metric):
    x, plan = _zipf_problem(300, 12, seed=3)
    seen = _spy_assembly(monkeypatch)
    got = FusedExecutor().run_pairs(x, plan, _block_fn(metric, False), 300,
                                    device="cpu")
    (per_bucket, srcmap, flat), = seen
    assert flat is not None and float(flat[0]) == 0.0
    base = 1                  # _pair_source_map's numbering of the buckets
    for b, (_arrays, view) in zip(plan.buckets, per_bucket):
        Rb, Lb = b.idx.shape
        assert view.shape == (Rb, Lb, Lb)
        assert view.untyped_storage().data_ptr() == \
            flat.untyped_storage().data_ptr()
        assert view.storage_offset() == flat.storage_offset() + base
        base += Rb * Lb * Lb
    assert flat.numel() == base
    assert int(srcmap.max()) < base
    _same_bits(got, flat[srcmap])
    _same_bits(got, _composition(x, plan, 300, metric))


def test_a_bucket_wider_than_32_is_finished_in_torch_into_its_slice(
        monkeypatch):
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(120, 8)).astype(np.float32))
    plan = _plan_for(plan_a2a(np.full(120, 0.02), 1.0), pad_reducers_to=1,
                     pad_slots_to=1)
    assert max(b.width for b in plan.buckets) > 32
    seen = _spy_assembly(monkeypatch)
    got = FusedExecutor().run_pairs(x, plan, _block_fn("cosine", False),
                                    120, device="cpu")
    assert seen[0][2] is not None
    _same_bits(got, _composition(x, plan, 120, "cosine"))


def test_cpu_counter_counts_one_torch_finish_per_bucket():
    x, plan = _zipf_problem(200, 8, seed=5)
    FusedExecutor().run_pairs(x, plan, _block_fn("cosine", False), 200,
                              device="cpu")
    assert _finished("torch") == len(plan.buckets) > 1
    assert _finished("kernel") == 0
    text = obs_report.render(obs_report.gather())
    assert f"in the kernel: 0 of {len(plan.buckets)} buckets (0.0%)" in text


def test_stats_dicts_are_unchanged():
    x, plan = _zipf_problem(120, 8, seed=6)
    ex = FusedExecutor()
    ex.run_pairs(x, plan, _block_fn("cosine", False), 120, device="cpu")
    assert ex.stats() == {"calls": 1, "kernel": 0, "streamed": 1,
                          "fallbacks": 0}

    def not_tagged(block, mask):          # no fused_metric: the fallback
        return allpairs.block_similarity(block, mask, metric="cosine")
    ex.run_pairs(x, plan, not_tagged, 120, device="cpu")
    assert ex.stats() == {"calls": 2, "kernel": 0, "streamed": 1,
                          "fallbacks": 1}
    sh = ShardedExecutor()
    sh.run_pairs(x, plan, _block_fn("cosine", False), 120, device="cpu")
    assert set(sh.stats()) == {"calls", "sharded", "fallbacks",
                               "num_shards", "balance_factor"}


@pytest.mark.parametrize("combine", ["dense", "buckets"])
def test_the_combines_read_views_of_one_buffer(combine):
    x, plan = _zipf_problem(150, 8, seed=7)
    fn = _block_fn("l2", False)
    got = FusedExecutor().run(x, plan, fn, combine=combine, device="cpu")
    arrays = bucket_arrays(plan, "cpu")
    want = [finish_fused_blocks(fused_gather_gram_ref(x, i, k), k, "l2")
            for i, k, _ in arrays]
    if combine == "buckets":
        assert len({g.untyped_storage().data_ptr() for g in got}) == 1
        for g, w in zip(got, want):
            _same_bits(g, w)
    else:
        assert got.shape == (plan.R, plan.L, plan.L)
        for (_i, _k, rows), w in zip(arrays, want):
            Lb = w.shape[1]
            _same_bits(got[rows[rows < plan.R]][:, :Lb, :Lb],
                       w[rows < plan.R])


def test_a_request_through_the_entry_equals_the_composition():
    w, rng = _zipf_sizes(256, 8)
    x = torch.from_numpy(rng.normal(size=(256, 16)).astype(np.float32))
    sims, plan, _ = pairwise_similarity(x, q=1.0, weights=w,
                                        metric="cosine", executor="fused",
                                        device="cpu")
    _same_bits(sims, _composition(x, plan, 256, "cosine"))


# ---------------------------------------------------------------------------
# card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [1, 2, 3, 4, 8, 16, 32])
@pytest.mark.parametrize("metric", METRICS)
def test_epilogue_is_the_torch_finish_bit_for_bit(cuda, metric, L, dtype):
    x, idx, mask = _inputs(L * 7 + len(metric), 300, L, 500, 256, cuda,
                           getattr(torch, dtype), outside=True)
    before = fgg_mod.launch_count()
    got = fused_gather_gram(x, idx, mask, metric)
    assert fgg_mod.launch_count() == before + 1
    want = finish_fused_blocks(fused_gather_gram(x, idx, mask), mask,
                               metric)
    torch.cuda.synchronize()
    _same_bits(got, want)
    # the slot past the table: NaN beside every valid slot, +0 beside a
    # masked one
    beside = got[0, L - 1]
    assert bool(beside[mask[0]].isnan().all())
    assert torch.equal(beside[~mask[0]].view(torch.int32),
                       torch.zeros_like(beside[~mask[0]]).view(torch.int32))
    assert float(got[-1].abs().max()) == 0.0       # the padding row
    assert (_finished("kernel"), _finished("torch")) == (1, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("L", [33, 64])
@pytest.mark.parametrize("metric", METRICS)
def test_wider_buckets_take_the_torch_finish(cuda, metric, L):
    x, idx, mask = _inputs(L, 50, L, 400, 64, cuda, outside=True)
    got = fused_gather_gram(x, idx, mask, metric)
    assert (_finished("kernel"), _finished("torch")) == (0, 1)
    want = finish_fused_blocks(fused_gather_gram(x, idx, mask), mask,
                               metric)
    _same_bits(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", METRICS)
def test_epilogue_writes_into_a_view_off_16_bytes(cuda, metric):
    x, idx, mask = _inputs(9, 70, 12, 200, 48, cuda)
    n = 70 * 12 * 12
    flat = torch.full((1 + n + 5,), 3.0, device=cuda)
    view = flat[1:1 + n].view(70, 12, 12)
    assert fused_gather_gram(x, idx, mask, metric, view) is view
    _same_bits(view, finish_fused_blocks(fused_gather_gram(x, idx, mask),
                                         mask, metric))
    assert float(flat[0]) == 3.0 and bool(flat[-5:].eq(3.0).all())


@pytest.mark.gpu
def test_a_zipf_request_equals_the_composition_and_peaks_lower(cuda):
    m = 1024
    x, plan = _zipf_problem(m, 256, seed=11, dev=cuda)
    fn = _block_fn("cosine", False)
    ex = FusedExecutor()
    ex.run_pairs(x, plan, fn, m)                 # uploads and builds
    want = _composition(x, plan, m, "cosine")
    torch.cuda.synchronize()
    obs.reset_all()
    got = ex.run_pairs(x, plan, fn, m)
    torch.cuda.synchronize()
    _same_bits(got, want)
    assert _finished("kernel") == len(plan.buckets) == 4
    assert _finished("torch") == 0
    oracle = allpairs.get_executor("bucketed").run_pairs(
        x, plan, fn, m, device=cuda)
    torch.testing.assert_close(got, oracle, **FP32)
    del got, want, oracle

    def peak(call):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(cuda)
        base = torch.cuda.memory_allocated(cuda)
        out = call()
        torch.cuda.synchronize()
        p = torch.cuda.max_memory_allocated(cuda) - base
        del out
        return p
    srcmap = _srcmap(plan, m, cuda)
    old = peak(lambda: _composition(x, plan, m, "cosine", srcmap))
    new = peak(lambda: ex.run_pairs(x, plan, fn, m))
    assert new < old, (new, old)
