"""The rect gather+Gram kernel's metric epilogue, and the fused executor's
one X2Y assembly vector that every rect bucket is written into.

On the CPU: ``fused_gather_gram_rect(..., metric)`` is the plain version
finished in torch (``finish_rect_blocks``) and
``out`` receives it; each launch's slice of the vector ``[0.0,
blocks_0.ravel(), ...]`` starts at the base ``assembly._pair_source_map_rect``
gives it on the launch plan (``assembly.rect_launch_plan``) and slot 0
reads 0.0; the answer is the old composition's (raw blocks, torch finish,
``cat`` with the zero slot, gather) over the same launches exactly; the
obs counter ``fused.finish{shape=rect}`` counts one torch finish a launch
and ``stats()`` keeps its keys.  (The plain version's ``bmm`` picks its
CPU kernel by block shape, so on the CPU a split launch may round an
entry otherwise than its plan bucket would: there the answer is held to
the plan's buckets within fp32 rounding.)  On a card (``gpu``): the
epilogue is bit for bit the torch finish of the raw kernel's blocks (NaN
positions included) for every tile pair up to 32 x 32, wider buckets take
the torch finish, a Zipf X2Y request equals the old composition over the
plan's own buckets and peaks lower, and the split launches are bit for bit
the plan's buckets for every metric and table dtype.

    PYTHONPATH=src python -m pytest -q tests/test_torch_rect_epilogue.py
    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_rect_epilogue.py
"""

import numpy as np
import pytest
import torch

import _torch_ranks

from repro_torch import obs
from repro_torch.core import plan_a2a, plan_x2y
from repro_torch.kernels.pairwise import fused_gather_gram as fgg_mod
from repro_torch.kernels.pairwise.fused_gather_gram import (
    finish_rect_blocks,
    fused_gather_gram_rect,
    fused_gather_gram_rect_ref,
    rect_table_norms,
)
from repro_torch.launch import obs_report
from repro_torch.mapreduce import allpairs, executors
from repro_torch.mapreduce.allpairs import (
    _block_fn,
    _block_fn_x2y,
    _plan_for,
    _x2y_plan_for,
    x2y_similarity,
)
from repro_torch.mapreduce.assembly import (
    _pair_source_map_rect,
    rect_launch_plan,
    with_zero_slot,
)
from repro_torch.mapreduce.engine import rect_bucket_arrays
from repro_torch.mapreduce.executors import FusedExecutor, make_executor

METRICS = ["dot", "cosine", "l2"]
WIDTHS = [1, 3, 8, 33]
TILES = [1, 2, 4, 8, 16, 32]
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
    return obs.REGISTRY.counter_total("fused.finish", where=where,
                                      shape="rect")


def _inputs(seed, R, Lx, Ly, mx, my, d, dev, dtype=torch.float32,
            outside=False):
    """Random tables and slots at 70% valid, the last reducer all masked
    on both sides (a padding row) and, with ``outside``, one valid X slot
    past its table (reducer 0) and one valid Y slot past its (reducer 1)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(mx, d)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(my, d)).astype(np.float32))
    xidx = torch.from_numpy(rng.integers(0, mx, (R, Lx)).astype(np.int32))
    yidx = torch.from_numpy(rng.integers(0, my, (R, Ly)).astype(np.int32))
    xmask = torch.from_numpy(rng.uniform(size=(R, Lx)) < 0.7)
    ymask = torch.from_numpy(rng.uniform(size=(R, Ly)) < 0.7)
    xmask[-1] = ymask[-1] = False
    if outside:
        xidx[0, Lx - 1], xmask[0, Lx - 1] = mx, True
        yidx[1, Ly - 1], ymask[1, Ly - 1] = my, True
    return (x.to(dev, dtype), y.to(dev, dtype), xidx.to(dev), xmask.to(dev),
            yidx.to(dev), ymask.to(dev))


def _same_bits(got, want):
    """Equal bit for bit where finite or infinite, NaN at the same
    positions."""
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))


def _torch_finish(g, x, y, xidx, xmask, yidx, ymask, metric):
    """``finish_rect_blocks`` of raw blocks ``g``; a valid slot past its
    table reads row 0's norm (its row or column of ``g`` is NaN, so the
    norm does not show), since a gather past a table would fault."""
    xin = torch.where(xidx < x.shape[0], xidx, 0)
    yin = torch.where(yidx < y.shape[0], yidx, 0)
    return finish_rect_blocks(g, xin, xmask, yin, ymask,
                              *rect_table_norms(x, y, metric), metric)


def _zipf_sizes(mx, my, seed):
    """The X2Y cell's size profile on both sides: Zipf a = 1.6 over 32,
    clipped to [0.01, 0.45] of q = 1."""
    rng = np.random.default_rng(seed)
    wy = np.clip(rng.zipf(1.6, my) / 32, 0.01, 0.45)
    wx = np.clip(rng.zipf(1.6, mx) / 32, 0.01, 0.45)
    return wx, wy, rng


def _zipf_problem(mx, my, d, seed=0, dev="cpu"):
    wx, wy, rng = _zipf_sizes(mx, my, seed)
    x = torch.from_numpy(rng.normal(size=(mx, d)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(my, d)).astype(np.float32))
    plan = _x2y_plan_for(plan_x2y(wx, wy, 1.0), mx, pad_reducers_to=1,
                         pad_slots_to=1)
    return x.to(dev), y.to(dev), plan


def _srcmap(plan, mx, my, dev):
    return torch.as_tensor(_pair_source_map_rect(plan, mx, my),
                           device=dev).long()


def _composition(x, y, plan, metric, srcmap=None):
    """The fused X2Y request before the epilogue: the raw kernel (or plain
    version) per bucket, the torch finish, ``cat`` with the zero slot, and
    the gather through the source map."""
    if srcmap is None:
        srcmap = _srcmap(plan, x.shape[0], y.shape[0], x.device)
    norms = rect_table_norms(x, y, metric)
    blocks = [finish_rect_blocks(fused_gather_gram_rect(x, y, *a[:4]),
                                 *a[:4], *norms, metric)
              for a in rect_bucket_arrays(plan, x.device)]
    return with_zero_slot(blocks, x.device)[srcmap]


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("Ly", WIDTHS)
@pytest.mark.parametrize("Lx", WIDTHS)
@pytest.mark.parametrize("metric", METRICS)
def test_cpu_metric_is_the_plain_version_finished_in_torch(metric, Lx, Ly):
    args = _inputs(Lx * 40 + Ly, 9, Lx, Ly, 40, 50, 16, "cpu")
    x, y, xidx, xmask, yidx, ymask = args
    want = finish_rect_blocks(fused_gather_gram_rect_ref(*args), xidx,
                              xmask, yidx, ymask,
                              *rect_table_norms(x, y, metric), metric)
    obs.reset_all()
    got = fused_gather_gram_rect(*args, metric)
    _same_bits(got, want)
    assert float(got[-1].abs().max()) == 0.0        # the padding row
    assert (_finished("torch"), _finished("kernel")) == (1, 0)


def test_cpu_given_norms_are_used_and_a_raw_call_counts_no_finish():
    args = _inputs(0, 5, 4, 6, 20, 30, 8, "cpu")
    torch.testing.assert_close(fused_gather_gram_rect(*args),
                               fused_gather_gram_rect_ref(*args))
    assert (_finished("torch"), _finished("kernel")) == (0, 0)
    x, y = args[:2]
    norms = rect_table_norms(x, y, "l2")
    _same_bits(fused_gather_gram_rect(*args, "l2", None, norms),
               fused_gather_gram_rect(*args, "l2"))
    doubled = tuple(2 * n for n in norms)
    assert not torch.equal(fused_gather_gram_rect(*args, "l2", None,
                                                  doubled),
                           fused_gather_gram_rect(*args, "l2"))


@pytest.mark.parametrize("metric", [None, "cosine"])
def test_cpu_out_receives_the_result_and_leaves_its_neighbours(metric):
    args = _inputs(1, 6, 5, 3, 30, 20, 8, "cpu")
    n = 6 * 5 * 3
    flat = torch.full((1 + n + 3,), 7.0)
    view = flat[1:1 + n].view(6, 5, 3)
    got = fused_gather_gram_rect(*args, metric, view)
    assert got.data_ptr() == view.data_ptr()
    _same_bits(view, fused_gather_gram_rect(*args, metric))
    assert float(flat[0]) == 7.0 and flat[-3:].eq(7.0).all()


def test_wrapper_rejects_an_unknown_metric_or_a_wrong_out():
    args = _inputs(2, 3, 4, 5, 10, 12, 8, "cpu")
    with pytest.raises(ValueError, match="metric"):
        fused_gather_gram_rect(*args, "manhattan")
    for out in (torch.empty(3, 5, 4), torch.empty(3, 4, 5,
                                                  dtype=torch.float64),
                torch.empty(3, 4, 10)[..., :5], torch.empty(3 * 4 * 5)):
        with pytest.raises(ValueError, match="out"):
            fused_gather_gram_rect(*args, "dot", out)


def _spy_outs(monkeypatch):
    """The ``out`` of every rect call the executor makes, by its X-side
    shape."""
    seen = {}
    real = executors.fused_gather_gram_rect

    def spy(x, y, xidx, xmask, yidx, ymask, metric=None, out=None,
            norms=None):
        seen[(xidx.shape, yidx.shape[1])] = out
        return real(x, y, xidx, xmask, yidx, ymask, metric, out, norms)
    monkeypatch.setattr(executors, "fused_gather_gram_rect", spy)
    return seen


@pytest.mark.parametrize("metric", METRICS)
def test_flat_views_start_at_the_source_maps_bases(monkeypatch, metric):
    x, y, plan = _zipf_problem(60, 140, 12, seed=3)
    launch = rect_launch_plan(plan)
    assert len(plan.buckets) > 1 and launch is not plan
    seen = _spy_outs(monkeypatch)
    got = FusedExecutor().run_x2y((x, y), plan, _block_fn_x2y(metric),
                                  (60, 140), device="cpu")
    assert len(seen) == len(launch.buckets)
    views = [seen[(b.idx.shape, b.yidx.shape[1])] for b in launch.buckets]
    storage = views[0].untyped_storage()
    flat = torch.empty(0).set_(storage)       # the whole vector
    assert float(flat[0]) == 0.0
    base = 1                  # _pair_source_map_rect's numbering
    for b, view in zip(launch.buckets, views):
        assert view.shape == (b.R, b.width, b.ywidth)
        assert view.is_contiguous()
        assert view.untyped_storage().data_ptr() == storage.data_ptr()
        assert view.storage_offset() == base
        base += b.R * b.width * b.ywidth
    assert flat.numel() == base
    srcmap = _srcmap(launch, 60, 140, "cpu")
    assert int(srcmap.max()) < base
    _same_bits(got, flat[srcmap])
    _same_bits(got, _composition(x, y, launch, metric))
    torch.testing.assert_close(got, _composition(x, y, plan, metric),
                               **FP32)


@pytest.mark.parametrize("metric", METRICS)
def test_a_request_and_its_stats_equal_the_composition(metric):
    x, y, plan = _zipf_problem(50, 90, 8, seed=4)
    ex = FusedExecutor()
    got = ex.run_x2y((x, y), plan, _block_fn_x2y(metric), (50, 90),
                     device="cpu")
    _same_bits(got, _composition(x, y, rect_launch_plan(plan), metric))
    torch.testing.assert_close(got, _composition(x, y, plan, metric),
                               **FP32)
    assert ex.stats() == {"calls": 1, "kernel": 0, "streamed": 1,
                          "fallbacks": 0}


def test_a_request_through_the_entry_equals_the_composition():
    wx, wy, rng = _zipf_sizes(70, 110, 5)
    x = torch.from_numpy(rng.normal(size=(70, 16)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(110, 16)).astype(np.float32))
    sims, plan, _ = x2y_similarity(x, y, q=1.0, wx=wx, wy=wy,
                                   metric="cosine", executor="fused",
                                   device="cpu")
    _same_bits(sims, _composition(x, y, rect_launch_plan(plan), "cosine"))
    torch.testing.assert_close(sims, _composition(x, y, plan, "cosine"),
                               **FP32)


def test_cpu_counter_counts_one_torch_finish_per_bucket():
    x, y, plan = _zipf_problem(40, 80, 8, seed=6)
    FusedExecutor().run_x2y((x, y), plan, _block_fn_x2y("cosine"), (40, 80),
                            device="cpu")
    nb = len(rect_launch_plan(plan).buckets)          # one per launch
    assert _finished("torch") == nb > 1
    assert _finished("kernel") == 0
    text = obs_report.render(obs_report.gather())
    assert f"in the kernel: 0 of {nb} buckets (0.0%)" in text


# ---------------------------------------------------------------------------
# card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("TN", TILES)
@pytest.mark.parametrize("TM", TILES)
@pytest.mark.parametrize("metric", METRICS)
def test_epilogue_is_the_torch_finish_bit_for_bit(cuda, metric, TM, TN,
                                                  dtype):
    # one side as wide as its tile, the other narrower (its tile part
    # empty), swapped between the dtypes; R = 301 is no multiple of a
    # block's reducer group
    def part(t):
        return max(1, t - t // 4)
    Lx, Ly = (TM, part(TN)) if dtype == "float32" else (part(TM), TN)
    assert fgg_mod.rect_tile_widths(Lx, Ly) == (TM, TN)
    args = _inputs(TM * 97 + TN + len(metric), 301, Lx, Ly, 500, 700, 256,
                   cuda, getattr(torch, dtype), outside=True)
    before = fgg_mod._build.launch_counts().get("fused_gather_gram_rect", 0)
    got = fused_gather_gram_rect(*args, metric)
    assert fgg_mod._build.launch_counts()["fused_gather_gram_rect"] == \
        before + 1
    assert (_finished("kernel"), _finished("torch")) == (1, 0)
    want = _torch_finish(fused_gather_gram_rect(*args), *args, metric)
    torch.cuda.synchronize()
    _same_bits(got, want)
    xmask, ymask = args[3], args[5]
    # the X slot past its table: NaN beside every valid Y slot, +0 beside
    # a masked one; the Y slot past its table likewise down its column
    for line, beside in ((got[0, Lx - 1], ymask[0]),
                         (got[1, :, Ly - 1], xmask[1])):
        assert bool(line[beside].isnan().all())
        assert torch.equal(line[~beside].view(torch.int32),
                           torch.zeros_like(line[~beside]).view(torch.int32))
    assert float(got[-1].abs().max()) == 0.0       # the padding row


@pytest.mark.gpu
@pytest.mark.parametrize("Lx,Ly", [(33, 8), (8, 40), (64, 33)])
@pytest.mark.parametrize("metric", METRICS)
def test_wider_buckets_take_the_torch_finish(cuda, metric, Lx, Ly):
    args = _inputs(Lx + Ly, 50, Lx, Ly, 400, 300, 64, cuda)
    got = fused_gather_gram_rect(*args, metric)
    assert (_finished("kernel"), _finished("torch")) == (0, 1)
    want = _torch_finish(fused_gather_gram_rect(*args), *args, metric)
    _same_bits(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", METRICS)
def test_epilogue_writes_into_a_view_off_16_bytes(cuda, metric):
    args = _inputs(9, 70, 12, 5, 200, 150, 48, cuda)
    n = 70 * 12 * 5
    flat = torch.full((1 + n + 5,), 3.0, device=cuda)
    view = flat[1:1 + n].view(70, 12, 5)
    assert view.data_ptr() % 16 != 0
    assert fused_gather_gram_rect(*args, metric, view) is view
    _same_bits(view, _torch_finish(fused_gather_gram_rect(*args), *args,
                                   metric))
    assert float(flat[0]) == 3.0 and bool(flat[-5:].eq(3.0).all())


@pytest.mark.gpu
def test_the_kernel_refuses_norms_that_do_not_fit_its_tables(cuda):
    args = _inputs(10, 20, 4, 4, 64, 80, 32, cuda)
    x, y = args[:2]
    n2x, n2y = rect_table_norms(x, y, "cosine")
    for bad in ((n2x[:-1], n2y), (n2x, n2y.double()), (n2x.cpu(), n2y)):
        with pytest.raises(ValueError, match="norms"):
            fused_gather_gram_rect(*args, "cosine", None, bad)


@pytest.mark.gpu
def test_a_zipf_request_equals_the_composition_and_peaks_lower(cuda):
    mx, my = 512, 1024
    x, y, plan = _zipf_problem(mx, my, 256, seed=11, dev=cuda)
    fn = _block_fn_x2y("cosine")
    ex = FusedExecutor()
    ex.run_x2y((x, y), plan, fn, (mx, my))          # uploads and builds
    want = _composition(x, y, plan, "cosine")
    torch.cuda.synchronize()
    obs.reset_all()
    got = ex.run_x2y((x, y), plan, fn, (mx, my))
    torch.cuda.synchronize()
    _same_bits(got, want)
    launch = rect_launch_plan(plan)
    assert _finished("kernel") == len(launch.buckets) > len(plan.buckets)
    assert _finished("torch") == 0
    oracle = allpairs.get_executor("bucketed").run_x2y(
        (x, y), plan, fn, (mx, my), device=cuda)
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
    srcmap = _srcmap(plan, mx, my, cuda)
    old = peak(lambda: _composition(x, y, plan, "cosine", srcmap))
    new = peak(lambda: ex.run_x2y((x, y), plan, fn, (mx, my)))
    assert new < old, (new, old)


def _unsplit(x, y, plan, metric):
    """The fused X2Y request as it was launched before the split: one
    finished launch per plan bucket, written into the plan's vector and
    gathered through the plan's own source map."""
    norms = rect_table_norms(x, y, metric)
    blocks = [fused_gather_gram_rect(x, y, *a[:4], metric, None, norms)
              for a in rect_bucket_arrays(plan, x.device)]
    return with_zero_slot(blocks, x.device)[
        _srcmap(plan, x.shape[0], y.shape[0], x.device)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", METRICS)
def test_split_launches_are_the_plan_buckets_bit_for_bit(cuda, metric,
                                                         dtype):
    """Each entry's products run over k in one order whatever the tile
    pair, and the epilogue is per entry: launching the tight classes of
    ``rect_launch_plan`` gives the plan's buckets' answer to the bit, in
    one launch per class."""
    mx, my = 512, 1024
    x, y, plan = _zipf_problem(mx, my, 256, seed=13, dev=cuda)
    x, y = x.to(getattr(torch, dtype)), y.to(getattr(torch, dtype))
    launch = rect_launch_plan(plan)
    assert len(launch.buckets) > len(plan.buckets)
    fn = _block_fn_x2y(metric)
    ex = FusedExecutor()
    ex.run_x2y((x, y), plan, fn, (mx, my))          # uploads and builds
    counts = fgg_mod._build.launch_counts
    before = counts().get("fused_gather_gram_rect", 0)
    got = ex.run_x2y((x, y), plan, fn, (mx, my))
    assert counts()["fused_gather_gram_rect"] - before == \
        len(launch.buckets)
    want = _unsplit(x, y, plan, metric)
    torch.cuda.synchronize()
    _same_bits(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("executor,workload", [
    ("sharded", "x2y"), ("coded", "x2y"), ("coded", "pairs")])
def test_sharded_and_coded_launches_take_the_epilogue(cuda, executor,
                                                      workload, metric):
    """One shard of the sharded and coded executors on the card: every
    rect launch passes its metric to the wrapper, and the answer is bit
    for bit the raw launches finished in torch, as those executors did."""
    mx, my = 512, 1024
    x, y, plan = _zipf_problem(mx, my, 256, seed=12, dev=cuda)
    ex = make_executor(executor)
    if workload == "x2y":
        def run():
            return ex.run_x2y((x, y), plan, _block_fn_x2y(metric), (mx, my),
                              device=x.device)
    else:
        wx, _wy, _rng = _zipf_sizes(mx, my, 12)
        square = _plan_for(plan_a2a(wx, 1.0), pad_reducers_to=1,
                           pad_slots_to=1)
        y = x

        def run():
            return ex.run_pairs(x, square, _block_fn(metric, False), mx,
                                device=x.device)
    _torch_ranks.assert_one_rect_finish_path(run, metric, x, y)
