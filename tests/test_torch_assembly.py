"""The one block vector and the one function that builds its source maps
(``repro_torch.mapreduce.assembly``), on the CPU.

``assembly.source_map`` gives, array and dtype, what each of the
reference's four source-map functions gives (the fused A2A and X2Y maps of
``repro.mapreduce.allpairs``, the sharded ones of
``repro.mapreduce.executors``) on Zipf plans at 1, 2 and 4 shards, and so
does each of the port's functions of the same name.  Each block's view of
the vector starts at its base and slot 0 reads 0.0; the int32 check raises
``OverflowError`` before anything is built; the executors import the
assembly, not the entry module above them; and ``engine.plan_memo`` keeps
what each plan cache keeps.

    PYTHONPATH=src python -m pytest -q tests/test_torch_assembly.py
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import repro.mapreduce as ref_mr
import repro.mapreduce.allpairs as ref_ap
import repro.mapreduce.executors as ref_ex
import repro_torch.mapreduce as port_mr
import repro_torch.mapreduce.executors as port_ex
from repro.core import partition_plan as ref_partition
from repro.core import plan_a2a as ref_plan_a2a
from repro.core import plan_x2y as ref_plan_x2y
from repro_torch.core import partition_plan, plan_a2a, plan_x2y
from repro_torch.mapreduce import assembly
from repro_torch.mapreduce.engine import plan_memo

MAPREDUCE = (pathlib.Path(__file__).resolve().parents[1] / "src"
             / "repro_torch" / "mapreduce")
SEEDS = [0, 1, 2, 3]
SHARDS = [1, 2, 4]
M, MX, MY = 60, 40, 70


def _zipf(n, rng):
    """The cells' size profile: Zipf a = 1.6 over 32, clipped to [0.01,
    0.45] of q = 1."""
    return np.clip(rng.zipf(1.6, n) / 32, 0.01, 0.45)


def _plans(rect: bool, seed: int, pad: int):
    """The reference's and the port's plan of one Zipf problem, reducer
    rows padded to ``pad``."""
    rng = np.random.default_rng(seed)
    if rect:
        wx, wy = _zipf(MX, rng), _zipf(MY, rng)
        return (ref_mr.build_x2y_plan(ref_plan_x2y(wx, wy, 1.0), MX,
                                      pad_reducers_to=pad),
                port_mr.build_x2y_plan(plan_x2y(wx, wy, 1.0), MX,
                                       pad_reducers_to=pad))
    w = _zipf(M, rng)
    return (ref_mr.build_plan(ref_plan_a2a(w, 1.0), pad_reducers_to=pad),
            port_mr.build_plan(plan_a2a(w, 1.0), pad_reducers_to=pad))


def _flat(a):
    return a.reshape(-1, a.shape[-1])


def _pair(ref, port, S):
    """The fused A2A map: every bucket, the diagonal zeroed."""
    return (ref_ap._pair_source_map(ref, M),
            [(b.idx, b.mask, b.idx, b.mask) for b in port.buckets],
            (M, M), True, assembly._pair_source_map(port, M))


def _pair_rect(ref, port, S):
    """The fused X2Y map: every rect bucket."""
    return (ref_ap._pair_source_map_rect(ref, MX, MY),
            [(b.idx, b.mask, b.yidx, b.ymask) for b in port.buckets],
            (MX, MY), False, assembly._pair_source_map_rect(port, MX, MY))


def _sharded(ref, port, S):
    """The sharded A2A map: the per-width groups of an S-way partition."""
    want = ref_ex._stacked_groups(ref, ref_partition(ref, S))
    groups = port_ex._stacked_groups(port, partition_plan(port, S))
    return (ref_ex._sharded_srcmap(want, M),
            [(_flat(i), _flat(k)) * 2 for i, k, _r in groups],
            (M, M), True, port_ex._sharded_srcmap(groups, M))


def _sharded_rect(ref, port, S):
    """The sharded X2Y map: the per-(wx, wy) groups of an S-way
    partition."""
    want = ref_ex._stacked_rect_groups(ref, ref_partition(ref, S))
    groups = port_ex._stacked_rect_groups(port, partition_plan(port, S))
    return (ref_ex._sharded_rect_srcmap(want, (MX, MY)),
            [tuple(_flat(a) for a in g[:4]) for g in groups],
            (MX, MY), False, port_ex._sharded_rect_srcmap(groups, (MX, MY)))


MAPS = {"pair": (False, _pair), "pair_rect": (True, _pair_rect),
            "sharded": (False, _sharded),
            "sharded_rect": (True, _sharded_rect)}


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", list(MAPS))
def test_source_map_equals_each_reference_map(kind, seed, S):
    rect, case = MAPS[kind]
    # the fused maps are per plan: a plan for S ranks pads its rows to S
    ref, port = _plans(rect, seed, S if kind.startswith("pair") else 1)
    want, stacks, shape, zero_diag, named = case(ref, port, S)
    got = assembly.source_map(stacks, shape, zero_diag)
    for a in (got, named):
        assert a.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(a, want)


def _blocks(rect: bool, seed: int):
    """Random blocks of a Zipf plan's bucket shapes."""
    _ref, plan = _plans(rect, seed, 1)
    layout = assembly.block_layout(plan)
    gen = torch.Generator().manual_seed(seed)
    return plan, layout, [torch.randn(s, generator=gen)
                          for s in layout.shapes]


@pytest.mark.parametrize("rect", [False, True], ids=["square", "rect"])
def test_each_view_starts_at_its_base(rect):
    plan, layout, _ = _blocks(rect, 5)
    assert len(plan.buckets) > 1
    assert assembly.block_layout(plan) is layout          # cached
    flat = layout.vector("cpu")
    assert flat.dtype == torch.float32 and flat.numel() == layout.bases[-1]
    for i, b in enumerate(plan.buckets):
        view = layout.view(flat, i)
        Ly = b.width if b.yidx is None else b.ywidth
        assert view.shape == (b.R, b.width, Ly) and view.is_contiguous()
        assert view.storage_offset() == layout.bases[i]
        assert layout.bases[i + 1] - layout.bases[i] == b.R * b.width * Ly


@pytest.mark.parametrize("rect", [False, True], ids=["square", "rect"])
def test_the_vector_of_finished_blocks_reads_zero_at_slot_0(rect):
    plan, layout, blocks = _blocks(rect, 6)
    flat = assembly.with_zero_slot(blocks, "cpu")
    assert flat.numel() == layout.bases[-1] and float(flat[0]) == 0.0
    for i, g in enumerate(blocks):
        assert torch.equal(layout.view(flat, i), g)
    # every covered cell of the source map reads an entry of a block that
    # covers it: the map and the layout agree on every base
    srcmap = (assembly._pair_source_map_rect(plan, MX, MY) if rect
              else assembly._pair_source_map(plan, M))
    got = flat[torch.as_tensor(srcmap).long()]
    rows, cols = np.nonzero(srcmap)
    pos = srcmap[rows, cols].astype(np.int64)
    which = np.searchsorted(layout.bases, pos, side="right") - 1
    assert len(pos) and set(which) == set(range(len(blocks)))
    for i, b in enumerate(plan.buckets):
        sel = which == i
        _R, Lx, Ly = layout.shapes[i]
        r, rest = np.divmod(pos[sel] - layout.bases[i], Lx * Ly)
        p, q = np.divmod(rest, Ly)
        ys, ym = ((b.idx, b.mask) if b.yidx is None else (b.yidx, b.ymask))
        assert (b.idx[r, p] == rows[sel]).all() and b.mask[r, p].all()
        assert (ys[r, q] == cols[sel]).all() and ym[r, q].all()
        assert torch.equal(got[rows[sel], cols[sel]],
                           blocks[i][r, p, q])
    assert float(got[srcmap == 0].abs().sum()) == 0.0


@pytest.mark.parametrize("zero_diag", [False, True])
def test_the_int32_check_raises_before_building(zero_diag):
    """Zero-stride stacks past 2**31 entries: nothing large is made."""
    big = np.broadcast_to(np.int32(0), (2 ** 22, 32))
    mask = np.broadcast_to(False, big.shape)
    with pytest.raises(OverflowError, match="overflow the int32 source map"):
        assembly.source_map([(big, mask, big, mask)] * 16, (8, 8), zero_diag)


@pytest.mark.parametrize("entries,raises", [(2 ** 31 - 1, False),
                                            (2 ** 31, True)])
def test_the_int32_check_stops_at_2_31(entries, raises):
    if raises:
        with pytest.raises(OverflowError, match=f"{entries} block entries"):
            assembly.check_int32(entries)
    else:
        assembly.check_int32(entries)


_IMPORT = r"^\s*(from\s+\S*\b{0}\b\S*\s+import|import\s+\S*\b{0}\b)"


@pytest.mark.parametrize("module,below", [
    ("executors", "allpairs"), ("assembly", "allpairs"),
    ("assembly", "executors")])
def test_imports_point_down(module, below):
    pattern = re.compile(_IMPORT.format(below), re.MULTILINE)
    for line in (f"from .{below} import x", f"    from .{below} import (",
                 f"import repro_torch.mapreduce.{below}"):
        assert pattern.search(line)             # the scan sees each form
    src = (MAPREDUCE / f"{module}.py").read_text()
    assert not pattern.search(src), f"{module}.py imports {below}"
    assert not re.search(rf"^\s*from\s+\.\s+import\s+.*\b{below}\b", src,
                         re.MULTILINE)


class _Plan:
    pass


@pytest.mark.parametrize("keep_last", [False, True])
def test_plan_memo_keeps_what_each_cache_keeps(keep_last):
    plan, built = _Plan(), []

    def build(k):
        built.append(k)
        return [k]
    first = plan_memo(plan, "_c", lambda: build(1), 1, keep_last=keep_last)
    assert plan_memo(plan, "_c", lambda: build(9), 1,
                     keep_last=keep_last) is first
    plan_memo(plan, "_c", lambda: build(2), 2, keep_last=keep_last)
    assert sorted(plan._c) == ([2] if keep_last else [1, 2])
    plan_memo(plan, "_c", lambda: build(1), 1, keep_last=keep_last)
    assert built == ([1, 2, 1] if keep_last else [1, 2])


def test_plan_memo_without_a_key_keeps_the_value_itself():
    plan = port_mr.build_plan(plan_a2a(np.full(6, 0.2), 1.0))
    one = plan_memo(plan, "_thing", lambda: object())
    assert plan._thing is one
    assert plan_memo(plan, "_thing", lambda: object()) is one
