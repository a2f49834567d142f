"""The plain reference against the port's CPU path at a small size, and
its schema checks and TF32 control on hand-made inputs."""

import numpy as np
import pytest
import torch

from chipbench import reference as ref
from chipbench.sizes import draw_sizes

LIMIT = 1e-5


def _table(m, d, seed):
    return torch.randn((m, d), generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("executor", ["dense", "bucketed", "fused"])
def test_a2a_reference_matches_the_port(executor):
    from repro_torch.core import plan_a2a
    from repro_torch.mapreduce.allpairs import pairwise_similarity
    (w,) = draw_sizes([{"dist": "zipf", "n": 150, "a": 1.6, "divide": 32.0,
                        "clip": [0.01, 0.45]}], 0)
    x = _table(150, 24, 1)
    schema = plan_a2a(w, 1.0)
    sims, _, _ = pairwise_similarity(x, q=1.0, weights=w, schema=schema,
                                     metric="cosine", executor=executor,
                                     device="cpu")
    assert ref.max_abs_err(sims, ref.cosine_a2a(x)) < LIMIT
    assert ref.a2a_violations(schema.bins, schema.reducers, w, 1.0,
                              1e-9) == {"uncovered_pairs": 0,
                                        "overfull_reducers": 0}


def test_a2a_violations_on_hand_made_schemas():
    w = [0.5, 0.5, 0.5]
    bins = [[0], [1], [2]]
    # (0, 2) meets nowhere
    assert ref.a2a_violations(bins, [[0, 1], [1, 2]], w, 1.0, 1e-9) == {
        "uncovered_pairs": 1, "overfull_reducers": 0}
    # one reducer holds 1.5 > q; a bin listed twice counts once
    assert ref.a2a_violations(bins, [[0, 1, 2], [0, 0]], w, 1.0, 1e-9) == {
        "uncovered_pairs": 0, "overfull_reducers": 1}
    # the slack allows rounding, not more
    assert ref.a2a_violations([[0, 1]], [[0]], [0.5, 0.5 + 1e-12], 1.0,
                              1e-9)["overfull_reducers"] == 0


def test_reducer_rows_groups_by_size():
    rows = ref.reducer_rows([[0, 1], [2], [3, 4, 5]], [[0, 1], [1], [2, 0]])
    by_n = {r.shape[1]: r.tolist() for r in rows}
    assert by_n == {1: [[2]], 3: [[0, 1, 2]], 5: [[3, 4, 5, 0, 1]]}


def test_tf32_rounds_to_ten_mantissa_bits():
    one = torch.tensor([1.0, 1 + 2 ** -10, 1 + 2 ** -12, -(1 + 3 * 2 ** -11),
                        1 + 2 ** -11])
    got = ref.tf32(one).tolist()
    assert got[:3] == [1.0, 1 + 2 ** -10, 1.0]
    assert got[3] == -(1 + 2 ** -9)      # a tie, to even
    assert got[4] == 1.0                 # a tie, to even
    x = _table(64, 64, 4)
    rel = ((ref.tf32(x) - x).abs() / x.abs()).max()
    assert 0 < float(rel) <= 2 ** -11


def test_the_control_fails_the_limit_the_reference_passes():
    x = _table(300, 256, 5)
    assert ref.max_abs_err(ref.cosine_a2a_tf32(x), ref.cosine_a2a(x)) > \
        3 * LIMIT
    assert ref.max_abs_err(ref.cosine_a2a(x).float(),
                           ref.cosine_a2a(x)) < LIMIT / 30


def test_max_abs_err_refuses_shape_and_non_finite():
    a = torch.zeros(3, 3)
    assert ref.max_abs_err(a, torch.zeros(3, 4, dtype=torch.float64)) == \
        np.inf
    a[0, 0] = float("nan")
    assert ref.max_abs_err(a, torch.zeros(3, 3, dtype=torch.float64)) == \
        np.inf
