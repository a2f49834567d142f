"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have, and so does the control put in the
program's place; a sound run is correct, and the control's readings lie
on either side of the limit.  At a size a test run holds, and (``gpu``)
at the cell's own size on a card."""

import pytest

from chipbench import cell, control, spec
from chipbench._small import A2A, small_spec

SEED = 2 ** 33 + 17
TRAFFIC = {"refresh": {}, "inflight2": {"in_flight": 2},
           "open": {"arrival": "open", "rate_per_s": 200.0, "in_flight": 3}}


def _result(s, fault=None, control=False, seconds=0.3, device_type="cpu"):
    rec = cell.run(s, SEED, seconds, False, device_type=device_type,
                   fault=fault, control=control)
    return cell.result(s, rec, 0.0, False)


@pytest.mark.parametrize("traffic", sorted(TRAFFIC))
def test_a_sound_run_is_correct(traffic):
    res = _result(small_spec(**TRAFFIC[traffic]))
    assert res["correct"] is True
    assert res["checks"]["sim_max_abs_err"]["value"] < 1e-6


@pytest.mark.parametrize("traffic", ["refresh", "inflight2"])
@pytest.mark.parametrize("fault", ["stale", "half_batch", "one_answer"])
def test_a_fault_is_not_correct(fault, traffic):
    res = _result(small_spec(**TRAFFIC[traffic]), fault)
    assert res["correct"] is False
    assert res["checks"]["sim_max_abs_err"]["value"] > \
        res["checks"]["sim_max_abs_err"]["limit"]


def test_the_control_in_the_programs_place_is_not_correct():
    res = _result(small_spec(d=256), control=True)
    assert res["correct"] is False
    assert res["checks"]["sim_max_abs_err"]["value"] > \
        3 * res["checks"]["sim_max_abs_err"]["limit"]


def test_control_readings_lie_either_side_of_the_limit():
    s = small_spec(d=256)
    limit = s["config"]["limits"]["sim_max_abs_err"]
    got = control.readings(s, [1, 2, 3], [4, 5, 6], 0.2, "cpu")
    lower = max(r["sim_max_abs_err"] for r in got["program"].values())
    upper = min(r["sim_max_abs_err"] for r in got["control"].values())
    assert lower < limit < upper and upper > 3 * lower
    assert got["violations"] == {"uncovered_pairs": 0,
                                 "overfull_reducers": 0}


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      spec.load_benchmark()["workloads"]])
def test_on_the_card_at_the_cells_size_the_control_is_not_correct(
        card, workload):
    s = spec.cell_spec(workload)
    assert _result(s, seconds=1.0, device_type=card)["correct"] is True
    res = _result(s, control=True, seconds=1.0, device_type=card)
    assert res["correct"] is False


@pytest.mark.gpu
def test_control_readings_on_the_card_at_the_cells_size(card):
    s = spec.cell_spec(A2A)
    limit = s["config"]["limits"]["sim_max_abs_err"]
    got = control.readings(s, [11, 12, 13], [14, 15, 16], 1.0, card)
    lower = max(r["sim_max_abs_err"] for r in got["program"].values())
    upper = min(r["sim_max_abs_err"] for r in got["control"].values())
    assert lower < limit < upper
