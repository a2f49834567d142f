"""BENCHMARK.json against the benchmark's contract, and every part of each
cell found by name."""

import json
import re

import pytest

from chipbench import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["chipbench"]
    assert 1 <= len(BENCH["command"]) <= 32
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_a_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_lines():
    named = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
             + BENCH["per_layer"])
    for entry in named:
        assert NAME.match(entry["name"]), entry["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([c["source"] for c in BENCH["configs"]]
                 + [e["why"] for e in BENCH["configs"] + BENCH["workloads"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group


def test_end_to_end_bounds_and_sources():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert {"pairs_per_s", "request_p95_ms", "setup_s"} <= names
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_per_layer_metrics_move_a_reported_metric():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m["workloads"]) <= set(CELLS)


def test_four_chip_cells_within_the_allowance():
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    assert len(four) <= max(1, len(CELLS) // 4)


def test_each_config_used_by_a_cell_and_its_file_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("chipbench/")
        data = json.loads((spec.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"]
        # a cut of scale, named in the file; never a width
        assert set(c["reduced"]) <= set(data["cut"])
        assert not set(c["reduced"]) & {"d", "q", "sizes", "metric",
                                        "dtype"}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_parts_found_by_name(cell):
    s = spec.cell_spec(cell)
    prob = spec.problem(s["config"]["problem"])
    for fn in ("sizes", "plan", "draw", "entry", "reference_of",
               "control_of", "violations", "launches", "work",
               "pairs_per_request", "inputs"):
        assert callable(getattr(prob, fn))
    assert s["traffic"]["name"] == s["cell"]["traffic"]
    assert [m["name"] for m in s["end_to_end"]] == [
        m["name"] for m in BENCH["end_to_end"]]
    for m in s["end_to_end"]:
        assert callable(spec.end_to_end_reader(m["name"]))
    assert s["per_layer"]
    for m in s["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
    assert s["config"]["limits"]["uncovered_pairs"] == 0


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.cell_spec("no-such-cell")


def test_every_traffic_and_config_file_is_well_formed():
    for path in (spec.HERE / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        assert t["name"] == path.stem and t["executor"]
        assert t["arrival"] in ("closed", "open") and t["in_flight"] >= 1
        assert t["arrival"] == "closed" or t["rate_per_s"] > 0
    for path in (spec.HERE / "configs").glob("*.json"):
        c = json.loads(path.read_text())
        assert c["name"] == path.stem
        assert spec.problem(c["problem"]).sizes(c)
