"""Everything a cell is made of, found by name from ``BENCHMARK.json``.

A configuration is the file its entry names; a traffic mix is
``traffic/<name>.json``, the parameters ``chipbench.loop`` offers the
requests by; a problem family is ``problems/<problem>.py`` (the
configuration's ``problem`` key); an end-to-end metric is computed by
``end_to_end/<name>.py`` and a per-layer metric read by
``metrics/<name>.py``.  Adding any of them is adding a file.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

__all__ = ["ROOT", "HERE", "load_benchmark", "cell_spec", "problem",
           "metric_reader", "end_to_end_reader"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_spec(name: str) -> dict:
    """The cell ``name`` with its configuration, traffic and metrics."""
    bench = load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((ROOT / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads(
        (HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    end_to_end = [m for m in bench["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in reported and _applies(m, name)]
    return {"cell": cell, "config": config, "traffic": traffic,
            "end_to_end": end_to_end, "per_layer": per_layer}


def problem(name: str):
    """The module of problem family ``name`` (``problems/<name>.py``)."""
    return importlib.import_module(f"chipbench.problems.{name}")


def _reader(folder: str, name: str):
    # a name may hold dots, so the file is loaded by path
    path = HERE / folder / f"{name}.py"
    mod_name = f"chipbench.{folder}." + name.replace(".", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metric_reader(name: str):
    """``read(ctx) -> float | None`` of per-layer metric ``name``, from
    ``metrics/<name>.py``."""
    return _reader("metrics", name)


def end_to_end_reader(name: str):
    """``read(ctx) -> float`` of end-to-end metric ``name``, from
    ``end_to_end/<name>.py``."""
    return _reader("end_to_end", name)
