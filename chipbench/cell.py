"""One run of one cell: set-up, the measured window, the traced block, and
the check against the plain reference.

A cell runs in this process, on one card.  Set-up plans the
configuration's schema once and warms it; the window offers the cell's
traffic (``chipbench.loop``) for ``seconds``, each request's tables drawn
on the card from ``--seed``; the traced block offers ``trace_requests``
more under ``torch.profiler``; the check compares a seeded sample of the
window's answers with the plain reference once the window has closed.
"""

from __future__ import annotations

import math
import random
import sys
import time

import torch

from chipbench import faults, loop
from chipbench import spec as _spec
from chipbench.reference import max_abs_err
from chipbench.roofline import PEAKS
from chipbench.trace import read_events, top

__all__ = ["BANNED", "banned_modules", "Cell", "run", "result"]

# top-level module names that may not be loaded in a run: JAX and the JAX
# package the port was made from (``repro_torch`` is another name)
BANNED = frozenset({"jax", "jaxlib", "flax", "repro"})
# untimed requests before the window, after the first (cold) one
WARMUP = 3
# requests the profiler records and discards before the traced block's
TRACE_WARMUP = 2


def banned_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & BANNED)


class _Reservoir:
    """``k`` requests drawn uniformly from all requests of the window, by a
    generator seeded from the run's seed (reservoir sampling)."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.n, self.items = k, random.Random(seed), 0, []

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.n + 1)
            if j < self.k:
                self.items[j] = item
        self.n += 1


class Cell:
    """The cell's program on its card: the set-up at construction, then
    measured windows (``window``), a traced block and the check."""

    def __init__(self, spec: dict, seed: int, device_type: str):
        self.start_wall = time.time()
        self.spec = spec
        self.config, self.traffic = spec["config"], spec["traffic"]
        self.cuda = device_type == "cuda"
        self.dev = torch.device("cuda", 0) if self.cuda else \
            torch.device("cpu")
        if self.cuda:
            torch.cuda.set_device(self.dev)
        self.device = loop.Device(self.dev)
        self.prob = prob = _spec.problem(self.config["problem"])
        self.sizes = prob.sizes(self.config)
        if self.cuda:   # build (first run only) and load before the clocks
            from repro_torch.kernels import _build
            _build.load(prob.KERNEL_LIBRARY)
        t0 = time.perf_counter()
        self.schema = prob.plan(self.config, self.sizes)
        self.plan_s = time.perf_counter() - t0
        self.executor = self.traffic["executor"]
        self.call = prob.entry(self.config, self.schema, self.sizes,
                               self.executor)
        self.gen = torch.Generator(device=self.dev)
        # the set-up's tables come from another stream than the window's
        self.gen.manual_seed((seed + 2 ** 63) % 2 ** 64)
        t0 = time.perf_counter()
        _out, self.plan = self.call(self.draw())
        self.device.sync()
        self.first_s = time.perf_counter() - t0
        del _out
        # the traffic's own loop, so that every shape it sends is warm
        t0 = time.perf_counter()
        self._offer(seed, count=WARMUP)
        self.warmup_s = time.perf_counter() - t0

    def use_control(self) -> None:
        """Put the reference, computed one precision down, in the entry's
        place (the control that the check has to fail)."""
        prob = self.prob
        self.call = lambda tables: (prob.control_of(tables).float(), None)

    def draw(self) -> tuple:
        return self.prob.draw(self.config, self.gen, self.dev)

    def _offer(self, seed: int, draw=None, retired=None, **stop) -> dict:
        return loop.offer(self.traffic, seed, draw=draw or self.draw,
                          call=lambda t: self.call(t)[0],
                          device=self.device, retired=retired, **stop)

    def window(self, seed: int, seconds: float) -> tuple:
        """One measured window of requests whose tables are drawn from
        ``seed``: ``(record, sample)``, ``sample`` the requests kept for the
        check as ``(tables, matrix)``."""
        self.gen.manual_seed(seed % 2 ** 64)
        sample = _Reservoir(self.traffic["check_sample"], seed)
        rec = self._offer(seed, seconds=seconds,
                          retired=lambda t, o: sample.offer((t, o)))
        return rec, sample.items

    def check(self, sample: list) -> dict:
        """The largest gap to the reference over ``sample``."""
        errs = [max_abs_err(o, self.prob.reference_of(t)) for t, o in sample]
        return {"sim_max_abs_err": max(errs) if errs else math.inf,
                "compared": len(errs)}

    def violations(self) -> dict:
        return self.prob.violations(self.config, self.sizes, self.schema)

    def per_layer(self, rec: dict) -> dict:
        """Each per-layer metric of the cell, by its reader (None where the
        reader found nothing)."""
        launched = self.prob.launches(self.plan, self.executor)
        ctx = {"config": self.config, "traffic": self.traffic,
               "chips": 1, "schema": self.schema,
               "inputs": self.prob.inputs(self.config),
               "pairs_per_request": self.prob.pairs_per_request(self.config),
               "plan_s": self.plan_s, "first_request_s": self.first_s,
               "latency_s": rec["latency_s"],
               "dispatch_s": rec["dispatch_s"], "window_s": rec["window_s"],
               "trace": rec["trace"],
               "trace_requests": rec["trace_requests"],
               "trace_window_s": rec["trace_window_s"],
               "peaks": PEAKS.get(rec.get("kind")), "launches": launched,
               "work": (self.prob.work(launched, self.config)
                        if launched else None)}
        return {m["name"]: _spec.metric_reader(m["name"])(ctx)
                for m in self.spec["per_layer"]}

    def traced_block(self, seed: int) -> dict:
        """``trace_requests`` requests of the cell's traffic under the
        profiler, after ``TRACE_WARMUP`` it records and discards, their
        tables drawn beforehand."""
        from torch.profiler import ProfilerActivity, profile, schedule
        k = self.traffic["trace_requests"]
        pre = [self.draw() for _ in range(k + TRACE_WARMUP)]
        self.device.sync()
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.cuda else [])
        marks = []

        def retired(_tables, _out):
            marks.append(time.perf_counter())
            prof.step()
        with profile(activities=acts, schedule=schedule(
                wait=0, warmup=TRACE_WARMUP, active=k, repeat=1)) as prof:
            self._offer(seed, draw=pre.pop, retired=retired,
                        count=k + TRACE_WARMUP)
        return {"trace": read_events(prof.events()), "trace_requests": k,
                "trace_window_s": marks[-1] - marks[TRACE_WARMUP - 1]}

    def free(self) -> None:
        """Drop the program's per-plan state before the reference runs."""
        self.plan = self.call = None
        if self.cuda:
            torch.cuda.empty_cache()


def run(spec: dict, seed: int, seconds: float, trace: bool, *,
        device_type: str = "cuda", fault=None, control: bool = False
        ) -> dict:
    """One run of the cell: its record, in plain Python numbers.  A
    ``fault`` of ``chipbench.faults`` is planted under the timed path, or
    with ``control`` the reference one precision down serves in the
    entry's place (both for the tests that show the check fails them)."""
    with faults.planted(fault):
        r = Cell(spec, seed, device_type)
        if control:
            r.use_control()
        rec, sample = r.window(seed, seconds)
        rec["setup_phases"] = {"cell_start_wall": r.start_wall,
                               "plan_s": r.plan_s,
                               "first_request_s": r.first_s,
                               "warmup_s": r.warmup_s}
        if trace:
            rec.update(r.traced_block(seed + 1))
    if r.cuda:
        rec["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(r.dev))
        rec["kind"] = torch.cuda.get_device_name(r.dev)
    if trace:
        rec["per_layer"] = r.per_layer(rec)
    r.free()
    # the check, once the window has closed and the peak has been read
    t0 = time.perf_counter()
    rec.update(r.check(sample))
    del sample
    rec.update(r.violations())
    rec["check_s"] = time.perf_counter() - t0
    rec["banned"] = banned_modules()
    return rec


def _checks(spec: dict, rec: dict) -> dict:
    """Each number compared, beside its limit (the configuration's)."""
    limits = spec["config"]["limits"]
    values = {"sim_max_abs_err": rec["sim_max_abs_err"],
              "uncovered_pairs": rec["uncovered_pairs"],
              "overfull_reducers": rec["overfull_reducers"],
              "failed_requests": rec["failed"]}
    return {k: {"value": v, "limit": limits[k]} for k, v in values.items()}


def result(spec: dict, rec: dict, start_wall: float, trace: bool) -> dict:
    """The run's result line: ``correct``, ``attempted``, ``failed``,
    ``metrics`` (end-to-end, each by its reader, or per-layer when
    traced), ``device``, ``breakdown`` when traced, and ``checks`` last."""
    checks = _checks(spec, rec)
    correct = (all(c["value"] <= c["limit"] for c in checks.values())
               and len(rec["latency_s"]) > 0 and rec["compared"] > 0)
    device = {"platform": "gpu", "kind": rec.get("kind"), "count": 1,
              "memory_peak_bytes": rec.get("memory_peak_bytes", 0)}
    out = {"correct": bool(correct), "attempted": rec["attempted"],
           "failed": rec["failed"]}
    if trace:
        out["metrics"] = {
            m["name"]: {"value": rec["per_layer"][m["name"]],
                        "unit": m["unit"]}
            for m in spec["per_layer"]
            if rec["per_layer"].get(m["name"]) is not None}
        device["busy_s"] = float(rec["trace"]["busy_s"])
        device["window_s"] = float(rec["trace_window_s"])
        out["breakdown"] = {"device_ops": top(rec["trace"]["device_s"]),
                            "idle_gaps": top(rec["trace"]["idle_s"])}
    else:
        prob = _spec.problem(spec["config"]["problem"])
        ctx = {"latency_s": rec["latency_s"], "window_s": rec["window_s"],
               "window_start_wall": rec["window_start_wall"],
               "start_wall": start_wall, "config": spec["config"],
               "traffic": spec["traffic"],
               "pairs_per_request": prob.pairs_per_request(spec["config"])}
        out["metrics"] = {
            m["name"]: {"value": _spec.end_to_end_reader(m["name"])(ctx),
                        "unit": m["unit"]}
            for m in spec["end_to_end"]}
    out["device"] = device
    out["checks"] = checks
    return out
