"""One-shot observability report: render the obs layer's current state.

Pulls the four obs surfaces (DESIGN.md 1j) into a single human-readable
report — or one JSON document with ``--json``:

* metrics registry snapshot (counters / gauges / histogram summaries),
* comm-ledger reconciliation per (executor, workload) plus any anomalies,
* structured event counts and the most recent events,
* the span totals per name (count, host and self host seconds) and the
  span ring, exportable as Chrome trace JSON (``--trace out.json``,
  loadable in Perfetto / chrome://tracing; a device-timed span carries its
  ``device_ms``),
* the share of fused buckets whose metric was finished in the Gram
  kernel's epilogue rather than in torch (counter ``fused.finish``).

``--demo`` first runs a small :class:`repro_torch.serve.PairwiseService`
workload (pairs + x2y on the fused executor) so the report has something
to show, on ``--device`` (default: the card; ``--device cpu`` runs the
kernels' plain versions).  Port of ``repro.launch.obs_report``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.obs_report --demo
    PYTHONPATH=src python -m repro_torch.launch.obs_report --json
    PYTHONPATH=src python -m repro_torch.launch.obs_report --demo \
        --device cpu --trace t.json
"""

from __future__ import annotations

import argparse
import json

from repro_torch.obs import EVENTS, LEDGER, REGISTRY, TRACER


def finish_share() -> dict:
    """Fused buckets finished in the Gram kernel's epilogue and in torch,
    and the kernel's share (None before any)."""
    kernel = REGISTRY.counter_total("fused.finish", where="kernel")
    torch_ = REGISTRY.counter_total("fused.finish", where="torch")
    total = kernel + torch_
    return {"kernel": kernel, "torch": torch_,
            "kernel_share": kernel / total if total else None}


def gather(events_tail: int = 10) -> dict:
    """The full obs state as one JSON-ready document."""
    return {
        "fused_finish": finish_share(),
        "metrics": REGISTRY.snapshot(),
        "ledger": {
            "records": LEDGER.seq,
            "summary": LEDGER.summary(),
            "anomalies": [r.summary() for r in LEDGER.records()
                          if r.anomaly],
        },
        "events": {
            "counts": EVENTS.counts(),
            "tail": EVENTS.events(last=events_tail),
        },
        "trace": {"spans": len(TRACER.spans()), "totals": TRACER.totals()},
    }


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return f"{n:.1f} GiB"


def render(doc: dict) -> str:
    """Plain-text rendering of a :func:`gather` document."""
    lines = ["== obs report =="]

    lines.append("\n-- counters --")
    for k, v in doc["metrics"]["counters"].items():
        if v:
            lines.append(f"  {k} = {v}")
    lines.append("\n-- gauges --")
    for k, v in doc["metrics"]["gauges"].items():
        lines.append(f"  {k} = {v:g}")
    lines.append("\n-- histograms --")
    for k, h in doc["metrics"]["histograms"].items():
        if h["count"]:
            lines.append(
                f"  {k}: n={h['count']} mean={h['mean']:.4g} "
                f"p50={h['p50']:.4g} p90={h['p90']:.4g} "
                f"p99={h['p99']:.4g} max={h['max']:.4g}")

    fin = doc["fused_finish"]
    if fin["kernel_share"] is not None:
        lines.append("\n-- fused metric finish --")
        lines.append(f"  in the kernel: {fin['kernel']:g} of "
                     f"{fin['kernel'] + fin['torch']:g} buckets "
                     f"({100 * fin['kernel_share']:.1f}%)")

    lines.append("\n-- comm ledger --")
    led = doc["ledger"]
    lines.append(f"  records: {led['records']}")
    for key, agg in led["summary"].items():
        lines.append(
            f"  {key}: n={agg['records']} anomalies={agg['anomalies']} "
            f"gathered={_fmt_bytes(agg['gathered_bytes'])} "
            f"assembled={_fmt_bytes(agg['assembled_bytes'])} "
            f"ratio=[{agg['measured_over_predicted_min']:.3f}, "
            f"{agg['measured_over_predicted_max']:.3f}]")
    for rec in led["anomalies"]:
        lines.append(f"  ANOMALY {rec['executor']}/{rec['workload']}: "
                     f"measured/predicted="
                     f"{rec['measured_over_predicted']:.3f} "
                     f"(expected ~{rec['replication']:.3f})")

    lines.append("\n-- events --")
    for kind, n in sorted(doc["events"]["counts"].items()):
        lines.append(f"  {kind}: {n}")
    for ev in doc["events"]["tail"]:
        extras = {k: v for k, v in ev.items()
                  if k not in ("seq", "ts", "kind")}
        lines.append(f"  [{ev['seq']}] {ev['kind']} {extras}")

    lines.append(f"\n-- trace --\n  spans buffered: {doc['trace']['spans']}"
                 "  (export with --trace out.json)")
    for name, t in sorted(doc["trace"]["totals"].items(),
                          key=lambda kv: -kv[1]["host_s"]):
        lines.append(f"  {name}: n={t['count']} host={t['host_s']:.4g}s "
                     f"self={t['self_s']:.4g}s")
    return "\n".join(lines)


def run_demo(device=None) -> None:
    """Tiny fused-executor serving workload so the report is non-empty
    (``device=None``: the card)."""
    import numpy as np

    from repro_torch.serve import PairwiseService

    rng = np.random.RandomState(0)
    x = rng.randn(48, 16).astype(np.float32)
    # skewed sizes, clipped so any two inputs still fit one reducer (q=6)
    w = np.minimum(rng.zipf(2.0, 48), 3).astype(np.float64)
    svc = PairwiseService(q=6, executor="fused", tenant="demo",
                          device=device)
    svc.similarity(x, weights=w)
    svc.x2y(x, x[:16])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON document instead of text")
    ap.add_argument("--demo", action="store_true",
                    help="run a small serving workload first")
    ap.add_argument("--trace", metavar="PATH",
                    help="also export the span ring as Chrome trace JSON")
    ap.add_argument("--events-tail", type=int, default=10,
                    help="number of recent events to include")
    ap.add_argument("--device", default=None,
                    help="device of the demo (default: the card)")
    args = ap.parse_args(argv)

    if args.demo:
        run_demo(args.device)
    doc = gather(events_tail=args.events_tail)
    if args.trace:
        TRACER.export_chrome_trace(args.trace)
        doc["trace"]["exported_to"] = args.trace
    print(json.dumps(doc, indent=2, default=str) if args.json
          else render(doc))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
