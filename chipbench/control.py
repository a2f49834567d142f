"""The readings a cell's check limits are set from, in one process.

For each of ``--seeds`` the port serves a short window of the cell's own
traffic and the check compares a sample of its answers with the plain
reference (the lower readings); then for each of ``--control-seeds`` the
reference computed one precision down (TF32 for the configuration's
float32) serves in the port's place, and is compared the same way (the
upper readings).  The benchmark's own runs never run this.  From the root
of a checkout, on a card::

    python3 -m chipbench.control --workload <name> --seeds 1,2,3 \\
        --control-seeds 4,5,6 --seconds 2 [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(spec: dict, seeds: list, control_seeds: list,
             seconds: float, device_type: str) -> dict:
    """The check's readings, ``{"program": {seed: reading}, "control":
    {seed: reading}, "violations": ...}``, from one set-up."""
    from chipbench.cell import Cell
    r = Cell(spec, seeds[0], device_type)
    out = {"program": {}, "control": {}}
    for key, run_seeds in (("program", seeds), ("control", control_seeds)):
        if key == "control":
            r.use_control()
        for s in run_seeds:
            rec, sample = r.window(s, seconds)
            out[key][s] = {**r.check(sample), "failed": rec["failed"],
                           "requests": len(rec["latency_s"])}
            del sample
    out["violations"] = r.violations()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from chipbench import spec
    s = spec.cell_spec(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < s["cell"]["chips"]:
        print("chipbench.control: not enough CUDA devices", file=sys.stderr)
        return 2
    seeds = [int(v) for v in args.seeds.split(",")]
    control_seeds = [int(v) for v in args.control_seeds.split(",")]
    got = readings(s, seeds, control_seeds, args.seconds, "cuda")
    res = {"workload": args.workload, "device": torch.cuda.get_device_name(0),
           "readings": got}
    for key in ("program", "control"):
        errs = [got[key][sd]["sim_max_abs_err"] for sd in got[key]]
        res[key] = {"max": max(errs), "min": min(errs), "each": errs}
        print(f"{args.workload} {key}: sim_max_abs_err over "
              f"{len(errs)} seeds: min {min(errs)!r}, max {max(errs)!r}")
    print(f"{args.workload} violations: {got['violations']}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
