"""Run one cell of the port's benchmark once and print its result line.

From the root of a checkout, on a machine with a CUDA card::

    python3 -m chipbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (and the device's busy time from the profiler).  The
last line of standard output is one JSON object; the last lines of
standard error give each number the check compared, beside its limit.
Without a card, or with JAX or the JAX package loaded, the run prints no
result and exits with a non-zero code.
"""

from __future__ import annotations

import time

START_WALL = time.time()    # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _finite(v):
    """JSON has no inf or NaN: such a value is written as a string."""
    if isinstance(v, dict):
        return {k: _finite(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_finite(x) for x in v]
    if isinstance(v, float) and not math.isfinite(v):
        return str(v)
    return v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # caches of the kernel toolchains stay at fixed paths in the checkout
    # (the port's own libraries build into build/repro_torch there)
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "extensions")
    sys.path.insert(0, str(ROOT / "src"))

    import torch

    from chipbench import cell, spec
    s = spec.cell_spec(args.workload)
    chips = s["cell"]["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"chipbench: {args.workload} needs {chips} CUDA device(s), "
              f"found {found}", file=sys.stderr)
        return 2
    if chips != 1:
        print(f"chipbench: {args.workload} asks for {chips} cards; this "
              f"harness runs cells on one", file=sys.stderr)
        return 2
    r = cell.run(s, args.seed, args.seconds, bool(args.trace))
    banned = sorted(set(cell.banned_modules()) | set(r["banned"]))
    if banned:
        print(f"chipbench: modules loaded that a run may not load: "
              f"{banned}", file=sys.stderr)
        return 3
    res = _finite(cell.result(s, r, START_WALL, bool(args.trace)))
    ph = r["setup_phases"]
    print(f"set-up: start to the cell {ph['cell_start_wall'] - START_WALL:.3f}"
          f" s, plan {ph['plan_s']:.3f} s, first request "
          f"{ph['first_request_s']:.3f} s, warm-up {ph['warmup_s']:.3f} s, "
          f"to the window {r['window_start_wall'] - START_WALL:.3f} s; "
          f"{r['attempted']} requests in {r['window_s']:.3f} s, check "
          f"{r['check_s']:.3f} s", file=sys.stderr)
    for err in r["errors"]:
        print(f"first failed request:\n{err}", file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
