"""Sharded and coded execution over NCCL, one rank per card.

``chip_smoke.py`` phase 20 spawns 4 gloo ranks that share one card, since
NCCL refuses two ranks on one GPU.  This script runs the same rank program
(``chip_smoke.rank_paths``) with one NCCL rank per visible card, so the
collectives move device tensors between cards: sharded A2A on an m=2048
table of the main path's profile (d=256), coded (r=2) A2A on an m=1024
one, and sharded X2Y on the skew profile (8192 x 512), every rank's matrices against this
process's fused ones, every kernel launch against its plain version, the
coded ledger against the all-to-all's bytes, and no rank running nvcc.
It prints each rank's kernel ms, collective ms and host seconds, and the
cards' names and power limits.

Run from the repository root on a host with two or more cards::

    python3 tools/nccl_ranks.py [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every measured number here")
    args = ap.parse_args()
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("nccl_ranks: needs two or more CUDA devices", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.phase_device()
    card["all"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    cs.log(f"cards: {card['all']}")
    cs._build.build_all(("fused_gather_gram", "fused_gather_gram_rect"),
                        force=True)
    skew = cs.x2y_host("skew")
    res = cs.phase_ranks(skew, backend="nccl",
                         ranks=torch.cuda.device_count())
    for path, kernel in (("sharded_a2a", "fused_gather_gram"),
                         ("coded_a2a", "fused_gather_gram_rect"),
                         ("sharded_x2y", "fused_gather_gram_rect")):
        cs.log(f"{path}: {json.dumps(cs.ranks_record(res, path, kernel))}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card, **res},
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
