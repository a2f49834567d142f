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

With ``--lm`` it runs ``chip_smoke.py`` phase 24 (b)-(c) instead, on a
(2, cards / 2) ('data', 'model') DeviceMesh over NCCL, one rank per card:
the Jamba prefill cut to 3 layers (each flash and SSD launch against its
plain version on the rank's local heads, each rank's block of the logits
against card 0's one-rank bf16 and fp32 logits), stablelm-1.6b trained 5
steps with the reference's train flags (ZeRO-1) against the one-rank
losses, and one FSDP step of two smoke configs against one rank's.

Run from the repository root on a host with two or more cards::

    python3 tools/nccl_ranks.py [--lm] [--out FILE]
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
    ap.add_argument("--lm", action="store_true",
                    help="phase 24 (b)-(c) on a 2 x (cards / 2) mesh")
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
    if args.lm:
        return lm(card, args.out)
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


def lm(card: dict, out_path) -> int:
    """Phase 24 (b)-(c) over NCCL, one rank per card."""
    import tempfile
    n = torch.cuda.device_count()
    if n % 2:
        print("nccl_ranks --lm: needs an even number of cards",
              file=sys.stderr)
        return 2
    cs._build.build_all(("flash_attention", "ssd_scan"), force=True)
    want, one_ms = cs.one_rank_logits()
    one_train = cs.one_rank_train_losses()
    smoke = cs.one_rank_smoke_steps()
    root = Path(__file__).resolve().parents[1] / "build"
    root.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root) as d:
        paths = [str(Path(d) / f"logits_{i}.pt") for i in (0, 1)]
        for t, path in zip(want, paths):
            torch.save(t, path)
        del want
        ranks = cs.compat.run_local_group(
            cs.lm_mesh_rank, n, (2, n // 2), paths, one_train["losses"],
            smoke, backend="nccl", timeout_s=cs.GROUP_TIMEOUT_S * 4)
    for r in ranks:
        p, t = r["prefill"], r["train"]
        cs.log(f"rank {r['rank']} (2 x {n // 2} nccl): prefill "
               f"{p['ms']:.1f} ms (one card, no mesh {one_ms:.1f} ms), "
               f"launches {p['launches']}, kernel ms {p['kernel_ms']}, errs "
               f"{p['errs']}, logits {r['logits']}; collectives "
               f"{p['collectives']['calls']} calls, bytes "
               f"{p['collectives']['bytes']}; train {t['flags']} losses "
               f"{t['losses']} (one card {one_train['losses']}), step ms "
               f"{[round(x, 1) for x in t['step_ms']]} (one card "
               f"{[round(x, 1) for x in one_train['step_ms']]}), "
               f"{t['tokens_per_s']:.0f} tokens/s, peak "
               f"{t['peak_alloc_bytes'] / 1e9:.2f} GB; smoke {r['smoke']}")
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(json.dumps(
            {"card": card, "one_rank_train": one_train, "ranks": ranks},
            indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
