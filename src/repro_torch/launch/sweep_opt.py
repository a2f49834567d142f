"""Optimized-config sweep (port of ``repro.launch.sweep_opt``): every LM
dry-run cell with the beyond-paper optimizations (chunked SSD and bf16
attention probabilities are flags; the grouped MoE dispatch and the fused
norm VJP are code defaults).  Results tagged ``__opt`` under
``build/dryrun_lm/``.

    python -m repro_torch.launch.sweep_opt
"""

from __future__ import annotations

from ..configs.base import SHAPES, list_archs
from .dryrun import run_cell

__all__ = ["OVERRIDES", "main"]

OVERRIDES = {"ssd_impl": "chunked", "attn_probs_dtype": "bfloat16"}


def main() -> int:
    for arch in list_archs():
        for shape in SHAPES:
            for mp in (False, True):
                rec = run_cell(arch, shape, mp, skip_existing=True,
                               opt_overrides=OVERRIDES, tag="__opt")
                status = rec.get("status")
                line = (f"[{status:7s}] {arch:28s} {shape:12s} "
                        f"{'multipod' if mp else 'pod':8s} "
                        f"t={rec.get('step_s', 0):6.1f}s")
                if status == "ok":
                    line += (f" frac={rec['roofline_fraction']:.3f}"
                             f" frac_res="
                             f"{rec['roofline_fraction_kernel_resident']:.3f}")
                elif status == "error":
                    line += " " + rec["error"][:100]
                print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
