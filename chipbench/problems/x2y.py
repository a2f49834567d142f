"""X2Y similarity of two tables through a schema planned once.

The paper's X2Y problem (arXiv:1507.04461, Section 10): each input of a
list X meets each input of another list Y at a reducer of capacity q.  The
entry is the port's library call
``repro_torch.mapreduce.allpairs.x2y_similarity`` on the schema the set-up
planned (``plan_x2y``); the reference is ``chipbench.reference_x2y``.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from chipbench import reference_x2y
from chipbench.sizes import draw_sizes

# the library the entry's kernel lives in, loaded (and built on a first
# run) before anything is timed
KERNEL_LIBRARY = "fused_gather_gram_rect"


def sizes(config: dict) -> dict:
    """The X and Y sizes: each draw of ``sizes`` names its ``side``."""
    drawn = draw_sizes(config["sizes"], config["profile_seed"])
    by_side = {s["side"]: w for s, w in zip(config["sizes"], drawn)}
    return {"wx": by_side["x"], "wy": by_side["y"]}


def inputs(config: dict) -> int:
    return config["mx"] + config["my"]


def pairs_per_request(config: dict) -> int:
    return config["mx"] * config["my"]


def plan(config: dict, sz: dict):
    from repro_torch.core import plan_x2y
    return plan_x2y(sz["wx"], sz["wy"], config["q"])


def draw(config: dict, gen: torch.Generator, device) -> tuple:
    return tuple(torch.randn((config[m], config["d"]), generator=gen,
                             device=device, dtype=torch.float32)
                 for m in ("mx", "my"))


def entry(config: dict, schema, sz: dict, executor: str):
    """``tables -> (matrix, plan)`` through the port's entry."""
    from repro_torch.mapreduce import allpairs

    def call(tables):
        x, y = tables
        sims, plan_, _ = allpairs.x2y_similarity(
            x, y, q=config["q"], wx=sz["wx"], wy=sz["wy"], schema=schema,
            metric=config["metric"], executor=executor, device=x.device)
        return sims, plan_
    return call


def reference_of(tables) -> torch.Tensor:
    return reference_x2y.cosine_x2y(*tables)


def control_of(tables) -> torch.Tensor:
    return reference_x2y.cosine_x2y_tf32(*tables)


def violations(config: dict, sz: dict, schema) -> dict:
    return reference_x2y.x2y_violations(
        schema.bins, schema.reducers, sz["wx"], sz["wy"], config["q"],
        config["capacity_slack"])


def launches(plan_, executor: str) -> list:
    """The Gram launches of one request, as buckets for
    ``chipbench.roofline_x2y.rect_bucket_work``: one per rect bucket
    (fused; no other executor is measured on this problem)."""
    if executor != "fused":
        return []
    return [SimpleNamespace(mask=b.mask, ymask=b.ymask, R=b.R,
                            width=b.width, ywidth=b.ywidth)
            for b in plan_.buckets]


def work(launched: list, config: dict) -> dict:
    from chipbench.roofline_x2y import rect_work
    return rect_work(launched, inputs(config), config["d"], 4)
