"""All-pairs (A2A) similarity of one table through a schema planned once.

The paper's A2A problem (arXiv:1507.04461): every pair of distinct inputs
meets at a reducer of capacity q.  The entry is the port's library call
``repro_torch.mapreduce.allpairs.pairwise_similarity`` on the schema the
set-up planned; the reference is ``chipbench.reference``.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from chipbench import reference
from chipbench.sizes import draw_sizes

# the library the entry's kernel lives in, loaded (and built on a first
# run) before anything is timed
KERNEL_LIBRARY = "fused_gather_gram"


def sizes(config: dict) -> dict:
    (w,) = draw_sizes(config["sizes"], config["profile_seed"])
    return {"w": w}


def inputs(config: dict) -> int:
    return config["m"]


def pairs_per_request(config: dict) -> int:
    m = config["m"]
    return m * (m - 1) // 2


def plan(config: dict, sz: dict):
    from repro_torch.core import plan_a2a
    return plan_a2a(sz["w"], config["q"])


def draw(config: dict, gen: torch.Generator, device) -> tuple:
    return (torch.randn((config["m"], config["d"]), generator=gen,
                        device=device, dtype=torch.float32),)


def entry(config: dict, schema, sz: dict, executor: str):
    """``tables -> (matrix, plan)`` through the port's entry."""
    from repro_torch.mapreduce import allpairs

    def call(tables):
        (x,) = tables
        sims, plan_, _ = allpairs.pairwise_similarity(
            x, q=config["q"], weights=sz["w"], schema=schema,
            metric=config["metric"], executor=executor, device=x.device)
        return sims, plan_
    return call


def reference_of(tables) -> torch.Tensor:
    return reference.cosine_a2a(*tables)


def control_of(tables) -> torch.Tensor:
    return reference.cosine_a2a_tf32(*tables)


def violations(config: dict, sz: dict, schema) -> dict:
    return reference.a2a_violations(schema.bins, schema.reducers, sz["w"],
                                    config["q"], config["capacity_slack"])


def launches(plan_, executor: str) -> list:
    """The Gram launches of one request, as buckets for
    ``chipbench.roofline.bucket_work``: one per capacity bucket (fused; no
    other executor is measured on this problem yet)."""
    if executor != "fused":
        return []
    return [SimpleNamespace(mask=b.mask, R=b.R, width=b.width)
            for b in plan_.buckets]


def work(launched: list, config: dict) -> dict:
    from chipbench.roofline import work_model
    return work_model(launched, config["m"], config["d"], 4)
