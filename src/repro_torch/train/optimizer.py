"""AdamW with a cosine schedule, global-norm clipping and a configurable
moment dtype (port of ``repro.train.optimizer``).

Plain functions on dicts of tensors keyed by parameter name.  The math is
fp32 (the learning rate and the bias corrections too); moments are kept in
``moment_dtype`` and parameters cast back to their own dtype.
:func:`adamw_update` writes the new parameters and moments INTO the
tensors it is given (the reference returns new trees): a 1.6 B-parameter
state then never exists twice on the card.

Weight decay follows the reference's rule, a leaf of rank >= 2, applied to
the rank of the parameter's leaf in the REFERENCE's tree when ``ranks``
gives it (``models.reference_ranks``): the reference stacks scanned
layers along a leading axis, so their norm gammas and Mamba vectors are
decayed there while the same vectors in the tail are not.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..parallel.local import is_dtensor

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_lr",
           "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"    # 'float32' | 'bfloat16'


def cosine_lr(step, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warm-up to ``peak_lr``, then a cosine down to ``min_lr_ratio``
    of it; fp32, on ``step``'s device."""
    step = torch.as_tensor(step)
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.peak_lr * warm * (cfg.min_lr_ratio
                                 + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32.  DTensor leaves
    (one mesh) give the norm of the whole tensors: each rank sums the
    squares of its own shards, each shard's sum divided by the number of
    ranks holding a copy of it, and one all-reduce adds the ranks' sums
    (a plain tensor)."""
    leaves = list(tree.values())
    if not (leaves and is_dtensor(leaves[0])):
        return torch.sqrt(torch.stack([x.float().square().sum()
                                       for x in leaves]).sum())
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = leaves[0].device_mesh
    total = None
    for x in leaves:
        pl = [Replicate() if isinstance(p, Partial) else p
              for p in x.placements]
        if pl != list(x.placements):
            x = x.redistribute(mesh, pl)
        copies = 1
        for i, p in enumerate(pl):
            if isinstance(p, Replicate):
                copies *= mesh.size(i)
        part = x.to_local().float().square().sum() / copies
        total = part if total is None else total + part
    total = DTensor.from_local(total, mesh, [Partial()] * mesh.ndim,
                               run_check=False)
    return torch.sqrt(total.full_tensor())


def adamw_init(params: dict, cfg: AdamWConfig) -> dict:
    dt = getattr(torch, cfg.moment_dtype)
    return {"m": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
                  for k, p in params.items()},
            "v": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
                  for k, p in params.items()}}


@torch.no_grad()
def adamw_update(grads: dict, opt: dict, params: dict, step,
                 cfg: AdamWConfig, ranks: Optional[dict] = None):
    """One AdamW step at ``step`` (0-based).  Writes the new parameters
    into ``params`` and the new moments into ``opt`` and returns
    ``(params, opt, {'grad_norm', 'lr'})``; the grad norm is the one before
    clipping.  ``ranks`` maps a name to the rank that decides its decay
    (``>= 2`` decays); a name it lacks uses its tensor's own rank."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = torch.as_tensor(step, device=gnorm.device)
    lr = cosine_lr(step, cfg)
    t = (step + 1).to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                     device=t.device), t)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                     device=t.device), t)
    ranks = ranks or {}
    for k, p in params.items():
        m, v = opt["m"][k], opt["v"][k]
        g = grads[k].float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        upd = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        if ranks.get(k, p.dim()) >= 2:   # decoupled decay, matrices only
            upd = upd + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * upd)
        m.copy_(m32)
        v.copy_(v32)
    return params, opt, {"grad_norm": gnorm, "lr": lr}
