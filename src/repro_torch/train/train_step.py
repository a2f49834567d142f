"""Train step: loss -> grads -> AdamW, with microbatching and gradient
compression (port of ``repro.train.train_step``).

A state is ``{'params': {name: Parameter}, 'opt': {'m', 'v'}, 'step':
int32 scalar}`` whose ``params`` are the model's own parameters: the step
updates them, and the moments, in place.

On a mesh (a model put there by ``models.distribute_model``) the
parameters and moments are DTensors placed by
:func:`make_state_shardings`: the parameters by their logical axes, the
moments also split over the data axes (ZeRO-1, :func:`_zero1_spec`) when
``zero1``.  The gradients come back from the backward as partial sums
over the data axes and are redistributed to the moments' placements (a
reduce-scatter under ZeRO-1, else an all-reduce); AdamW updates the
shards, and the parameters are gathered back to their own placements.
The grad norm and int8 compression's max are over whole reference leaves,
and the step's metrics are plain tensors, as on one rank.

The forward and the backward both run with TF32 off (``ieee_fp32``): the
forward's products turn it off inside their own ``with`` blocks, but
autograd runs the backward outside them, where cuDNN's default would run
an fp32 convolution's backward in TF32.
"""

from __future__ import annotations

import torch

from ..kernels.pairwise.fused_gather_gram import ieee_fp32
from ..launch.mesh import mesh_axis_sizes
from ..models.lm import LMModel, reference_paths, reference_ranks
from ..parallel.local import DATA_AXES, implicit_replication, whole, \
    zeros_placed
from ..parallel.sharding import logical_to_spec, placements
from .optimizer import AdamWConfig, adamw_init, adamw_update

__all__ = ["TrainState", "init_state", "make_train_step",
           "make_state_shardings", "batch_sharding"]

TrainState = dict  # {'params': ..., 'opt': {'m','v'}, 'step': ()}


def init_state(model: LMModel, opt_cfg: AdamWConfig) -> TrainState:
    """The model's own weights (drawn by ``build_model(..., seed=...)`` or
    loaded), made trainable and paired with zero moments at step 0.  The
    reference's ``init_state(model, key, opt_cfg)`` draws the weights
    here; the port's model already holds them.  On a mesh the moments are
    placed by :func:`make_state_shardings` (``flags.zero1``); the step is
    a plain scalar, the same on every rank."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    mesh = model.mesh
    if mesh is None:
        opt = adamw_init(params, opt_cfg)
    else:
        sh = make_state_shardings(model, mesh, model.rules,
                                  zero1=model.flags.zero1)
        dt = getattr(torch, opt_cfg.moment_dtype)
        opt = {k: {n: zeros_placed(p.shape, dt, model.device, mesh,
                                   sh["opt"][k][n])
                   for n, p in params.items()} for k in ("m", "v")}
    return {"params": params, "opt": opt,
            "step": torch.zeros((), dtype=torch.int32, device=model.device)}


# ---------------------------------------------------------------- shardings

def _zero1_spec(spec: tuple, shape, mesh, data_axes) -> tuple:
    """Extend a param spec by sharding the largest unsharded dim over the
    data axes (ZeRO-1 for optimizer moments)."""
    sizes = mesh_axis_sizes(mesh)
    n_data = 1
    for a in data_axes:
        n_data *= sizes[a]
    used = set()
    for s in spec:
        if s is None:
            continue
        for a in (s if isinstance(s, tuple) else (s,)):
            used.add(a)
    if any(a in used for a in data_axes):
        return spec  # already data-sharded (fsdp)
    best, best_dim = -1, -1
    for i, (s, dim) in enumerate(zip(spec, shape)):
        if s is None and dim % n_data == 0 and dim > best_dim:
            best, best_dim = i, dim
    if best < 0:
        return spec
    new = list(spec)
    new[best] = tuple(data_axes) if len(data_axes) > 1 else data_axes[0]
    return tuple(new)


def _data_axes(mesh) -> tuple:
    return tuple(a for a in DATA_AXES if a in mesh.mesh_dim_names)


def make_state_shardings(model: LMModel, mesh, rules, zero1: bool = True):
    """The placements tree of a train state on ``mesh``: ``params`` by each
    parameter's logical axes, ``opt`` ``m`` / ``v`` the same or, with
    ``zero1``, also split over the data axes on the largest dim they
    divide (:func:`_zero1_spec`), ``step`` replicated."""
    axes = model.param_logical_axes()
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    specs = {n: logical_to_spec(rules, axes[n]) for n in shapes}
    data_axes = _data_axes(mesh)
    opt_specs = {n: _zero1_spec(s, shapes[n], mesh, data_axes)
                 for n, s in specs.items()} if zero1 and data_axes \
        else specs
    opt = {n: placements(mesh, s) for n, s in opt_specs.items()}
    return {"params": {n: placements(mesh, s) for n, s in specs.items()},
            "opt": {"m": opt, "v": dict(opt)},
            "step": placements(mesh, ())}


def batch_sharding(mesh, batch_tree: dict) -> dict:
    """Placements of every batch leaf: dim 0 split over the data axes."""
    data_axes = _data_axes(mesh)
    spec = (data_axes if len(data_axes) > 1 else
            (data_axes[0] if data_axes else None),)
    return {k: placements(mesh, spec) for k in batch_tree}


def _compress(g: torch.Tensor, mode: str, amax=None) -> torch.Tensor:
    """The reference's gradient compression of one tensor; ``amax`` is the
    int8 scale's tensor-wide max |g| when ``g`` is one slice of a larger
    tensor (its own max when ``None``)."""
    if mode == "bf16":
        return g.to(torch.bfloat16).float()
    if mode == "int8":
        # per-tensor symmetric int8 (no error feedback, as in the reference)
        if amax is None:
            amax = g.abs().max()
        amax = torch.clamp(amax, min=1e-9)
        q = torch.round(g / amax * 127.0).to(torch.int8)
        return q.float() * (amax / 127.0)
    if mode == "none":
        return g
    raise ValueError(f"grad_compression {mode!r}: want 'none', 'bf16' or "
                     f"'int8'")


def _compress_all(grads: dict, mode: str, paths: dict) -> dict:
    """:func:`_compress` over every gradient, the int8 scale taken per
    REFERENCE leaf: the reference quantizes a scanned layer's gradient
    with one scale over the whole stacked leaf (every repetition of the
    pattern), so the port's per-layer tensors share their leaf's max (over
    every rank's shard on a mesh)."""
    amax: dict = {}
    if mode == "int8":
        for k, g in grads.items():
            m = whole(g.abs().max())
            path = paths[k][0]
            amax[path] = m if path not in amax else torch.maximum(
                amax[path], m)
    return {k: _compress(g, mode, amax.get(paths[k][0]))
            for k, g in grads.items()}


def _on(batch: dict, device) -> dict:
    """The batch's arrays as tensors on ``device`` (``segments`` dropped:
    the loss reads ``tokens``, ``targets`` and ``mask``)."""
    return {k: torch.as_tensor(v, device=device)
            for k, v in batch.items() if k != "segments"}


def make_train_step(model: LMModel, opt_cfg: AdamWConfig, *,
                    microbatch: int = 1):
    """Returns ``step(state, batch) -> (state, metrics)``, which runs on
    the model's device (CUDA unless the model was built on the CPU).

    ``microbatch > 1`` splits the batch into that many chunks and
    accumulates their gradients in fp32 buffers, divided by ``microbatch``
    (the reference's ``lax.scan``); the loss and the metrics are the means
    over the chunks.  Metrics: ``ce``, ``aux``, ``tokens``, ``loss``,
    ``grad_norm`` (before clipping) and ``lr``, as 0-d tensors."""
    compression = model.flags.grad_compression
    ranks, paths = reference_ranks(model), reference_paths(model)
    mesh = model.mesh
    sh = None if mesh is None else make_state_shardings(
        model, mesh, model.rules, zero1=model.flags.zero1)

    def grads_of(params, batch):
        loss, metrics = model.loss(batch)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True, materialize_grads=True)
        grads = dict(zip(params, grads))
        if sh is not None:      # to the moments' placements: RS or AR
            grads = {k: g.redistribute(mesh, sh["opt"]["m"][k])
                     for k, g in grads.items()}
        return whole(loss.detach()), {k: whole(v.detach())
                                      for k, v in metrics.items()}, grads

    def step(state: TrainState, batch):
        params = state["params"]
        batch = _on(batch, model.device)
        with ieee_fp32(), implicit_replication(mesh is not None):
            if microbatch > 1:
                micro = {k: v.reshape(microbatch, v.shape[0] // microbatch,
                                      *v.shape[1:]) for k, v in batch.items()}
                acc: dict = {}
                losses, mets = [], []
                for i in range(microbatch):
                    loss, metrics, grads = grads_of(
                        params, {k: v[i] for k, v in micro.items()})
                    for k, g in grads.items():
                        acc[k] = g.float() if k not in acc \
                            else acc[k].add_(g)
                    del grads
                    losses.append(loss)
                    mets.append(metrics)
                grads = {k: a.div_(microbatch) for k, a in acc.items()}
                loss = torch.stack(losses).mean()
                metrics = {k: torch.stack([m[k] for m in mets]).mean()
                           for k in mets[0]}
            else:
                loss, metrics, grads = grads_of(params, batch)
            if compression != "none":
                grads = _compress_all(grads, compression, paths)
            if sh is None:
                params, opt, opt_metrics = adamw_update(
                    grads, state["opt"], params, state["step"], opt_cfg,
                    ranks)
            else:
                opt, opt_metrics = _sharded_update(
                    grads, state["opt"], params, state["step"], opt_cfg,
                    ranks, sh, mesh)
        del grads
        new_state = {"params": params, "opt": opt,
                     "step": state["step"] + 1}
        return new_state, dict(metrics, loss=loss, **opt_metrics)

    return step


@torch.no_grad()
def _sharded_update(grads, opt, params, step, opt_cfg, ranks, sh, mesh):
    """AdamW on the moments' shards: each parameter cut to its moments'
    placements (a local slice), updated there, and gathered back into the
    parameter (an all-gather where ZeRO-1 split it)."""
    shards = {k: p.detach().redistribute(mesh, sh["opt"]["m"][k])
              for k, p in params.items()}
    shards, opt, metrics = adamw_update(grads, opt, shards, step, opt_cfg,
                                        ranks)
    for k, p in params.items():
        new = shards[k].redistribute(mesh, sh["params"][k])
        p.to_local().copy_(new.to_local())
    return opt, metrics
