"""Train step: loss -> grads -> AdamW, with microbatching and gradient
compression (port of ``repro.train.train_step``).

A state is ``{'params': {name: Parameter}, 'opt': {'m', 'v'}, 'step':
int32 scalar}`` whose ``params`` are the model's own parameters: the step
updates them, and the moments, in place.  The reference's sharding specs
(``make_state_shardings``, ``batch_sharding``, ZeRO-1) wait for the LM
sharding slice (ROADMAP queue 1, item 6.3).

The forward and the backward both run with TF32 off (``ieee_fp32``): the
forward's products turn it off inside their own ``with`` blocks, but
autograd runs the backward outside them, where cuDNN's default would run
an fp32 convolution's backward in TF32.
"""

from __future__ import annotations

import torch

from ..kernels.pairwise.fused_gather_gram import ieee_fp32
from ..models.lm import LMModel, reference_paths, reference_ranks
from .optimizer import AdamWConfig, adamw_init, adamw_update

__all__ = ["TrainState", "init_state", "make_train_step"]

TrainState = dict  # {'params': ..., 'opt': {'m','v'}, 'step': ()}


def init_state(model: LMModel, opt_cfg: AdamWConfig) -> TrainState:
    """The model's own weights (drawn by ``build_model(..., seed=...)`` or
    loaded), made trainable and paired with zero moments at step 0.  The
    reference's ``init_state(model, key, opt_cfg)`` draws the weights
    here; the port's model already holds them."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    return {"params": params, "opt": adamw_init(params, opt_cfg),
            "step": torch.zeros((), dtype=torch.int32, device=model.device)}


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
    pattern), so the port's per-layer tensors share their leaf's max."""
    amax: dict = {}
    if mode == "int8":
        for k, g in grads.items():
            m = g.abs().max()
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

    def grads_of(params, batch):
        loss, metrics = model.loss(batch)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True, materialize_grads=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            dict(zip(params, grads))

    def step(state: TrainState, batch):
        params = state["params"]
        batch = _on(batch, model.device)
        with ieee_fp32():
            if microbatch > 1:
                micro = {k: v.reshape(microbatch, v.shape[0] // microbatch,
                                      *v.shape[1:]) for k, v in batch.items()}
                acc = {k: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
                       for k, p in params.items()}
                losses, mets = [], []
                for i in range(microbatch):
                    loss, metrics, grads = grads_of(
                        params, {k: v[i] for k, v in micro.items()})
                    for k, g in grads.items():
                        acc[k].add_(g)
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
        params, opt, opt_metrics = adamw_update(
            grads, state["opt"], params, state["step"], opt_cfg, ranks)
        del grads
        new_state = {"params": params, "opt": opt,
                     "step": state["step"] + 1}
        return new_state, dict(metrics, loss=loss, **opt_metrics)

    return step
