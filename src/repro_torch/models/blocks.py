"""Layer blocks and stacks (port of ``repro.models.blocks``).

An architecture is a repeating *pattern* of LayerSpecs (Jamba: 1 attention
+ 7 Mamba with MoE every other FFN) repeated ``n_blocks`` times, plus an
unrolled tail.  The reference scans the repetitions with ``lax.scan`` over
stacked weights; the port keeps one :class:`Layer` per layer, in order
(layer ``block * len(pattern) + i`` is position ``i`` of repetition
``block``), and runs them in a Python loop (:func:`stack_apply`).  With
autograd on, each repetition is rematerialised as the reference's scan
body is (``RuntimeFlags.remat``); the tail and the serving path are not.
An encoder-decoder's decoder layers (``cross=True``) also attend to the
encoder's output between the mixer and the FFN.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from .layers import (
    ATTN_AXES,
    AttnSpec,
    attn_apply,
    attn_init_cache,
    attn_shapes,
    make_params,
    mlp_apply,
    mlp_axes,
    mlp_shapes,
    rms_norm,
)
from ..parallel.local import implicit_replication, is_dtensor
from .mamba import MAMBA_AXES, mamba_apply, mamba_init_cache, mamba_shapes
from .moe import MOE_AXES, moe_apply, moe_shapes

__all__ = ["LayerSpec", "StackDef", "Layer", "stack_apply",
           "stack_init_cache"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str = "attn"          # 'attn' | 'mamba'
    window: int = 0              # sliding window (attn only; 0 = full)
    ffn: str = "dense"           # 'dense' | 'moe' | 'none'
    cross: bool = False          # cross-attention (enc-dec decoder)
    causal: bool = True


@dataclasses.dataclass(frozen=True)
class StackDef:
    pattern: tuple[LayerSpec, ...]
    n_blocks: int                # repetitions of the pattern
    tail: tuple[LayerSpec, ...]  # unrolled remainder

    @property
    def num_layers(self) -> int:
        return self.n_blocks * len(self.pattern) + len(self.tail)

    def specs(self) -> list[LayerSpec]:
        """Every layer's spec, in order."""
        return list(self.pattern) * self.n_blocks + list(self.tail)


def _attn_spec(spec: LayerSpec, cfg) -> AttnSpec:
    return AttnSpec(
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim_(), window=spec.window, causal=spec.causal,
        rope_theta=cfg.rope_theta)


def _cross_spec(cfg) -> AttnSpec:
    """Cross-attention: no window, not causal, no RoPE."""
    return AttnSpec(
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim_(), window=0, causal=False, use_rope=False)


def _norm_scale(d: int, device, place=None) -> nn.Parameter:
    """An RMSNorm gamma (fp32, zero: the norm scales by ``1 + gamma``);
    ``place`` (a ``MeshPlacer``) puts it on a mesh (logical axes
    ``('embed',)``)."""
    if place is None:
        return nn.Parameter(torch.zeros(d, dtype=torch.float32,
                                        device=device), requires_grad=False)
    t = torch.zeros(place.box((d,), ("embed",))[1], dtype=torch.float32,
                    device=device)
    return nn.Parameter(place.wrap(t, (d,), ("embed",)),
                        requires_grad=False)


class Layer(nn.Module):
    """One layer's parameters under the reference's names: ``ln1``,
    ``mixer``, ``cross`` / ``ln_cross`` when it attends to an encoder, and
    ``ln2`` / ``ffn`` unless the FFN is ``'none'``.  ``axes`` maps each
    parameter's name within the layer to its logical axes (the
    reference's ``_layer_init`` axes).  ``place`` (a
    ``parallel.local.MeshPlacer``) builds each parameter as this rank's
    part of it on a mesh."""

    def __init__(self, spec: LayerSpec, cfg, flags, device, gen,
                 place=None):
        super().__init__()
        self.spec = spec
        dtype, d = flags.pdtype, cfg.d_model
        axes = {"ln1": ("embed",)}
        self.ln1 = _norm_scale(d, device, place)
        if spec.mixer == "attn":
            shapes = attn_shapes(d, _attn_spec(spec, cfg), dtype)
            mixer_axes = ATTN_AXES
        else:
            shapes = mamba_shapes(d, cfg.ssm_state, dtype)
            mixer_axes = MAMBA_AXES
        self.mixer = make_params(shapes, device, gen, place=place,
                                 axes=mixer_axes)
        axes.update({f"mixer.{k}": a for k, a in mixer_axes.items()})
        if spec.cross:
            self.cross = make_params(attn_shapes(d, _cross_spec(cfg), dtype),
                                     device, gen, place=place,
                                     axes=ATTN_AXES)
            self.ln_cross = _norm_scale(d, device, place)
            axes.update({f"cross.{k}": a for k, a in ATTN_AXES.items()})
            axes["ln_cross"] = ("embed",)
        if spec.ffn != "none":
            self.ln2 = _norm_scale(d, device, place)
            axes["ln2"] = ("embed",)
            if spec.ffn == "moe":
                shapes = moe_shapes(d, cfg.d_ff, cfg.num_experts, dtype)
                ffn_axes = MOE_AXES
            else:
                shapes = mlp_shapes(d, cfg.d_ff, dtype,
                                    variant=cfg.mlp_variant)
                ffn_axes = mlp_axes(cfg.mlp_variant)
            self.ffn = make_params(shapes, device, gen, place=place,
                                   axes=ffn_axes)
            axes.update({f"ffn.{k}": a for k, a in ffn_axes.items()})
        self.axes = axes


def _block_apply(layer: Layer, x, cfg, flags, rules=None, cache=None,
                 positions=None, enc_out=None):
    """One layer: ``x + mixer(norm(x))``, then ``x + cross(norm(x),
    enc_out)`` in a decoder layer of an encoder-decoder, then ``x +
    ffn(norm(x))``.  Returns (x, new_cache, aux)."""
    spec = layer.spec
    h = rms_norm(x, layer.ln1, cfg.norm_eps)
    if spec.mixer == "attn":
        y, mc = attn_apply(
            layer.mixer, h, _attn_spec(spec, cfg), rules,
            cache=None if cache is None else cache["mixer"],
            positions=positions, use_kernels=flags.use_pallas,
            probs_dtype=getattr(torch, flags.attn_probs_dtype))
    else:
        y, mc = mamba_apply(
            layer.mixer, h, cfg.mamba_meta(), rules,
            cache=None if cache is None else cache["mixer"],
            use_kernels=flags.use_pallas, ssd_impl=flags.ssd_impl)
    x = x + y
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.cross:
        if enc_out is None:
            raise ValueError("a cross-attention layer needs enc_out")
        # the reference's call: plain attention, fp32 probabilities
        h = rms_norm(x, layer.ln_cross, cfg.norm_eps)
        y, _ = attn_apply(layer.cross, h, _cross_spec(cfg), rules,
                          use_kernels=False, kv_src=enc_out)
        x = x + y
    if spec.ffn != "none":
        h = rms_norm(x, layer.ln2, cfg.norm_eps)
        if spec.ffn == "moe":
            y, moe_aux = moe_apply(
                layer.ffn, h, top_k=cfg.experts_per_token,
                capacity_factor=flags.capacity_factor, rules=rules)
            aux = aux + moe_aux["load_balance"]
        else:
            y = mlp_apply(layer.ffn, h, rules)
        x = x + y
    return x, (None if cache is None else {"mixer": mc}), aux


def _dots_policy(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: keep
    the products without batch dimensions (the weight projections, the
    router, the unembedding), recompute the rest.  ``torch.einsum`` lowers
    every product to ``bmm``: one with no batch dimension (``bsd,dhk``)
    folds all free axes into the rows and reaches ``bmm`` with a batch of
    1, while one with batch dimensions (the attention scores ``bshgd,bthd``
    over b and h, the experts ``becd,edf`` over e) has a batch of their
    product.  A plain 2-D ``@`` reaches ``mm``."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default) or (
            op is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, flags):
    """``fn`` as the backward sees it under ``flags.remat``: ``'none'``
    keeps every activation, ``'full'`` only the inputs, ``'dots'`` also
    the products ``_dots_policy`` keeps."""
    if flags.remat == "none":
        return fn
    if flags.remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if flags.remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(f"remat {flags.remat!r}: want 'none', 'full' or 'dots'")


def stack_apply(layers, stack: StackDef, x, cfg, flags, rules=None, *,
                cache=None, positions=None, enc_out=None):
    """Every layer in order; ``enc_out`` reaches every cross-attention.
    Returns (x, new_cache, aux_sum).

    Without a cache and with autograd on, each repetition of the pattern
    (the reference's scan body) runs under :func:`_remat`; the tail layers
    are not rematerialised, as in the reference.  ``enc_out`` enters each
    rematerialised repetition as an argument, so the decoder's gradient
    reaches the encoder under every ``remat``."""
    P = len(stack.pattern)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = None if cache is None else []

    def superblock(x, block, enc_out):
        # on a mesh also when the backward reruns it (remat)
        with implicit_replication(is_dtensor(x)):
            aux_sb = torch.zeros((), dtype=torch.float32, device=x.device)
            for layer in layers[block * P:(block + 1) * P]:
                x, _, a = _block_apply(layer, x, cfg, flags, rules,
                                       positions=positions, enc_out=enc_out)
                aux_sb = aux_sb + a
        return x, aux_sb

    n_scanned = 0
    if cache is None:
        run = _remat(superblock, flags) if torch.is_grad_enabled() \
            else superblock
        for block in range(stack.n_blocks):
            x, a = run(x, block, enc_out)
            aux = aux + a
        n_scanned = stack.n_blocks * P
    for i in range(n_scanned, len(layers)):
        x, nc, a = _block_apply(
            layers[i], x, cfg, flags, rules,
            cache=None if cache is None else cache[i], positions=positions,
            enc_out=enc_out)
        if cache is not None:
            new_cache.append(nc)
        aux = aux + a
    return x, new_cache, aux


def stack_init_cache(stack: StackDef, cfg, flags, batch: int, max_len: int,
                     device) -> list:
    """One ``{'mixer': ...}`` cache per layer, in layer order."""
    out = []
    for spec in stack.specs():
        if spec.mixer == "attn":
            mc = attn_init_cache(batch, max_len, _attn_spec(spec, cfg),
                                 flags.cdtype, device,
                                 kv_quant=flags.kv_quant)
        else:
            mc = mamba_init_cache(batch, cfg.mamba_meta(), flags.cdtype,
                                  device)
        out.append({"mixer": mc})
    return out
