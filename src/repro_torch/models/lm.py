"""Language models: decoder-only, encoder-decoder, frontend stubs (port of
``repro.models.lm``).

``build_model(cfg, flags, device=...)`` returns an :class:`LMModel`, an
``nn.Module`` holding its weights (random, from a seeded generator on the
device, at the reference's init scales) and exposing:

  forward(batch, cache=None, positions=None) -> (logits, new_cache, aux)
  loss(batch)                                -> (scalar, metrics)  [train]
  init_cache(batch_size, max_len)            -> decode cache (one per layer)
  decode_step(cache, batch)                  -> (logits, new_cache) [serve]

batch: ``{'tokens' (B, S)}``, plus ``'targets'`` and ``'mask'`` (B, S) for
``loss`` and ``'pos'`` for ``decode_step``.  The frontends are stubs that
take precomputed embeddings, as in the reference: an audio config
(encoder-decoder, ``encoder_layers > 0``) adds ``'audio_embeds'`` (B,
S_enc, d), which the encoder (non-causal attention + FFN, plain attention
on both routes) turns into the output its decoder's cross-attention reads,
or ``'enc_out'``, an output :meth:`LMModel._encode` made before, so decode
does not rerun the encoder; a vision config adds ``'image_embeds'`` (B, F,
d), prepended to the token embeddings and cut from the logits.  Serving
builds no autograd graph (``decode_step`` runs under ``torch.no_grad``,
and serving weights do not require grad); ``loss`` is differentiable on
the non-kernel route.  :func:`load_reference_params` fills a model from
the JAX package's parameter tree (numpy leaves) and
:func:`export_reference_params` builds that tree from the model, so
weights, optimizer moments and checkpoints cross between the packages
both ways.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from .._device import resolve_device
from ..configs.base import ArchConfig
from .blocks import Layer, LayerSpec, StackDef, stack_apply, \
    stack_init_cache
from .configs_runtime import RuntimeFlags
from .layers import embed_apply, embed_shapes, make_params, rms_norm, \
    unembed_apply

__all__ = ["LMModel", "build_model", "load_reference_params",
           "export_reference_params", "reference_paths", "reference_ranks"]


def _specs_to_stack(kinds: list[dict], period: int) -> StackDef:
    specs = [LayerSpec(mixer=k["mixer"], window=k["window"], ffn=k["ffn"],
                       cross=k["cross"]) for k in kinds]
    n = len(specs)
    if period <= 1:
        if any(s != specs[0] for s in specs):
            raise ValueError("layer kinds are not uniform")
        return StackDef(pattern=(specs[0],), n_blocks=n, tail=())
    n_blocks = n // period
    tail = tuple(specs[n_blocks * period:])
    pattern = tuple(specs[:period])
    for b in range(1, n_blocks):
        if tuple(specs[b * period:(b + 1) * period]) != pattern:
            raise ValueError("layer kinds are not periodic")
    return StackDef(pattern=pattern, n_blocks=n_blocks, tail=tail)


class LMModel(nn.Module):
    """An LM on one device (``None`` means CUDA): the decoder ``layers``
    and ``ln_f``, and for an encoder-decoder also ``enc_layers`` and
    ``enc_ln_f``.  Its weights do not require grad until
    ``train.init_state`` (or ``state_from_reference``) turns them on."""

    def __init__(self, cfg: ArchConfig, flags: Optional[RuntimeFlags] = None,
                 *, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.flags = flags or RuntimeFlags()
        period = max(1, cfg.attn_period, cfg.local_global_period,
                     cfg.moe_period if cfg.num_experts else 1)
        self.stack = _specs_to_stack(cfg.layer_kinds(), period)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        self.embed = make_params(
            embed_shapes(cfg.padded_vocab(), cfg.d_model, self.flags.pdtype),
            dev, gen)
        self.layers = nn.ModuleList(
            Layer(spec, cfg, self.flags, dev, gen)
            for spec in self.stack.specs())
        self.ln_f = nn.Parameter(
            torch.zeros(cfg.d_model, dtype=torch.float32, device=dev),
            requires_grad=False)
        self.enc_stack = None
        if cfg.encoder_layers:
            enc_spec = LayerSpec(mixer="attn", window=0, ffn="dense",
                                 cross=False, causal=False)
            self.enc_stack = StackDef(pattern=(enc_spec,),
                                      n_blocks=cfg.encoder_layers, tail=())
            self.enc_layers = nn.ModuleList(
                Layer(spec, cfg, self.flags, dev, gen)
                for spec in self.enc_stack.specs())
            self.enc_ln_f = nn.Parameter(
                torch.zeros(cfg.d_model, dtype=torch.float32, device=dev),
                requires_grad=False)

    @property
    def device(self) -> torch.device:
        return self.ln_f.device

    def _encode(self, audio_embeds: torch.Tensor) -> torch.Tensor:
        """The encoder's output for precomputed audio frame embeddings (B,
        S_enc, d): the encoder stack at positions ``0 .. S_enc - 1``, then
        ``enc_ln_f``."""
        x = audio_embeds.to(self.flags.cdtype)
        x, _, _ = stack_apply(
            self.enc_layers, self.enc_stack, x, self.cfg, self.flags,
            positions=torch.arange(x.shape[1], device=x.device))
        return rms_norm(x, self.enc_ln_f, self.cfg.norm_eps)

    def forward(self, batch: dict, *, cache: Optional[list] = None,
                positions: Optional[torch.Tensor] = None):
        """Returns (logits, new_cache, aux).  Without a cache this is the
        prefill (or the training forward): causal attention through the
        flash kernel and Mamba through the SSD kernel on the kernel route.
        Image embeds, when the batch has them, take the first positions;
        the logits are the text's only."""
        cfg, flags = self.cfg, self.flags
        x = embed_apply(self.embed, batch["tokens"]).to(flags.cdtype)
        img = batch.get("image_embeds") if cfg.frontend == "vision" \
            else None
        if img is not None:
            x = torch.cat([img.to(flags.cdtype), x], dim=1)
        enc_out = None
        if self.enc_stack is not None:
            enc_out = batch["enc_out"] if "enc_out" in batch \
                else self._encode(batch["audio_embeds"])
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)
        x, new_cache, aux = stack_apply(
            self.layers, self.stack, x, cfg, flags, cache=cache,
            positions=positions, enc_out=enc_out)
        x = rms_norm(x, self.ln_f, cfg.norm_eps)
        if img is not None:
            x = x[:, img.shape[1]:]
        return unembed_apply(self.embed, x), new_cache, aux

    def loss(self, batch: dict):
        """Masked next-token cross-entropy plus 0.01 x the MoE balance loss:
        ``(total, {'ce', 'aux', 'tokens'})``.  fp32 ``logsumexp`` minus the
        gold logit, times ``mask`` (ones when absent), over
        ``max(sum(mask), 1)``."""
        logits, _, aux = self.forward(batch)
        targets = batch["targets"].long()
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones(targets.shape, dtype=torch.float32,
                              device=targets.device)
        logits = logits.float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, targets[..., None])[..., 0]
        nll = (logz - gold) * mask
        tokens = mask.sum()
        ce = nll.sum() / torch.clamp(tokens, min=1.0)
        total = ce + 0.01 * aux
        return total, {"ce": ce, "aux": aux, "tokens": tokens}

    def init_cache(self, batch_size: int, max_len: int) -> list:
        return stack_init_cache(self.stack, self.cfg, self.flags, batch_size,
                                max_len, self.device)

    @torch.no_grad()
    def decode_step(self, cache: list, batch: dict):
        """One-token step.  batch: ``{'tokens' (B, 1), 'pos' int}`` plus
        ``'enc_out'`` (or ``'audio_embeds'``) for an encoder-decoder; the
        cache is updated in place and returned.  As in the reference, a
        ``'pos'`` of several positions with as many tokens (and any
        ``'image_embeds'``, which take the first of them) prefills the
        cache in one call."""
        pos = batch["pos"]
        if isinstance(pos, (torch.Tensor, np.ndarray)) and np.ndim(pos):
            positions = torch.as_tensor(pos, device=self.device).long()
        else:
            positions = torch.tensor([int(pos)], device=self.device)
        logits, new_cache, _ = self.forward(batch, cache=cache,
                                            positions=positions)
        return logits, new_cache


def build_model(cfg: ArchConfig, flags: Optional[RuntimeFlags] = None, *,
                device=None, seed: int = 0) -> LMModel:
    return LMModel(cfg, flags, device=device, seed=seed)


def _leaves(tree: dict, prefix: str = ""):
    """(``'a/b/c'``, leaf) for every leaf of a nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def reference_paths(model: LMModel) -> dict:
    """``{port parameter name: (reference path, block or None)}``: where
    each parameter lives in the reference's tree (``'stack/pos0/ln1'``)
    and, for a scanned layer, its index along the stacked leaf's leading
    axis.  Anything the reference does per leaf (decay by rank, per-tensor
    int8 compression) is done per reference leaf here.

    The reference stacks the scanned layers' leaves along a leading
    ``n_blocks`` axis (``stack/pos{i}/...``, layer ``block * len(pattern)
    + i``) and keeps the tail layers' leaves as they are
    (``stack/tail{j}/...``); the encoder's layers (``enc_layers.{n}``) are
    ``enc_stack/pos0/...``, block ``n``."""
    stacks = {"layers": ("stack", model.stack),
              "enc_layers": ("enc_stack", model.enc_stack)}
    out = {}
    for name, _ in model.named_parameters():
        head, _, tail = name.partition(".")
        if head not in stacks:
            out[name] = (name.replace(".", "/"), None)
            continue
        tree, stack = stacks[head]
        P = len(stack.pattern)
        idx, rest = tail.split(".", 1)
        idx = int(idx)
        if idx < stack.n_blocks * P:
            pos, blk = f"pos{idx % P}", idx // P
        else:
            pos, blk = f"tail{idx - stack.n_blocks * P}", None
        out[name] = (f"{tree}/{pos}/{rest.replace('.', '/')}", blk)
    return out


def reference_ranks(model: LMModel) -> dict:
    """``{port parameter name: rank of its leaf in the reference's
    tree}``: one more than the port's for a scanned layer (its leading
    ``n_blocks`` axis).  The reference's AdamW decays a leaf of rank >= 2,
    so the port decides decay from these ranks: scanned norms' gammas
    (``ln_cross`` too) and Mamba's ``dt_bias`` / ``a_log`` / ``d_skip`` /
    ``norm`` are decayed, the same vectors in the tail and ``ln_f`` /
    ``enc_ln_f`` are not."""
    paths = reference_paths(model)
    return {n: p.dim() + (paths[n][1] is not None)
            for n, p in model.named_parameters()}


def export_reference_params(model: LMModel,
                            values: Optional[dict] = None) -> dict:
    """The reference's parameter tree (``LMModel.init``'s layout) of
    ``values`` — ``{port parameter name: tensor}``, the model's own
    parameters when ``None``, or anything keyed like them (optimizer
    moments) — with detached tensor leaves on their device: scanned
    layers restacked along ``n_blocks``, tail layers as they are.  The
    inverse of :func:`load_reference_params`."""
    if values is None:
        values = dict(model.named_parameters())
    leaves: dict = {}
    for name, (path, blk) in reference_paths(model).items():
        leaves.setdefault(path, []).append((blk, values[name].detach()))
    tree: dict = {}
    for path, parts in leaves.items():
        *parents, key = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[key] = parts[0][1] if parts[0][0] is None else torch.stack(
            [t for _, t in sorted(parts, key=lambda bt: bt[0])])
    return tree


def _tensor(a) -> torch.Tensor:
    """numpy (including JAX's bfloat16 arrays) or a tensor -> tensor."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def named_from_reference(model: LMModel, tree: dict) -> dict:
    """``{port parameter name: tensor}`` from a tree in the reference's
    layout (numpy or tensor leaves; scanned leaves unstacked along their
    leading ``n_blocks`` axis), on the leaves' device.  Every parameter
    must be matched once, shape for shape, and every leaf used."""
    flat = dict(_leaves(tree))
    paths = reference_paths(model)
    out = {}
    for name, (path, blk) in paths.items():
        if path not in flat:
            raise ValueError(f"parameters not in the reference tree: "
                             f"{name} ({path})")
        t = _tensor(flat[path])
        if blk is not None:
            t = t[blk]
        want = tuple(model.get_parameter(name).shape)
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: reference shape {tuple(t.shape)}, "
                             f"port shape {want}")
        out[name] = t
    extra = set(flat) - {p for p, _ in paths.values()}
    if extra:
        raise ValueError(f"reference leaves the port has no parameter for: "
                         f"{sorted(extra)}")
    return out


@torch.no_grad()
def load_reference_params(model: LMModel, tree: dict) -> LMModel:
    """Fill ``model`` with the JAX package's parameters for the same
    config: ``tree`` is ``LMModel.init``'s tree with numpy leaves
    (``jax.tree.map(np.asarray, params)``) or the tree
    :func:`export_reference_params` builds.  Scanned ``stack/pos{i}``
    leaves are unstacked along their leading ``n_blocks`` axis into layers
    ``block * len(pattern) + i``; ``tail{j}`` fills the layers after them.
    Every parameter must be matched once, shape for shape."""
    for name, t in named_from_reference(model, tree).items():
        p = model.get_parameter(name)
        p.copy_(t.to(p.dtype))
    return model
