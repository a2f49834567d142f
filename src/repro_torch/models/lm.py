"""Decoder-only language models (port of ``repro.models.lm``).

``build_model(cfg, flags, device=...)`` returns an :class:`LMModel`, an
``nn.Module`` holding its weights (random, from a seeded generator on the
device, at the reference's init scales) and exposing the serving calls:

  forward(batch, cache=None, positions=None) -> (logits, new_cache, aux)
  init_cache(batch_size, max_len)            -> decode cache (one per layer)
  decode_step(cache, batch)                  -> (logits, new_cache)

batch: ``{'tokens' (B, S)}``, plus ``'pos'`` (an int) for ``decode_step``.
:func:`load_reference_params` fills a model from the JAX package's
parameter tree (numpy leaves), so both packages can run the same weights.
The encoder, cross-attention and the audio / vision frontends are not
ported yet (ROADMAP.md); configs that need them raise.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from .._device import resolve_device
from ..configs.base import ArchConfig
from .blocks import Layer, LayerSpec, StackDef, _block_apply, stack_init_cache
from .configs_runtime import RuntimeFlags
from .layers import embed_apply, embed_shapes, make_params, rms_norm, \
    unembed_apply

__all__ = ["LMModel", "build_model", "load_reference_params"]


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
    """A decoder-only LM on one device (``None`` means CUDA)."""

    def __init__(self, cfg: ArchConfig, flags: Optional[RuntimeFlags] = None,
                 *, device=None, seed: int = 0):
        super().__init__()
        if cfg.encoder_layers or cfg.frontend != "none":
            raise NotImplementedError(
                f"{cfg.name}: the encoder, cross-attention and the "
                f"{cfg.frontend} frontend are not ported yet; see ROADMAP.md")
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

    @property
    def device(self) -> torch.device:
        return self.ln_f.device

    @torch.no_grad()
    def forward(self, batch: dict, *, cache: Optional[list] = None,
                positions: Optional[torch.Tensor] = None):
        """Returns (logits, new_cache, aux).  Without a cache this is the
        prefill: attention through the flash kernel and Mamba through the
        SSD kernel on the kernel route."""
        cfg, flags = self.cfg, self.flags
        x = embed_apply(self.embed, batch["tokens"]).to(flags.cdtype)
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)
        new_cache = None if cache is None else []
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, layer in enumerate(self.layers):
            x, nc, a = _block_apply(
                layer, x, cfg, flags,
                cache=None if cache is None else cache[i],
                positions=positions)
            if cache is not None:
                new_cache.append(nc)
            aux = aux + a
        x = rms_norm(x, self.ln_f, cfg.norm_eps)
        return unembed_apply(self.embed, x), new_cache, aux

    def init_cache(self, batch_size: int, max_len: int) -> list:
        return stack_init_cache(self.stack, self.cfg, self.flags, batch_size,
                                max_len, self.device)

    def decode_step(self, cache: list, batch: dict):
        """One-token step.  batch: ``{'tokens' (B, 1), 'pos' int}``; the
        cache is updated in place and returned."""
        positions = torch.tensor([int(batch["pos"])], device=self.device)
        logits, new_cache, _ = self.forward(batch, cache=cache,
                                            positions=positions)
        return logits, new_cache


def build_model(cfg: ArchConfig, flags: Optional[RuntimeFlags] = None, *,
                device=None, seed: int = 0) -> LMModel:
    return LMModel(cfg, flags, device=device, seed=seed)


def _tensor(a) -> torch.Tensor:
    """numpy (including JAX's bfloat16 arrays) -> CPU tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@torch.no_grad()
def load_reference_params(model: LMModel, tree: dict) -> LMModel:
    """Fill ``model`` with the JAX package's parameters for the same
    config: ``tree`` is ``LMModel.init``'s tree with numpy leaves
    (``jax.tree.map(np.asarray, params)``).  Scanned ``stack/pos{i}``
    leaves are unstacked along their leading ``n_blocks`` axis into layers
    ``block * len(pattern) + i``; ``tail{j}`` fills the layers after them.
    Every parameter must be matched once, shape for shape."""
    filled = set()

    def put(name: str, dst: torch.Tensor, src) -> None:
        t = _tensor(src)
        if tuple(t.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: reference shape {tuple(t.shape)}, "
                             f"port shape {tuple(dst.shape)}")
        dst.copy_(t.to(dst.dtype))
        filled.add(name)

    def put_layer(idx: int, sub: dict, blk: Optional[int]) -> None:
        layer = model.layers[idx]
        for key, val in sub.items():
            if isinstance(val, dict):
                group = getattr(layer, key)
                for k, a in val.items():
                    put(f"layers.{idx}.{key}.{k}", group[k],
                        a if blk is None else a[blk])
            else:
                put(f"layers.{idx}.{key}", getattr(layer, key),
                    val if blk is None else val[blk])

    put("embed.table", model.embed["table"], tree["embed"]["table"])
    put("ln_f", model.ln_f, tree["ln_f"])
    stack, P = model.stack, len(model.stack.pattern)
    for i in range(P):
        for blk in range(stack.n_blocks):
            put_layer(blk * P + i, tree["stack"][f"pos{i}"], blk)
    for j in range(len(stack.tail)):
        put_layer(stack.n_blocks * P + j, tree["stack"][f"tail{j}"], None)
    missing = {n for n, _ in model.named_parameters()} - filled
    if missing:
        raise ValueError(f"parameters not in the reference tree: "
                         f"{sorted(missing)}")
    return model
