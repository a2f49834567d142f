"""Language models: decoder-only, encoder-decoder, frontend stubs (port of
``repro.models.lm``).

``build_model(cfg, flags, rules, device=...)`` returns an :class:`LMModel`,
an ``nn.Module`` holding its weights (random, from a seeded generator on
the device, at the reference's init scales; nothing allocated or drawn on
the meta device) and exposing:

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

Sharding: :meth:`LMModel.param_logical_axes` gives each parameter's
logical axes, and :func:`distribute_model` turns every parameter into a
DTensor on a ``DeviceMesh`` by the model's ``rules`` (the reference's jit
``in_shardings``).  A distributed model takes the same batches, whole on
every rank (each rank keeps its own rows) or already DTensors, and
returns DTensors; its activations are pinned at the reference's
``shard_constraint`` points.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from .._device import resolve_device
from ..configs.base import ArchConfig
from ..parallel.local import MeshPlacer, global_offset, \
    implicit_replication, is_dtensor, map_local
from ..parallel.sharding import check_even, logical_to_spec, placements, \
    shard_constraint
from .blocks import Layer, LayerSpec, StackDef, _norm_scale, stack_apply, \
    stack_init_cache
from .configs_runtime import RuntimeFlags
from .layers import EMBED_AXES, embed_apply, embed_shapes, make_params, \
    rms_norm, unembed_apply

__all__ = ["LMModel", "build_model", "load_reference_params",
           "export_reference_params", "reference_paths", "reference_ranks",
           "distribute_model", "distribute_tensor", "place"]


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
    ``train.init_state`` (or ``state_from_reference``) turns them on.
    ``rules`` (a ``parallel.ShardingRules``) take effect once
    :func:`distribute_model` has put the weights on a mesh, or once they
    are built on ``mesh``: each rank draws every parameter's stream and
    keeps its own part, so no rank ever holds a whole parameter (the same
    weights)."""

    def __init__(self, cfg: ArchConfig, flags: Optional[RuntimeFlags] = None,
                 rules=None, *, device=None, seed: int = 0, mesh=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.flags = flags or RuntimeFlags()
        self.rules = rules
        period = max(1, cfg.attn_period, cfg.local_global_period,
                     cfg.moe_period if cfg.num_experts else 1)
        self.stack = _specs_to_stack(cfg.layer_kinds(), period)
        gen = None
        if dev.type != "meta":        # a meta build draws nothing
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
        put = None if mesh is None else MeshPlacer(mesh, rules)
        self.embed = make_params(
            embed_shapes(cfg.padded_vocab(), cfg.d_model, self.flags.pdtype),
            dev, gen, place=put, axes=EMBED_AXES)
        self.layers = nn.ModuleList(
            Layer(spec, cfg, self.flags, dev, gen, put)
            for spec in self.stack.specs())
        self.ln_f = _norm_scale(cfg.d_model, dev, put)
        self.enc_stack = None
        if cfg.encoder_layers:
            enc_spec = LayerSpec(mixer="attn", window=0, ffn="dense",
                                 cross=False, causal=False)
            self.enc_stack = StackDef(pattern=(enc_spec,),
                                      n_blocks=cfg.encoder_layers, tail=())
            self.enc_layers = nn.ModuleList(
                Layer(spec, cfg, self.flags, dev, gen, put)
                for spec in self.enc_stack.specs())
            self.enc_ln_f = _norm_scale(cfg.d_model, dev, put)

    @property
    def device(self) -> torch.device:
        return self.ln_f.device

    @property
    def mesh(self):
        """The ``DeviceMesh`` the weights are on, ``None`` for a model on
        one device."""
        return self.ln_f.device_mesh if is_dtensor(self.ln_f) else None

    def param_logical_axes(self) -> dict:
        """``{parameter name: logical axes}``: the reference's
        ``param_logical_axes()`` leaf for that parameter, without the
        leading ``'layers'`` axis of a scanned layer's stacked leaf."""
        out = {"embed.table": ("vocab", "embed"), "ln_f": ("embed",)}
        stacks = [("layers", self.layers)]
        if self.enc_stack is not None:
            stacks.append(("enc_layers", self.enc_layers))
            out["enc_ln_f"] = ("embed",)
        for head, layers in stacks:
            for i, layer in enumerate(layers):
                out.update({f"{head}.{i}.{k}": a
                            for k, a in layer.axes.items()})
        return {n: out[n] for n, _ in self.named_parameters()}

    def _place(self, t, *logical):
        """``t`` on the model's mesh by ``logical`` (a whole tensor is cut
        to this rank's part; a DTensor is redistributed); ``t`` itself off
        a mesh."""
        mesh = self.mesh
        if mesh is None or t is None:
            return t
        pl = placements(mesh, logical_to_spec(self.rules, logical))
        check_even(t.shape, mesh, pl, logical)
        if is_dtensor(t):
            return shard_constraint(t, self.rules, *logical)
        return distribute_tensor(
            torch.as_tensor(t, device=self.device), mesh, pl)

    def _sharded(self):
        """DTensor's implicit replication of plain tensors (positions,
        masks, zero accumulators) on a mesh; nothing off one."""
        return implicit_replication(self.mesh is not None)

    def _encode(self, audio_embeds: torch.Tensor) -> torch.Tensor:
        """The encoder's output for precomputed audio frame embeddings (B,
        S_enc, d): the encoder stack at positions ``0 .. S_enc - 1``, then
        ``enc_ln_f``."""
        with self._sharded():
            return self._encode_in(audio_embeds)

    def _encode_in(self, audio_embeds):
        x = self._place(audio_embeds, "batch", None, "act_embed")
        x = shard_constraint(x.to(self.flags.cdtype), self.rules, "batch",
                             None, "act_embed")
        x, _, _ = stack_apply(
            self.enc_layers, self.enc_stack, x, self.cfg, self.flags,
            self.rules, positions=torch.arange(x.shape[1], device=x.device))
        return rms_norm(x, self.enc_ln_f, self.cfg.norm_eps)

    def forward(self, batch: dict, *, cache: Optional[list] = None,
                positions: Optional[torch.Tensor] = None):
        """Returns (logits, new_cache, aux).  Without a cache this is the
        prefill (or the training forward): causal attention through the
        flash kernel and Mamba through the SSD kernel on the kernel route.
        Image embeds, when the batch has them, take the first positions;
        the logits are the text's only."""
        with self._sharded():
            return self._forward(batch, cache, positions)

    def _forward(self, batch, cache, positions):
        cfg, flags, rules = self.cfg, self.flags, self.rules
        tokens = self._place(batch["tokens"], "batch", None)
        x = embed_apply(self.embed, tokens, rules).to(flags.cdtype)
        img = batch.get("image_embeds") if cfg.frontend == "vision" \
            else None
        if img is not None:
            img = self._place(img, "batch", None, "act_embed")
            x = torch.cat([img.to(flags.cdtype), x], dim=1)
        enc_out = None
        if self.enc_stack is not None:
            enc_out = self._place(batch["enc_out"], "batch", None,
                                  "act_embed") if "enc_out" in batch \
                else self._encode_in(batch["audio_embeds"])
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)
        x, new_cache, aux = stack_apply(
            self.layers, self.stack, x, cfg, flags, rules, cache=cache,
            positions=positions, enc_out=enc_out)
        x = rms_norm(x, self.ln_f, cfg.norm_eps)
        if img is not None:
            x = x[:, img.shape[1]:]
        return unembed_apply(self.embed, x, rules), new_cache, aux

    def loss(self, batch: dict):
        """Masked next-token cross-entropy plus 0.01 x the MoE balance loss:
        ``(total, {'ce', 'aux', 'tokens'})``.  fp32 ``logsumexp`` minus the
        gold logit, times ``mask`` (ones when absent), over
        ``max(sum(mask), 1)``."""
        logits, _, aux = self.forward(batch)
        with self._sharded():
            targets = self._place(batch["targets"], "batch", None).long()
            mask = batch.get("mask")
            if mask is None:
                mask = torch.ones(targets.shape, dtype=torch.float32,
                                  device=targets.device)
            mask = self._place(mask, "batch", None)
            logits = logits.float()
            if is_dtensor(logits):       # the vocabulary stays split
                nll = _vocab_parallel_nll(logits, targets) * mask
            else:
                logz = torch.logsumexp(logits, dim=-1)
                gold = logits.gather(-1, targets[..., None])[..., 0]
                nll = (logz - gold) * mask
            tokens = mask.sum()
            ce = nll.sum() / torch.clamp(tokens, min=1.0)
            total = ce + 0.01 * aux
        return total, {"ce": ce, "aux": aux, "tokens": tokens}

    def init_cache(self, batch_size: int, max_len: int) -> list:
        """The decode cache; on a mesh every leaf is a DTensor placed by
        ``launch.rules.cache_logical_axes`` and the rules."""
        cache = stack_init_cache(self.stack, self.cfg, self.flags,
                                 batch_size, max_len, self.device)
        if self.mesh is None:
            return cache
        from ..launch.rules import cache_logical_axes
        axes = cache_logical_axes(cache)
        return [{"mixer": {k: v if not isinstance(v, torch.Tensor) else
                           self._place(v, *axes[i]["mixer"][k])
                           for k, v in c["mixer"].items()}}
                for i, c in enumerate(cache)]

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


def _vocab_parallel_nll(logits, targets):
    """``logsumexp(logits) - logits[target]`` per token, for DTensor
    logits whose vocabulary dim may be split: the max and the sum of
    exponentials reduce over the split (small all-reduces), and each rank
    picks the gold logits that fall in its own columns (a partial sum), so
    the logits are never gathered."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    m = logits.detach().amax(dim=-1, keepdim=True)
    logz = m[..., 0] + torch.log(torch.exp(logits - m).sum(dim=-1))
    mesh = logits.device_mesh
    rows = tuple(Shard(0) if p == Shard(0) else Replicate()
                 for p in logits.placements)
    l_pl = tuple(r if r == Shard(0) else (Shard(2) if p == Shard(2)
                                          else Replicate())
                 for r, p in zip(rows, logits.placements))
    out_pl = tuple(Partial() if p == Shard(2) else r
                   for r, p in zip(rows, l_pl))
    if tuple(logits.placements) != l_pl:
        logits = logits.redistribute(mesh, l_pl)
    v0 = global_offset(logits)[1][2]

    def local(lg, tg):
        ids = tg - v0
        hit = (ids >= 0) & (ids < lg.shape[-1])
        g = lg.gather(-1, ids.clamp(0, lg.shape[-1] - 1)[..., None])[..., 0]
        return g * hit.to(g.dtype)
    gold = map_local(local, mesh, (l_pl, rows), out_pl)(
        logits, targets.redistribute(mesh, rows))
    return logz - gold


def build_model(cfg: ArchConfig, flags: Optional[RuntimeFlags] = None,
                rules=None, *, device=None, seed: int = 0,
                mesh=None) -> LMModel:
    """An :class:`LMModel`; with ``mesh`` (and ``rules``) its parameters
    are built as DTensors there, each rank allocating only its part."""
    return LMModel(cfg, flags, rules, device=device, seed=seed, mesh=mesh)


def distribute_tensor(t: torch.Tensor, mesh, placements_) -> torch.Tensor:
    """A DTensor of ``t`` (whole, the same on every rank) with
    ``placements_`` on ``mesh``: each rank keeps a copy of its own part
    (``torch.chunk``'s split, as DTensor's ``Shard``), with no
    collective."""
    from torch.distributed.tensor import DTensor, Shard
    local = t
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements_):
        if isinstance(p, Shard):
            n = mesh.size(i)
            parts = torch.chunk(local, n, dim=p.dim)
            r = coord[i]
            local = parts[r] if r < len(parts) else local.narrow(
                p.dim, 0, 0)
    if local.numel() != t.numel():
        # a copy: a view would keep the whole tensor's storage alive
        local = local.clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, placements_, run_check=False,
                              shape=t.shape, stride=t.stride())


def place(t, mesh, rules, *logical):
    """``t`` (whole on every rank) on ``mesh`` by ``logical``."""
    return distribute_tensor(t, mesh,
                             placements(mesh, logical_to_spec(rules,
                                                              logical)))


@torch.no_grad()
def distribute_model(model: LMModel, mesh, rules) -> LMModel:
    """Every parameter of ``model`` (whole on every rank, the same
    weights) made a DTensor on ``mesh``, placed by its logical axes and
    ``rules``: the counterpart of the reference's jit ``in_shardings``.
    The model keeps ``rules`` for its activations.  Returns ``model``."""
    axes = model.param_logical_axes()
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        d = place(p.detach(), mesh, rules, *axes[name])
        setattr(mod, leaf, nn.Parameter(d, requires_grad=p.requires_grad))
    model.rules = rules
    return model


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
    Every parameter must be matched once, shape for shape.  A model on a
    mesh takes whole leaves (each rank keeps its part) or DTensor leaves
    (redistributed to each parameter's placements)."""
    for name, t in named_from_reference(model, tree).items():
        p = model.get_parameter(name)
        t = t.to(p.dtype)
        if is_dtensor(p) and not is_dtensor(t):
            t = distribute_tensor(t.to(p.device), p.device_mesh,
                                  p.placements)
        elif is_dtensor(p) and tuple(t.placements) != tuple(p.placements):
            t = t.redistribute(p.device_mesh, p.placements)
        p.copy_(t)
    return model
