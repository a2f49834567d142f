"""Primitive layers: norm, RoPE, GQA attention (+KV cache), MLP, embedding
(port of ``repro.models.layers``).

Parameters keep the reference's names and layouts (``wq (d, H, D)``,
``wo (H, D, d)``, ...), so carrying weights across is a copy; each
``*_shapes`` function lists a module's parameters with their dtypes and
init scales, and :func:`make_params` allocates and fills them on a device
from a ``torch.Generator`` (the same scales as the reference's init, not
the same numbers); ``*_AXES`` / :func:`mlp_axes` give each parameter's
logical axes, the reference's ``init`` axes.  ``rules`` (a
``parallel.ShardingRules``, ``None`` off a mesh) pins activations with
``shard_constraint`` at the reference's points; on a plain tensor it does
nothing.  Matrix products promote their operands as JAX's ``einsum``
does.

Decode writes the new keys and values INTO the cache tensors it is given
(the reference returns updated copies): a step costs one cache write
instead of a copy of the whole cache.  The returned cache holds the same
tensors and the advanced ``len``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.flash import ops as flash_ops
from ..kernels.flash.ref import NEG_INF
from ..kernels.pairwise.fused_gather_gram import ieee_fp32
from ..parallel.local import batch_placements, gathered, global_offset, \
    is_dtensor, map_local, per_head, write_rows
from ..parallel.sharding import shard_constraint

__all__ = ["AttnSpec", "make_params", "rms_norm", "rope", "embed_shapes",
           "embed_apply", "unembed_apply", "mlp_shapes", "mlp_apply",
           "attn_shapes", "attn_apply", "attn_init_cache", "EMBED_AXES",
           "ATTN_AXES", "mlp_axes"]

# ---------------------------------------------------------------- utilities


def make_params(shapes: dict, device, gen: Optional[torch.Generator],
                requires_grad: bool = False, place=None,
                axes: Optional[dict] = None) -> nn.ParameterDict:
    """``{name: (shape, dtype, init)}`` -> parameters on ``device``; init is
    a normal scale, ``"zeros"`` or ``"ones"``.  Normals are drawn in fp32
    and cast, as the reference's ``_normal`` does, a slab at a time so a
    full-width expert stack never needs a whole fp32 copy.  Serving keeps
    ``requires_grad=False``; training turns it on.  On the meta device
    nothing is allocated or drawn (``gen`` is ``None`` there).  ``place``
    (a ``parallel.local.MeshPlacer``, with ``axes`` the parameters'
    logical axes) makes each parameter a DTensor holding only this rank's
    box: the whole stream of normals is drawn, slab by slab, and the part
    in the box kept, so the weights equal a whole build's."""
    out = nn.ParameterDict()
    for name, (shape, dtype, init) in shapes.items():
        box = None if place is None else place.box(shape, axes[name])
        t = torch.empty(shape if box is None else box[1], dtype=dtype,
                        device=device)
        if t.is_meta:
            pass
        elif init == "zeros":
            t.zero_()
        elif init == "ones":
            t.fill_(1.0)
        else:
            _draw(t, shape, init, gen, box)
        if place is not None:
            t = place.wrap(t, shape, axes[name])
        out[name] = nn.Parameter(t, requires_grad=requires_grad)
    return out


def _draw(t: torch.Tensor, shape, scale: float, gen, box=None) -> None:
    """Normals of ``scale`` for a tensor of ``shape`` into ``t``: its whole
    (``box`` ``None``) or the ``(offsets, local shape)`` box of it."""
    rows = shape[0] if len(shape) > 1 else 1
    cols = t.numel() // max(1, t.shape[0]) if box is None and len(shape) > 1 \
        else (int(torch.Size(shape[1:]).numel()) if len(shape) > 1
              else shape[0])
    step = max(1, (1 << 26) // max(1, cols))
    for i in range(0, rows, step):
        n = min(step, rows - i)
        blk = torch.randn((n, cols), generator=gen, dtype=torch.float32,
                          device=t.device).mul_(scale)
        if box is None:
            (t.view(rows, -1) if len(shape) > 1 else t.view(1, -1))[
                i:i + n].copy_(blk)
            continue
        off, loc = box
        whole = blk.view(n, *shape[1:]) if len(shape) > 1 else blk.view(-1)
        if len(shape) > 1:
            lo, hi = max(i, off[0]), min(i + n, off[0] + loc[0])
            if lo >= hi:
                continue
            part = whole[lo - i:hi - i]
            dst = t[lo - off[0]:hi - off[0]]
            dims = range(1, len(shape))
        else:
            part, dst, dims = whole, t, range(0, 1)
        for d in dims:
            part = part.narrow(d, off[d], loc[d])
        dst.copy_(part)


def _ein(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``einsum`` with JAX's promotion (bf16 x fp32 -> fp32), TF32 off.
    A weight split over the data axes (FSDP) is gathered for the product.
    """
    ops = [gathered(o) if isinstance(o, nn.Parameter) else o for o in ops]
    dt = functools.reduce(torch.promote_types, (o.dtype for o in ops))
    with ieee_fp32():
        return torch.einsum(eq, *(o.to(dt) for o in ops))


def _rms_norm_fwd(x, gamma, eps):
    x32 = x.float()
    rstd = torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    return (x32 * rstd * (1.0 + gamma.float())).to(x.dtype), rstd


def _rms_norm_bwd(x, rstd, gamma, g):
    x32, g32 = x.float(), g.float()
    xhat = x32 * rstd
    dxhat = g32 * (1.0 + gamma.float())
    dgamma = (g32 * xhat).sum(dim=tuple(range(x.dim() - 1))).to(gamma.dtype)
    dx = rstd * (dxhat - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return dx.to(x.dtype), dgamma


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, eps):
        out, rstd = _rms_norm_fwd(x, gamma, eps)
        ctx.save_for_backward(x, rstd, gamma)
        return out

    @staticmethod
    def backward(ctx, g):
        dx, dgamma = _rms_norm_bwd(*ctx.saved_tensors, g)
        return dx, dgamma, None


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with a ``(1 + gamma)`` scale: fp32 math inside, x's dtype
    out.  The reference's hand-written VJP: the backward keeps the fp32
    chain in one expression and returns ``dx`` in x's dtype, ``dgamma`` in
    gamma's; ``eps`` is not differentiated."""
    return _RMSNorm.apply(x, gamma, eps)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x (..., S, H, D) rotated by position; D even."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., :, None].float() * freq          # (..., S, half)
    sin = torch.sin(ang)[..., :, None, :]
    cos = torch.cos(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ------------------------------------------------------------------ embed

def embed_shapes(vocab: int, d_model: int, dtype) -> dict:
    return {"table": ((vocab, d_model), dtype, 0.02)}


EMBED_AXES = {"table": ("vocab", "embed")}


def embed_apply(params, tokens: torch.Tensor, rules=None) -> torch.Tensor:
    """The table's rows for ``tokens``.  On a mesh the lookup is
    vocab-parallel: each rank looks up the tokens in its own rows of the
    table (zeros for the others), a partial sum over the mesh dims that
    split the vocabulary, which the constraint finishes.  A table whose
    embed dim is split (FSDP) is gathered first, as on every use of a
    weight."""
    table = gathered(params["table"])
    if is_dtensor(table):
        out = _embed_sharded(tokens, table)
    else:
        out = F.embedding(tokens, table)
    return shard_constraint(out, rules, "batch", None, "act_embed")


def _embed_sharded(tokens, table):
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    rows = batch_placements(tokens)
    t_pl = tuple(Shard(0) if p == Shard(0) else Replicate()
                 for p in table.placements)
    if tuple(table.placements) != t_pl:
        table = table.redistribute(mesh, t_pl)
    out_pl = tuple(Partial() if tp == Shard(0) else r
                   for r, tp in zip(rows, t_pl))
    v0 = global_offset(table)[1][0]

    def local(tok, tab):
        ids = tok - v0
        hit = (ids >= 0) & (ids < tab.shape[0])
        out = F.embedding(ids.clamp(0, max(tab.shape[0] - 1, 0)), tab)
        return out * hit[..., None].to(out.dtype)
    return map_local(local, mesh, (rows, t_pl), out_pl)(
        tokens.redistribute(mesh, rows), table)


def unembed_apply(params, x: torch.Tensor, rules=None) -> torch.Tensor:
    logits = _ein("bsd,vd->bsv", x, params["table"])
    return shard_constraint(logits, rules, "batch", None, "act_vocab")


# ------------------------------------------------------------------ MLP

def mlp_shapes(d_model: int, d_ff: int, dtype, variant: str = "swiglu"):
    s_in, s_out = d_model ** -0.5, d_ff ** -0.5
    if variant == "gelu":           # classic 2-matrix MLP (Whisper, Granite)
        return {"wi": ((d_model, d_ff), dtype, s_in),
                "wo": ((d_ff, d_model), dtype, s_out)}
    return {"wi_gate": ((d_model, d_ff), dtype, s_in),
            "wi_up": ((d_model, d_ff), dtype, s_in),
            "wo": ((d_ff, d_model), dtype, s_out)}


def mlp_axes(variant: str = "swiglu") -> dict:
    if variant == "gelu":
        return {"wi": ("embed", "mlp"), "wo": ("mlp", "embed")}
    return {"wi_gate": ("embed", "mlp"), "wi_up": ("embed", "mlp"),
            "wo": ("mlp", "embed")}


def mlp_apply(params, x: torch.Tensor, rules=None) -> torch.Tensor:
    if "wi" in params:              # gelu variant (jax.nn.gelu is tanh)
        h = F.gelu(_ein("bsd,df->bsf", x, params["wi"]), approximate="tanh")
    else:
        h = F.silu(_ein("bsd,df->bsf", x, params["wi_gate"])) \
            * _ein("bsd,df->bsf", x, params["wi_up"])
    h = shard_constraint(h, rules, "batch", None, "act_mlp")
    out = _ein("bsf,fd->bsd", h, params["wo"])
    return shard_constraint(out, rules, "batch", None, "act_embed")


# ------------------------------------------------------------ GQA attention

@dataclasses.dataclass(frozen=True)
class AttnSpec:
    num_heads: int
    num_kv_heads: int
    head_dim: int
    window: int = 0            # 0 = full attention
    causal: bool = True
    rope_theta: float = 10000.0
    use_rope: bool = True


def attn_shapes(d_model: int, spec: AttnSpec, dtype) -> dict:
    H, Hkv, D = spec.num_heads, spec.num_kv_heads, spec.head_dim
    s = d_model ** -0.5
    return {"wq": ((d_model, H, D), dtype, s),
            "wk": ((d_model, Hkv, D), dtype, s),
            "wv": ((d_model, Hkv, D), dtype, s),
            "wo": ((H, D, d_model), dtype, (H * D) ** -0.5)}


ATTN_AXES = {"wq": ("embed", "heads", "head_dim"),
             "wk": ("embed", "kv_heads", "head_dim"),
             "wv": ("embed", "kv_heads", "head_dim"),
             "wo": ("heads", "head_dim", "embed")}


def _grouped_attention(q, k, v, *, causal, window, q_pos, kv_len,
                       rules=None, probs_dtype=torch.float32):
    """q (B,S,H,D), k/v (B,Skv,Hkv,D) without repeating KV heads.

    q_pos: (S,) global positions of queries; keys occupy positions [0, Skv)
    masked by kv_len.  Softmax in fp32.  On a mesh (DTensor q) each rank
    attends with its own (batch, head) block (:func:`_sharded_attention`).
    """
    if is_dtensor(q):
        return shard_constraint(
            _sharded_attention(q, k, v, causal=causal, window=window,
                               q_pos=q_pos, kv_len=kv_len,
                               probs_dtype=probs_dtype),
            rules, "batch", None, "act_heads", "head_dim")
    B, S, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, S, Hkv, G, D)
    with ieee_fp32():
        scores = torch.einsum("bshgd,bthd->bhgst", qg.float(),
                              k.float()) * D ** -0.5   # (B,Hkv,G,S,Skv)
    kv_pos = torch.arange(Skv, device=q.device)
    mask = (kv_pos < kv_len)[None, None, None, None, :]
    rel = q_pos[:, None] - kv_pos[None, :]                   # (S, Skv)
    if causal:
        mask = mask & (rel >= 0)
    if window and window > 0:
        mask = mask & (rel < window)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(probs_dtype)
    with ieee_fp32():
        out = torch.einsum("bhgst,bthd->bshgd", probs, v.to(probs_dtype))
    return out.reshape(B, S, H, D).to(q.dtype)


def _sharded_attention(q, k, v, *, causal, window, q_pos, kv_len,
                       probs_dtype):
    """:func:`_grouped_attention` of DTensors, on each rank's own batch
    rows and query heads (``per_head``: a query head reads the KV head of
    its GLOBAL index).  Keys split by position (a sequence-sharded cache)
    stay where they are: the queries are gathered over those mesh dims,
    each rank attends over its own keys, and the softmax is finished with
    a max and two sums over those dims (the flash-decoding merge)."""
    from torch.distributed.tensor import Replicate, Shard
    seq_dims = [i for i, p in enumerate(k.placements) if p == Shard(1)]
    kw = dict(causal=causal, window=window, q_pos=q_pos, kv_len=kv_len,
              probs_dtype=probs_dtype)
    if not seq_dims:
        return per_head(_grouped_attention, q, k, v, **kw)
    mesh = k.device_mesh
    q = q.redistribute(mesh, [Replicate() if i in seq_dims else p
                              for i, p in enumerate(q.placements)])
    return per_head(_merged_attention, q, k, v, split_seq=seq_dims,
                    kv_off=global_offset(k)[1][1], mesh=mesh,
                    seq_dims=seq_dims, **kw)


def _merged_attention(q, k, v, *, causal, window, q_pos, kv_len,
                      probs_dtype, kv_off, mesh, seq_dims):
    """Attention of local queries over this rank's keys (global positions
    from ``kv_off``), merged with the other ranks over ``seq_dims``."""
    import torch.distributed._functional_collectives as funcol

    def reduce(t, op):
        for i in seq_dims:
            t = funcol.wait_tensor(funcol.all_reduce(t, op, (mesh, i)))
        return t
    B, S, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, S, Hkv, G, D)
    with ieee_fp32():
        scores = torch.einsum("bshgd,bthd->bhgst", qg.float(),
                              k.float()) * D ** -0.5
    kv_pos = kv_off + torch.arange(Skv, device=q.device)
    mask = (kv_pos < kv_len)[None, None, None, None, :]
    rel = q_pos[:, None] - kv_pos[None, :]
    if causal:
        mask = mask & (rel >= 0)
    if window and window > 0:
        mask = mask & (rel < window)
    scores = torch.where(mask, scores, NEG_INF)
    m = reduce(scores.amax(dim=-1, keepdim=True), "max")
    p = torch.exp(scores - m)
    den = reduce(p.sum(dim=-1, keepdim=True), "sum")      # (B,Hkv,G,S,1)
    with ieee_fp32():
        out = torch.einsum("bhgst,bthd->bshgd", p.to(probs_dtype),
                           v.to(probs_dtype)).float()
    out = reduce(out, "sum") / den.permute(0, 3, 1, 2, 4)
    return out.reshape(B, S, H, D).to(q.dtype)



def _kv_quantize(t: torch.Tensor):
    """Symmetric per-(token, head) int8: t (B,S,H,D) -> (int8, f32 scale).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    t32 = t.float()
    amax = t32.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(t32 / scale), -127, 127)
    return q.to(torch.int8), scale[..., 0]


def _kv_dequantize(q: torch.Tensor, scale: torch.Tensor, dtype):
    return (q.float() * scale[..., None]).to(dtype)


def attn_apply(params, x: torch.Tensor, spec: AttnSpec, rules=None, *,
               cache: Optional[dict] = None,
               positions: Optional[torch.Tensor] = None,
               use_kernels: bool = True,
               kv_src: Optional[torch.Tensor] = None,
               probs_dtype=torch.float32):
    """Self-attention, or cross-attention when ``kv_src`` (the encoder's
    output, (B, S_enc, d)) gives the keys and values; only the queries,
    and the keys of self-attention, are RoPE'd.  cache: ``{'k','v': (B,
    Smax, Hkv, D), 'len': int}`` (plus ``'k_scale'``/``'v_scale'`` when
    int8) — decode writes at 'len', in place.  Without a cache a causal
    layer goes through the flash kernel when ``use_kernels``; a non-causal
    one (the encoder, cross-attention) never does, as in the reference.
    On a mesh the kernel runs on each rank's own query heads (and the KV
    heads they read), and the cache write lands on the ranks that hold
    the written rows.  Returns (y, new_cache)."""
    S = x.shape[1]
    src = x if kv_src is None else kv_src
    q = _ein("bsd,dhk->bshk", x, params["wq"])
    q = shard_constraint(q, rules, "batch", None, "act_heads", "head_dim")
    k = _ein("bsd,dhk->bshk", src, params["wk"])
    v = _ein("bsd,dhk->bshk", src, params["wv"])
    if positions is None:
        positions = torch.arange(S, device=x.device)
    if spec.use_rope:
        q = rope(q, positions, spec.rope_theta)
        if kv_src is None:
            k = rope(k, positions, spec.rope_theta)

    new_cache = None
    if cache is not None:
        # decode: write this step's k/v at index cache['len'].  Windowed
        # layers use a RING buffer of size `window` (allocated that way by
        # attn_init_cache): absolute position -> slot pos % window.  Keys are
        # RoPE'd with absolute positions before writing, so ring entries stay
        # valid; every live slot is inside the window by construction, which
        # replaces the causal/window mask with a plain validity mask.
        idx = int(cache["len"])
        cache_len = cache["k"].shape[1]
        ring = spec.window > 0 and cache_len <= spec.window
        write_idx = (idx % cache_len) if ring else idx
        # lax.dynamic_update_slice clamps the start so the update fits
        start = max(0, min(write_idx, cache_len - S))
        at = slice(start, start + S)
        if cache["k"].dtype == torch.int8:
            kq, ks = _kv_quantize(k)
            vq, vs = _kv_quantize(v)
            write_rows(cache["k"], kq, at)
            write_rows(cache["v"], vq, at)
            write_rows(cache["k_scale"], ks, at)
            write_rows(cache["v_scale"], vs, at)
            new_cache = {**cache, "len": idx + S}
            k = _kv_dequantize(cache["k"], cache["k_scale"], x.dtype)
            v = _kv_dequantize(cache["v"], cache["v_scale"], x.dtype)
        else:
            write_rows(cache["k"], k.to(cache["k"].dtype), at)
            write_rows(cache["v"], v.to(cache["v"].dtype), at)
            new_cache = {**cache, "len": idx + S}
            k, v = cache["k"], cache["v"]
        k = shard_constraint(k, rules, "batch", "seq_shard", None, None)
        v = shard_constraint(v, rules, "batch", "seq_shard", None, None)
        out = _grouped_attention(
            q, k, v, causal=spec.causal and not ring,
            window=0 if ring else spec.window, q_pos=positions,
            kv_len=min(idx + S, cache_len), rules=rules,
            probs_dtype=probs_dtype)
    elif use_kernels and spec.causal:
        out = per_head(flash_ops.mha, q, k, v, causal=True,
                       window=spec.window, use_kernel=True)
    else:
        out = _grouped_attention(
            q, k, v, causal=spec.causal, window=spec.window,
            q_pos=positions, kv_len=k.shape[1], rules=rules,
            probs_dtype=probs_dtype)

    y = _ein("bshk,hkd->bsd", out, params["wo"])
    return shard_constraint(y, rules, "batch", None, "act_embed"), new_cache


def attn_init_cache(batch: int, max_len: int, spec: AttnSpec, dtype,
                    device, kv_quant: str = "none") -> dict:
    Hkv, D = spec.num_kv_heads, spec.head_dim
    if spec.window > 0:
        max_len = min(max_len, spec.window)   # ring buffer for SWA layers
    shape = (batch, max_len, Hkv, D)
    if kv_quant == "int8":
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:3], dtype=torch.float32,
                                   device=device),
            "v_scale": torch.zeros(shape[:3], dtype=torch.float32,
                                   device=device),
            "len": 0,
        }
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": 0}
