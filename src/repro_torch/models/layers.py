"""Primitive layers: norm, RoPE, GQA attention (+KV cache), MLP, embedding
(port of ``repro.models.layers``).

Parameters keep the reference's names and layouts (``wq (d, H, D)``,
``wo (H, D, d)``, ...), so carrying weights across is a copy; each
``*_shapes`` function lists a module's parameters with their dtypes and
init scales, and :func:`make_params` allocates and fills them on a device
from a ``torch.Generator`` (the same scales as the reference's init, not
the same numbers).  Sharding constraints are dropped: the port runs on one
card.  Matrix products promote their operands as JAX's ``einsum`` does.

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

__all__ = ["AttnSpec", "make_params", "rms_norm", "rope", "embed_shapes",
           "embed_apply", "unembed_apply", "mlp_shapes", "mlp_apply",
           "attn_shapes", "attn_apply", "attn_init_cache"]

# ---------------------------------------------------------------- utilities


def make_params(shapes: dict, device, gen: torch.Generator,
                requires_grad: bool = False) -> nn.ParameterDict:
    """``{name: (shape, dtype, init)}`` -> parameters on ``device``; init is
    a normal scale, ``"zeros"`` or ``"ones"``.  Normals are drawn in fp32
    and cast, as the reference's ``_normal`` does, a slab at a time so a
    full-width expert stack never needs a whole fp32 copy.  Serving keeps
    ``requires_grad=False``; training turns it on."""
    out = nn.ParameterDict()
    for name, (shape, dtype, init) in shapes.items():
        t = torch.empty(shape, dtype=dtype, device=device)
        if init == "zeros":
            t.zero_()
        elif init == "ones":
            t.fill_(1.0)
        else:
            flat = t.view(shape[0], -1) if len(shape) > 1 else t.view(1, -1)
            step = max(1, (1 << 26) // max(1, flat.shape[1]))
            for i in range(0, flat.shape[0], step):
                blk = flat[i:i + step]
                blk.copy_(torch.randn(blk.shape, generator=gen,
                                      dtype=torch.float32, device=device)
                          .mul_(init))
        out[name] = nn.Parameter(t, requires_grad=requires_grad)
    return out


def _ein(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``einsum`` with JAX's promotion (bf16 x fp32 -> fp32), TF32 off."""
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


def embed_apply(params, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, params["table"])


def unembed_apply(params, x: torch.Tensor) -> torch.Tensor:
    return _ein("bsd,vd->bsv", x, params["table"])


# ------------------------------------------------------------------ MLP

def mlp_shapes(d_model: int, d_ff: int, dtype, variant: str = "swiglu"):
    s_in, s_out = d_model ** -0.5, d_ff ** -0.5
    if variant == "gelu":           # classic 2-matrix MLP (Whisper, Granite)
        return {"wi": ((d_model, d_ff), dtype, s_in),
                "wo": ((d_ff, d_model), dtype, s_out)}
    return {"wi_gate": ((d_model, d_ff), dtype, s_in),
            "wi_up": ((d_model, d_ff), dtype, s_in),
            "wo": ((d_ff, d_model), dtype, s_out)}


def mlp_apply(params, x: torch.Tensor) -> torch.Tensor:
    if "wi" in params:              # gelu variant (jax.nn.gelu is tanh)
        h = F.gelu(_ein("bsd,df->bsf", x, params["wi"]), approximate="tanh")
    else:
        h = F.silu(_ein("bsd,df->bsf", x, params["wi_gate"])) \
            * _ein("bsd,df->bsf", x, params["wi_up"])
    return _ein("bsf,fd->bsd", h, params["wo"])


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


def _grouped_attention(q, k, v, *, causal, window, q_pos, kv_len,
                       probs_dtype=torch.float32):
    """q (B,S,H,D), k/v (B,Skv,Hkv,D) without repeating KV heads.

    q_pos: (S,) global positions of queries; keys occupy positions [0, Skv)
    masked by kv_len.  Softmax in fp32."""
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


def attn_apply(params, x: torch.Tensor, spec: AttnSpec, *,
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
    Returns (y, new_cache)."""
    S = x.shape[1]
    src = x if kv_src is None else kv_src
    q = _ein("bsd,dhk->bshk", x, params["wq"])
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
            cache["k"][:, at] = kq
            cache["v"][:, at] = vq
            cache["k_scale"][:, at] = ks
            cache["v_scale"][:, at] = vs
            new_cache = {**cache, "len": idx + S}
            k = _kv_dequantize(cache["k"], cache["k_scale"], x.dtype)
            v = _kv_dequantize(cache["v"], cache["v_scale"], x.dtype)
        else:
            cache["k"][:, at] = k.to(cache["k"].dtype)
            cache["v"][:, at] = v.to(cache["v"].dtype)
            new_cache = {**cache, "len": idx + S}
            k, v = cache["k"], cache["v"]
        out = _grouped_attention(
            q, k, v, causal=spec.causal and not ring,
            window=0 if ring else spec.window, q_pos=positions,
            kv_len=min(idx + S, cache_len), probs_dtype=probs_dtype)
    elif use_kernels and spec.causal:
        out = flash_ops.mha(q, k, v, causal=True, window=spec.window,
                            use_kernel=True)
    else:
        out = _grouped_attention(
            q, k, v, causal=spec.causal, window=spec.window,
            q_pos=positions, kv_len=k.shape[1], probs_dtype=probs_dtype)

    return _ein("bshk,hkd->bsd", out, params["wo"]), new_cache


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
