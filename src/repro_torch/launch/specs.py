"""Meta-tensor stand-ins for every (arch x shape) cell and the cell's
flags (port of ``repro.launch.specs``).

``input_specs(cfg, shape_name, flags)`` returns the exact inputs a train
or serve step takes, as meta tensors (shape and dtype, nothing
allocated), which is what the LM dry run (``launch.dryrun``) runs
against.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import SHAPES, ArchConfig
from ..models.configs_runtime import RuntimeFlags

__all__ = ["input_specs", "shape_applicable", "default_flags"]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def shape_applicable(cfg: ArchConfig, shape_name: str) -> tuple[bool, str]:
    """Whether this (arch, shape) cell runs; reason string if skipped."""
    seq, batch, kind = SHAPES[shape_name]
    if shape_name == "long_500k" and not cfg.subquadratic:
        return False, ("full-attention arch: 500k-token KV decode is "
                       "excluded per assignment (no sub-quadratic path)")
    return True, ""


def default_flags(cfg: ArchConfig, shape_name: str,
                  mesh=None) -> RuntimeFlags:
    """Baseline runtime flags per cell (the reference's, documented in
    DESIGN.md).  ``use_pallas=False``: the dry run counts the reference's
    non-kernel program, so the flags equal the reference's field for
    field."""
    seq, batch, kind = SHAPES[shape_name]
    big = cfg.param_count() > 100e9
    tp = 16 if mesh is None else dict(
        zip(mesh.mesh_dim_names, mesh.mesh.shape)).get("model", 1)
    long_ctx = kind == "decode" and seq >= 2 ** 19
    # decode caches with kv_heads % tp != 0 would replicate over 'model';
    # shard their sequence dim there instead
    kv_rep = kind == "decode" and cfg.num_kv_heads % tp != 0 \
        and cfg.family != "ssm"
    return RuntimeFlags(
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat="full" if kind == "train" else "none",
        use_pallas=False,
        fsdp=big,
        seq_shard_decode=long_ctx or kv_rep,
        seq_shard_axes="all" if long_ctx else "model",
        capacity_factor=1.25 if kind == "train" else 1.5,
    )


def input_specs(cfg: ArchConfig, shape_name: str,
                flags: Optional[RuntimeFlags] = None, seq_batch=None) -> dict:
    """Meta batch for the step of this shape.

    train/prefill: token batch (prefill runs the same teacher-forced
    forward used for scoring; its FLOPs profile equals inference prefill).
    decode: one-token step against a seq_len KV cache; ``pos`` is a 0-d
    int32 tensor.  ``seq_batch`` (``(seq, global batch)``) replaces the
    shape's own."""
    seq, batch, kind = SHAPES[shape_name]
    if seq_batch is not None:
        seq, batch = seq_batch
    if flags is None:
        flags = default_flags(cfg, shape_name)
    it = torch.int32
    if kind in ("train", "prefill"):
        s_text = seq - (cfg.num_frontend_tokens
                        if cfg.frontend == "vision" else 0)
        specs = {
            "tokens": _meta((batch, s_text), it),
            "targets": _meta((batch, s_text), it),
            "mask": _meta((batch, s_text), torch.float32),
        }
        if cfg.frontend == "vision":
            specs["image_embeds"] = _meta(
                (batch, cfg.num_frontend_tokens, cfg.d_model), flags.cdtype)
        if cfg.frontend == "audio":
            specs["audio_embeds"] = _meta(
                (batch, cfg.encoder_seq, cfg.d_model), flags.cdtype)
        return specs
    specs = {
        "tokens": _meta((batch, 1), it),
        "pos": _meta((), it),
    }
    if cfg.frontend == "audio":
        specs["enc_out"] = _meta(
            (batch, cfg.encoder_seq, cfg.d_model), flags.cdtype)
    return specs
