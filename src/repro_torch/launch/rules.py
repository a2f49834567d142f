"""Per-(arch, mesh, flags) sharding-rule derivation (port of
``repro.launch.rules``).

The logical rules table is adjusted for divisibility: a logical dim only
shards over 'model' when the arch's dimension divides the axis (e.g.
Gemma-3's 8 query heads cannot shard over TP=16 — its TP parallelism comes
from d_ff/vocab/head_dim instead; Granite's single KV head is replicated).
"""

from __future__ import annotations

from ..configs.base import ArchConfig
from ..models.configs_runtime import RuntimeFlags
from ..parallel.sharding import ShardingRules
from .mesh import mesh_axis_sizes

__all__ = ["rules_for", "cache_logical_axes"]


def rules_for(cfg: ArchConfig, mesh, flags: RuntimeFlags) -> ShardingRules:
    sizes = mesh_axis_sizes(mesh)
    tp = sizes.get("model", 1)
    extra: dict = {}
    if cfg.num_heads % tp:
        extra["heads"] = (None,)
        extra["act_heads"] = (None,)
    if cfg.num_kv_heads % tp:
        extra["kv_heads"] = (None,)
    if cfg.num_experts and cfg.num_experts % tp:
        extra["experts"] = (None,)
    if cfg.d_ff and cfg.d_ff % tp:
        extra["mlp"] = (None,)
        extra["act_mlp"] = (None,)
    if cfg.ssm_state:
        H = cfg.mamba_meta()["H"]
        if H % tp:
            extra["ssm_heads"] = (None,)
    if flags.seq_shard_decode and flags.seq_shard_axes == "all":
        # long-context decode: KV sequence sharded over every mesh axis
        # (batch=1 leaves 'data' idle otherwise)
        extra["seq_shard"] = (("pod", "data", "model"),)
        extra["batch"] = (None,)
    elif flags.seq_shard_decode:
        # decode with kv_heads % tp != 0: the cache would replicate over
        # 'model' — shard its sequence dim there instead (batch stays on
        # the data axes)
        extra["seq_shard"] = ("model",)
    else:
        extra["seq_shard"] = (None,)
    return ShardingRules.create(mesh, fsdp=flags.fsdp, extra=extra)


# keyed by cache-leaf name: logical axes of the trailing dims
_CACHE_AXES = {
    "k": ("batch", "seq_shard", "kv_heads", None),
    "v": ("batch", "seq_shard", "kv_heads", None),
    "k_scale": ("batch", "seq_shard", "kv_heads"),
    "v_scale": ("batch", "seq_shard", "kv_heads"),
    "h": ("batch", "ssm_heads", None, None),
    "conv_x": ("batch", None, "act_mlp"),
    "conv_b": ("batch", None, None),
    "conv_c": ("batch", None, None),
    "len": (),
}


def _leaf_axes(name: str, leaf) -> tuple:
    nd = len(getattr(leaf, "shape", ()))
    tail = _CACHE_AXES.get(name)
    if tail is None:
        return (None,) * nd
    return (None,) * (nd - len(tail)) + tuple(tail)


def cache_logical_axes(cache):
    """The port's decode cache (``LMModel.init_cache``: a list of per-layer
    ``{'mixer': {...}}`` dicts) mirrored with logical-axis tuples, leaf by
    leaf from ``_CACHE_AXES``.  The port's layers are not stacked, so a
    leaf gets no leading ``None``; ``'len'`` (a Python int) gets ``()``."""
    def walk(node, name=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return _leaf_axes(name, node)
    return walk(cache)
