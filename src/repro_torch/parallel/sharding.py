"""Logical-axis sharding over a ``DeviceMesh`` (port of
``repro.parallel.sharding``).

Model code tags every parameter and key activation with *logical* axis
names ('embed', 'heads', 'mlp', 'vocab', 'experts', 'batch', 'seq', ...).
A rules table maps logical names to mesh axes; changing the parallelism
layout is a rules edit, not a model edit.  The same model runs on the
16x16 single-pod mesh, the 2x16x16 multi-pod mesh and a one-rank mesh.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose
``mesh_dim_names`` are the reference's axis names ('pod', 'data',
'model', 'stage').  :func:`logical_to_spec` returns the reference's
``PartitionSpec`` entries as a tuple (``None``, an axis name, or a tuple
of axis names); :func:`placements` turns such a spec into the DTensor
placements on a mesh: ``Shard(d)`` on every mesh dim of size > 1 that
tensor dim ``d`` names, ``Replicate()`` on the others.  A ``('pod',
'data')`` entry shards one tensor dim over two mesh dims, 'pod'
outermost, which is the reference's device order.

Layouts provided:
  * TP        — heads / mlp / vocab / experts over 'model'
  * FSDP      — additionally shard the embed dim of big params over 'data'
                (+ 'pod'), gathered on use (ZeRO-3)
  * SP        — long-context: KV-cache sequence dim over 'model'
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

__all__ = [
    "ShardingRules", "LOGICAL_RULES_BASE", "logical_to_spec",
    "shard_constraint", "named_sharding", "placements", "check_even",
]

# logical name -> preferred mesh axes (first existing axis wins; tuples mean
# shard over multiple axes jointly)
LOGICAL_RULES_BASE: dict[str, tuple] = {
    # data / activation dims
    "batch": (("pod", "data"),),
    "seq": (None,),
    "seq_shard": ("model",),       # sequence-parallel KV cache (long context)
    "act_embed": (None,),
    "act_heads": ("model",),
    "act_mlp": ("model",),
    "act_vocab": ("model",),
    "act_embed_tp": ("model",),    # d_model sharded over TP (RS+AG regions)
    # parameter dims
    "embed": (None,),              # FSDP layout overrides to ('data',)
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (None,),
    "mlp": ("model",),
    "vocab": ("model",),
    "experts": ("model",),         # EP
    "conv": (None,),
    "ssm_state": (None,),
    "ssm_heads": ("model",),
    "layers": (None,),             # scan dim — never sharded
    "stage": ("stage",),           # pipeline stage dim (PP meshes only)
}


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    rules: tuple                      # tuple of (logical, axes) pairs
    mesh_axis_names: tuple

    @staticmethod
    def create(mesh, *, fsdp: bool = False, ep: bool = True,
               seq_shard_decode: bool = False,
               extra: Optional[dict] = None) -> "ShardingRules":
        """Rules for ``mesh`` (a ``DeviceMesh``; its ``mesh_dim_names``
        are the axis names)."""
        table = dict(LOGICAL_RULES_BASE)
        if fsdp:
            # ZeRO-3: embed dims of params sharded over the data axes too
            table["embed"] = (("pod", "data"),)
        if not ep:
            table["experts"] = (None,)
        if extra:
            table.update(extra)
        return ShardingRules(rules=tuple(table.items()),
                             mesh_axis_names=tuple(mesh.mesh_dim_names))

    def spec(self, *logical: Optional[str]) -> tuple:
        return logical_to_spec(self, logical)


def _resolve(rules: ShardingRules, name: Optional[str]):
    if name is None:
        return None
    table = dict(rules.rules)
    if name not in table:
        return None
    for cand in table[name]:
        if cand is None:
            return None
        if isinstance(cand, tuple):
            present = tuple(a for a in cand if a in rules.mesh_axis_names)
            if present:
                return present if len(present) > 1 else present[0]
            continue
        if cand in rules.mesh_axis_names:
            return cand
    return None


def logical_to_spec(rules: ShardingRules,
                    logical: Sequence[Optional[str]]) -> tuple:
    """One entry per tensor dim: ``None``, a mesh axis name, or a tuple of
    them, as the reference's ``PartitionSpec``.  A mesh axis is used at
    most once: a later dim that names a used axis is not sharded."""
    resolved, used = [], set()
    for name in logical:
        axis = _resolve(rules, name)
        if axis is not None:
            flat = axis if isinstance(axis, tuple) else (axis,)
            if any(a in used for a in flat):
                axis = None
            else:
                used.update(flat)
        resolved.append(axis)
    return tuple(resolved)


def placements(mesh, spec: Sequence) -> tuple:
    """DTensor placements of ``spec`` (a :func:`logical_to_spec` tuple) on
    ``mesh``: ``Shard(d)`` on each mesh dim that entry ``d`` names,
    ``Replicate()`` on the rest.  A mesh dim of size 1 is ``Replicate()``
    whatever the spec names: its one rank holds the whole dim either way,
    and DTensor refuses to view away a size-1 tensor dim (global batch 1,
    Granite's one KV head) that is ``Shard`` there, where the reference's
    ``PartitionSpec`` is only a layout."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    sizes = tuple(mesh.mesh.shape)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            i = names.index(axis)
            if sizes[i] > 1:
                out[i] = Shard(d)
    return tuple(out)


def check_even(shape, mesh, placements_, logical=()) -> None:
    """Raise ``ValueError`` where ``placements_`` split a dim of ``shape``
    unevenly: a dim the sizes of the mesh dims that shard it do not
    divide (global batch 1 over 'data' of 2).  The reference refuses such
    an argument (its jit's ``in_shardings``), and ``local_map`` would give
    each rank a global shape of its own local rows times the split."""
    from torch.distributed.tensor import Shard
    names, sizes = tuple(mesh.mesh_dim_names), tuple(mesh.mesh.shape)
    for d in range(len(shape)):
        on = [i for i, p in enumerate(placements_) if p == Shard(d)]
        n = 1
        for i in on:
            n *= sizes[i]
        if shape[d] % n:
            name = logical[d] if d < len(logical) else None
            raise ValueError(
                f"dim {d} ({name!r}) of size {shape[d]} does not divide "
                f"over mesh axes {tuple(names[i] for i in on)} of "
                f"{n} ranks: the reference refuses an uneven split too")


def shard_constraint(x, rules: Optional[ShardingRules],
                     *logical: Optional[str]):
    """``x`` redistributed to the placements of ``logical`` on its own
    mesh.  A plain tensor (no mesh), or ``rules`` of ``None``, passes
    through unchanged, as the reference's constraint is a no-op off a
    mesh."""
    from torch.distributed.tensor import DTensor
    if rules is None or not isinstance(x, DTensor):
        return x
    want = placements(x.device_mesh, logical_to_spec(rules, logical))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def named_sharding(mesh, rules: ShardingRules,
                   *logical: Optional[str]) -> tuple:
    """``(mesh, placements)`` of ``logical``: the reference's
    ``NamedSharding``."""
    return mesh, placements(mesh, logical_to_spec(rules, logical))
