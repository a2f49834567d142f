"""Fault-tolerant checkpointing: atomic, versioned, restore onto any device
(port of ``repro.train.checkpoint``, same on-disk layout).

Layout:  <dir>/step_<N>/{manifest.json, arrays.npz}, written to a temp dir
and atomically renamed, so a crash mid-save never corrupts the latest
checkpoint; the newest ``keep`` are kept.  Keys are the state tree's paths
joined by ``/``; bf16 arrays are stored as their ``uint16`` bits (npz has
no bf16) and the manifest records each array's dtype.  ``restore`` places
the tensors on the caller's device, or with ``shardings`` re-places them
as DTensors on a mesh (any mesh: the one that saved them or another, the
reference's elastic restore).  A state of DTensors is saved whole
(``full_tensor()``, every rank takes part) and written by rank 0, in the
same layout.

An LM train state is saved in the REFERENCE's tree
(:func:`state_to_reference`: scanned layers stacked along ``n_blocks``, as
``repro.models.LMModel.init`` lays them out) and read back with
:func:`state_from_reference`, so a checkpoint written by either package
restores in the other.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device
from ..models.lm import LMModel, distribute_tensor, \
    export_reference_params, load_reference_params, named_from_reference, \
    reference_paths
from ..parallel.local import is_dtensor, whole

__all__ = ["CheckpointManager", "state_to_reference", "state_from_reference",
           "reference_shardings"]


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat):
    tree: dict = {}
    for k, v in flat.items():
        parts = k.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _to_numpy(v) -> tuple[np.ndarray, str]:
    """(array as stored, dtype name): bf16 becomes its uint16 bits."""
    t = torch.as_tensor(v).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, state, extra: Optional[dict] = None) -> str:
        """Write ``state`` (a nested dict of tensors or arrays) as step
        ``step``; returns the checkpoint's directory.  DTensor leaves are
        gathered whole on every rank; rank 0 writes, and every rank waits
        until it has."""
        flat = _flatten(state)
        sharded = any(is_dtensor(v) for v in flat.values())
        flat = {k: whole(v) for k, v in flat.items()}
        final = os.path.join(self.directory, f"step_{step:08d}")
        if sharded and dist.get_rank() != 0:
            dist.barrier()
            return final
        try:
            return self._write(step, flat, extra, final)
        finally:
            if sharded:
                dist.barrier()

    def _write(self, step, flat, extra, final) -> str:
        arrays, dtypes = {}, {}
        for k, v in flat.items():
            arrays[k], dtypes[k] = _to_numpy(v)
        manifest = {
            "step": int(step),
            "time": time.time(),
            "keys": sorted(arrays),
            "dtypes": dtypes,
            "shapes": {k: list(a.shape) for k, a in arrays.items()},
            "extra": extra or {},
        }
        tmp = tempfile.mkdtemp(dir=self.directory, prefix=".tmp_")
        try:
            np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)          # atomic publish
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()
        return final

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.directory, name, "manifest.json")):
                steps.append(int(name.split("_")[1]))
        return max(steps) if steps else None

    def restore(self, step: Optional[int] = None, *, device=None,
                template=None, shardings=None):
        """Load a checkpoint (the latest when ``step`` is None) as a tree
        of tensors on ``device`` (``None`` means CUDA), cast to the dtypes
        of ``template``'s leaves where it has them.  ``shardings``, a tree
        of ``(mesh, placements)`` keyed like the saved state (the leaves
        it lacks stay whole), re-places each leaf as a DTensor on its
        mesh, which need not be the one that saved it.  Returns ``(state,
        manifest)``, or ``(None, None)`` when there is no checkpoint."""
        dev = resolve_device(device)
        if step is None:
            step = self.latest_step()
            if step is None:
                return None, None
        path = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        want = _flatten(template) if template is not None else {}
        flat = {}
        with np.load(os.path.join(path, "arrays.npz")) as data:
            for k in manifest["keys"]:
                a = data[k]
                if manifest["dtypes"].get(k) == "bfloat16":
                    t = torch.from_numpy(a.view(np.int16)).view(
                        torch.bfloat16)
                else:
                    t = torch.from_numpy(a)
                if k in want:
                    t = t.to(want[k].dtype)
                flat[k] = t.to(dev)
        if shardings is not None:
            for k, (mesh, pl) in _flatten_shardings(shardings).items():
                flat[k] = distribute_tensor(flat[k], mesh, pl)
        return _unflatten(flat), manifest

    # -------------------------------------------------------------------- gc
    def _gc(self):
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.directory)
            if n.startswith("step_"))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)


def _flatten_shardings(tree, prefix="") -> dict:
    """``{'a/b': (mesh, placements)}`` of a shardings tree, whose leaves
    are ``(mesh, placements)`` pairs."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten_shardings(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def reference_shardings(model: LMModel, state_shardings: dict,
                        mesh) -> dict:
    """A train state's placements (``train.make_state_shardings``, keyed by
    parameter name) as ``restore(shardings=)`` takes them for a checkpoint
    in the reference's tree: a scanned layer's stacked leaf keeps its
    leading ``n_blocks`` axis whole, so each ``Shard(d)`` becomes
    ``Shard(d + 1)`` there.  Stacked layers share one leaf: their
    placements must agree, as the reference's stacked specs do."""
    def tree(pl_by_name):
        out: dict = {}
        for name, (path, blk) in reference_paths(model).items():
            pl = tuple(type(p)(p.dim + 1) if blk is not None and
                       hasattr(p, "dim") else p for p in pl_by_name[name])
            *parents, key = path.split("/")
            node = out
            for p in parents:
                node = node.setdefault(p, {})
            if node.get(key, (mesh, pl)) != (mesh, pl):
                raise ValueError(f"{path}: its layers are placed apart")
            node[key] = (mesh, pl)
        return out
    return {"params": tree(state_shardings["params"]),
            "opt": {k: tree(state_shardings["opt"][k]) for k in ("m", "v")},
            "step": (mesh, state_shardings["step"])}


def state_to_reference(model: LMModel, state: dict) -> dict:
    """A train state (``train.init_state``'s layout) in the reference's
    tree: parameters and both moments through ``export_reference_params``,
    the step as it is."""
    return {"params": export_reference_params(model, state["params"]),
            "opt": {k: export_reference_params(model, state["opt"][k])
                    for k in ("m", "v")},
            "step": state["step"]}


def state_from_reference(model: LMModel, tree: dict) -> dict:
    """The inverse of :func:`state_to_reference` into ``model``: its
    parameters are filled from ``tree['params']`` (and made trainable);
    the moments are the tree's own tensors, moved to the model's device;
    the step an int32 scalar there.  On a model put on a mesh the moments
    are placed by ``train.make_state_shardings`` (``flags.zero1``),
    whether the tree's leaves are whole tensors or DTensors of another
    placement."""
    load_reference_params(model, tree["params"])
    model.requires_grad_(True)
    dev = model.device
    mesh = model.mesh
    sh = None
    if mesh is not None:
        from .train_step import make_state_shardings
        sh = make_state_shardings(model, mesh, model.rules,
                                  zero1=model.flags.zero1)

    def moment(k, n, t):
        if sh is None:
            return t.to(dev)
        pl = sh["opt"][k][n]
        if is_dtensor(t):
            return t.redistribute(mesh, pl)
        return distribute_tensor(t.to(dev), mesh, pl)
    return {"params": dict(model.named_parameters()),
            "opt": {k: {n: moment(k, n, t) for n, t in named_from_reference(
                model, tree["opt"][k]).items()} for k in ("m", "v")},
            "step": torch.tensor(int(whole(tree["step"])), dtype=torch.int32,
                                 device=dev)}
