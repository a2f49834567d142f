"""Per-device FLOPs, HBM bytes and collective bytes of one eager step, op
by op (the counterpart of ``repro.launch.hlo_analysis``).

The reference reads these from the optimized XLA program's text: dots
and elementwise ops for FLOPs, every top-level op's operands and result
for HBM traffic (a fusion counts once), the collectives' result shapes
for moved bytes, with while-loop trip counts as multipliers.  Eager
PyTorch has no such program to read, so :class:`OpCounter`, a
``TorchDispatchMode``, watches the ops one step actually runs on THIS
rank's local tensors:

  * **FLOPs** — ``torch.utils.flop_counter``'s formulas (products,
    convolutions, attention) on the LOCAL shapes, plus one per output
    element of elementwise arithmetic, as the reference counts them.
    ``FlopCounterMode`` over DTensors counts the global work instead: this
    mode lets each DTensor op run (``NotImplemented``) and counts the local
    ops it issues.
  * **HBM bytes** — each op reads its tensor operands and writes its
    results once; views and metadata ops are free.  No fusion: an eager
    op is a kernel.  ``hbm_bytes_resident`` leaves out attention-score-like
    tensors (last two dims both >= 1024), the reference's ``_is_resident``
    rule for a flash kernel whose scores never leave the chip.
  * **Collectives** — bytes and calls by kind from the functional and
    c10d collective ops seen, in the reference's ring accounting
    (all-gather and all-to-all move result x (n-1)/n, all-reduce 2 x
    (n-1)/n, reduce-scatter its result, a send its tensor).

The shape inference DTensor runs on fake tensors is not counted, nor is
anything a fake mode runs.  Layers are not scanned here; the one loop a
step runs many times over the same shapes, the plain SSD scans' loop over
positions or chunks, runs ONE iteration on meta tensors under
:func:`repeated` (forward and backward, :func:`meta_repeat`), which
multiplies what it counts by the trip count: the reference's while-loop
multiplier.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["OpStats", "OpCounter", "count_ops", "tensor_bytes", "repeated",
           "meta_repeat"]

_SCALE = [1.0]


@contextlib.contextmanager
def repeated(n: int):
    """Every op counted inside counts ``n`` times (nested: multiplied)."""
    _SCALE.append(_SCALE[-1] * n)
    try:
        yield
    finally:
        _SCALE.pop()


class _MetaRepeat(torch.autograd.Function):
    """``n`` iterations of ``one`` on meta tensors, run once and counted
    ``n`` times, backward included; the result is an empty meta tensor of
    the full output's shape."""

    @staticmethod
    def forward(ctx, one, n, out_shape, sl, *args):
        ctx.one, ctx.n, ctx.sl = one, n, sl
        ctx.save_for_backward(*args)
        with repeated(n):
            one(*(a[s] for a, s in zip(args, sl)))
        return args[0].new_empty(out_shape)

    @staticmethod
    def backward(ctx, gy):
        args = ctx.saved_tensors
        parts = [a[s].detach().requires_grad_(a.is_floating_point())
                 for a, s in zip(args, ctx.sl)]
        with repeated(ctx.n), torch.enable_grad():
            y = ctx.one(*parts)
            need = [p for p in parts if p.requires_grad]
            torch.autograd.grad(y, need, y.new_empty(y.shape),
                                allow_unused=True)
        return (None, None, None, None,
                *(torch.empty_like(a) if a.is_floating_point() else None
                  for a in args))


def meta_repeat(one, n: int, out_shape, slices, *args):
    """``one(*(a[s] ...))``, the loop body on the first iteration's slices,
    counted ``n`` times; meta tensors only (the dry run)."""
    return _MetaRepeat.apply(one, n, tuple(out_shape), tuple(slices), *args)

_ELEMENTWISE = {"mul", "add", "sub", "div", "exp", "tanh", "rsqrt", "pow",
                "maximum", "minimum"}
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "allreduce_": "all-reduce",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter", "alltoall_base_": "all-to-all",
    "send": "collective-permute"}
_FREE = {"detach", "alias", "lift_fresh", "empty", "empty_strided",
         "empty_like", "sym_size", "sym_stride", "sym_numel",
         "_local_scalar_dense", "wait_tensor", "_wrap_tensor_autograd",
         "set_", "resize_"}


@dataclasses.dataclass
class OpStats:
    """One rank's counts (the reference's ``HloStats`` fields)."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    hbm_bytes_resident: float = 0.0
    collective_bytes: float = 0.0
    collective_by_kind: dict = dataclasses.field(default_factory=dict)
    collective_calls: dict = dataclasses.field(default_factory=dict)
    collective_ops: int = 0
    ops: int = 0


def tensor_bytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _is_resident(t: torch.Tensor, min_dim: int = 1024) -> bool:
    return t.dim() >= 2 and t.shape[-1] >= min_dim \
        and t.shape[-2] >= min_dim


def _group_size(args, kwargs) -> int:
    """The group size of a collective op's arguments (functional ops name
    their group; c10d ops carry the group object)."""
    import torch.distributed as dist
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, str):
            try:
                from torch.distributed.distributed_c10d import \
                    _resolve_process_group
                return dist.get_world_size(_resolve_process_group(a))
            except Exception:   # noqa: BLE001 — not a group name
                continue
        if isinstance(a, dist.ProcessGroup):
            return a.size()
    for a in args:
        if isinstance(a, int) and a > 0:
            return a
    return 1


class OpCounter(TorchDispatchMode):
    """Counts every local op run while it is active into ``stats``."""

    def __init__(self):
        super().__init__()
        self.stats = OpStats()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # let DTensor issue its local ops
        out = func(*args, **kwargs)
        if not self._counts(args, kwargs):
            return out
        self._count(func, args, kwargs, out)
        return out

    @staticmethod
    def _counts(args, kwargs) -> bool:
        """False for the shape inference DTensor runs on fake tensors."""
        from torch._subclasses.fake_tensor import FakeTensor
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            return False
        leaves, _ = tree_flatten((args, kwargs))
        return not any(isinstance(a, FakeTensor) for a in leaves)

    def _count(self, func, args, kwargs, out) -> None:
        st = self.stats
        k = _SCALE[-1]
        st.ops += 1
        name = func._overloadpacket.__name__
        ins = [a for a in tree_flatten((args, kwargs))[0]
               if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_flatten(out)[0]
                if isinstance(o, torch.Tensor)]
        if name in _COLLECTIVES:
            kind = _COLLECTIVES[name]
            n = _group_size(args, kwargs)
            size = sum(tensor_bytes(o) for o in outs) or \
                sum(tensor_bytes(a) for a in ins)
            frac = (n - 1) / n if n > 1 else 0.0
            moved = {"all-gather": size * frac,
                     "all-reduce": 2.0 * size * frac,
                     "reduce-scatter": size if n > 1 else 0.0,
                     "all-to-all": size * frac}.get(kind, size)
            moved *= k
            st.collective_bytes += moved
            st.collective_by_kind[kind] = \
                st.collective_by_kind.get(kind, 0.0) + moved
            st.collective_calls[kind] = st.collective_calls.get(kind, 0) + 1
            st.collective_ops += 1
            return
        from torch.utils.flop_counter import flop_registry
        packet = func._overloadpacket
        if packet in flop_registry:
            st.flops += k * flop_registry[packet](*args, **kwargs,
                                                  out_val=out)
        elif name.rstrip("_") in _ELEMENTWISE:
            st.flops += k * sum(o.numel() for o in outs)
        if func.is_view or name in _FREE:
            return
        seen: set = set()
        for t in ins + outs:
            if id(t) in seen:
                continue
            seen.add(id(t))
            b = k * tensor_bytes(t)
            st.hbm_bytes += b
            if not _is_resident(t):
                st.hbm_bytes_resident += b


def count_ops(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), OpStats)`` of one call on this rank."""
    counter = OpCounter()
    with counter:
        out = fn(*args, **kwargs)
    return out, counter.stats
