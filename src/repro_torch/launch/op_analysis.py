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

  * **Memory** — the bytes of the storages the step allocates on the
    counter's device (``"meta"`` in the dry run, ``"cuda"`` on the card),
    each rounded up as the CUDA caching allocator rounds a block (a
    multiple of 512 B, at least 512 B): a storage counts from the op that
    first returns it (a view or an in-place result shares an input's
    storage and adds nothing; ``empty`` and the other allocating factories
    count, ``resize_`` moves its storage's size) until it is freed (a
    ``weakref.finalize`` on the storage; a later storage at the same
    address is a new one).  ``OpStats.live_peak`` is the largest sum of
    those live bytes during the step (with the scratch some CUDA kernels
    take inside themselves while they run, ``_SCRATCH``), ``live_end``
    the sum at its end.
    Eager PyTorch has no buffer assignment like XLA's, so the dry run's
    fields are the port's own: ``peak_bytes`` = the arguments' bytes +
    ``live_peak``; ``temp_bytes`` = ``live_peak - live_end``, what the step
    needed above its arguments and what it returns or keeps (never below
    0).  Held on the card against ``torch.cuda.max_memory_allocated`` above
    the arguments (``chip_smoke.py``, phase 24 (f)).

The shape inference DTensor runs on fake tensors is not counted, nor is
anything a fake mode runs.  Layers are not scanned here; the one loop a
step runs many times over the same shapes, the plain SSD scans' loop over
positions or chunks, runs ONE iteration on meta tensors under
:func:`repeated` (forward and backward, :func:`meta_repeat`), which
multiplies what it counts by the trip count: the reference's while-loop
multiplier.  For memory the iteration's storages that are still live when
it ends (what autograd saves for the backward, the carried state it
keeps, the result the loop collects) count ``n`` times from then on, and
its transient peak above them once: the loop's peak is at its last
iteration, with ``n - 1`` iterations' storages kept.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_flatten

__all__ = ["OpStats", "OpCounter", "count_ops", "tensor_bytes", "repeated",
           "meta_repeat", "block_bytes"]

_SCALE = [1.0]
BLOCK = 512             # the CUDA caching allocator's rounding (kMinBlockSize)


def block_bytes(nbytes: int) -> int:
    """``nbytes`` as the CUDA caching allocator's block: 0 for nothing,
    else a multiple of 512 B, at least 512 B."""
    return -(-nbytes // BLOCK) * BLOCK


def _counters() -> list:
    return [m for m in _get_current_dispatch_mode_stack()
            if isinstance(m, OpCounter)]


@contextlib.contextmanager
def repeated(n: int, memory: bool = True):
    """Every op counted inside counts ``n`` times (nested: multiplied).
    With ``memory``, the storages allocated inside and still live at its
    end count ``n`` times from then on (one iteration of an ``n``-trip
    loop stands for all of them)."""
    _SCALE.append(_SCALE[-1] * n)
    frames = [(c, c._open()) for c in _counters()] if memory else []
    try:
        yield
    finally:
        _SCALE.pop()
        for c, frame in reversed(frames):
            c._close(frame, n)


def _uncount(t: torch.Tensor) -> None:
    """Count ``t``'s storage as freed from now on, though it stays alive
    (a loop's results, gone once stacked, whose autograd graph
    :func:`meta_repeat` keeps)."""
    for c in _counters():
        c._forget(t)


class _MetaRepeat(torch.autograd.Function):
    """``n`` iterations of ``step`` on meta tensors, run once and counted
    ``n`` times, backward included; the result is an empty meta tensor of
    the ``n`` stacked results' shape."""

    @staticmethod
    def forward(ctx, step, n, out_shape, dtype, sl, grad, *args):
        ctx.step, ctx.n, ctx.sl = step, n, sl
        ctx.save_for_backward(*args)
        with repeated(n), torch.set_grad_enabled(grad):
            # slices of the arguments themselves: the graph holds what the
            # loop's ops save, through the saved-tensor hooks, and no leaf
            state, y = step(*(a[s] for a, s in zip(args, sl)))
            # the next iteration saves the state for its backward
            kept = (_Saved.apply(state), y) if grad else y
            del state
        out = y.new_empty(out_shape).to(dtype)
        _uncount(y)                     # the results, stacked and cast
        ctx.kept = kept                 # what the loop saved, till backward
        return out

    @staticmethod
    def backward(ctx, gy):
        args = ctx.saved_tensors
        ctx.kept = None                 # recomputed below
        with repeated(ctx.n), torch.enable_grad():
            parts = [a[s].detach().requires_grad_(a.requires_grad)
                     for a, s in zip(args, ctx.sl)]
            state, y = ctx.step(*parts)
        _uncount(y)
        with repeated(ctx.n, memory=False):
            need = [p for p in parts if p.requires_grad]
            torch.autograd.grad(y, need, y.new_empty(y.shape),
                                allow_unused=True)
        return (None, None, None, None, None, None,
                *(torch.empty_like(a) if want else None
                  for a, want in zip(args, ctx.needs_input_grad[6:])))


class _Saved(torch.autograd.Function):
    """Saves ``t`` as an op saves an operand for its backward, through the
    saved-tensor hooks (a checkpoint drops it until it recomputes the
    forward); the empty result holds it."""

    @staticmethod
    def forward(ctx, t):
        ctx.save_for_backward(t)
        return t.new_empty(0)

    @staticmethod
    def backward(ctx, g):
        return None


def meta_repeat(step, n: int, out_shape, dtype, slices, *args):
    """``n`` iterations of ``state, y = step(*(a[s] ...))``, the loop body
    on the first iteration's slices, counted ``n`` times; meta tensors
    only (the dry run).  Returns an empty tensor of ``out_shape`` in
    ``dtype``: the ``n`` results stacked and cast."""
    grad = torch.is_grad_enabled() and any(a.requires_grad for a in args)
    return _MetaRepeat.apply(step, n, tuple(out_shape), dtype, tuple(slices),
                             grad, *args)

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
    live_peak: int = 0
    live_end: int = 0


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


def _dense(t) -> int:
    return block_bytes(t.numel() * t.element_size())


def _copy(t) -> int:
    """What a kernel's own ``.contiguous()`` of ``t`` allocates."""
    return 0 if t.is_contiguous() else _dense(t)


# Scratch that CUDA kernels allocate inside themselves, beside their
# outputs and freed before they return, by op and positional arguments:
# the softmax family copies a non-contiguous operand, the softmax
# backward also takes a temporary of its gradient's size, logsumexp one
# of its input's, cuDNN's convolutions contiguous copies.  Each read on an
# H100 (torch 2.11) from the caching allocator's high-water during the op
# (``tests/test_torch_cuda.py::test_kernel_scratch_matches_the_allocator``).
# Smaller scratch (reductions' staging buffers, sorts) is not modelled.
_SCRATCH = {
    "_softmax": lambda a: _copy(a[0]),
    "_log_softmax": lambda a: _copy(a[0]),
    "_log_softmax_backward_data": lambda a: _copy(a[0]),
    "_softmax_backward_data": lambda a: _dense(a[0]) + _copy(a[0]),
    "logsumexp": lambda a: _dense(a[0]),
    "convolution": lambda a: _copy(a[0]),
    "convolution_backward": lambda a: _copy(a[0]) + _copy(a[1]),
}


def _address(st) -> int:
    """What the counter knows a live storage by: the address of its
    ``StorageImpl``, which a later storage may take once it is freed."""
    return st._cdata


class _Block:
    """One counted storage: its bytes (times the trips of the loops that
    kept it) while ``live``."""

    __slots__ = ("nbytes", "live")

    def __init__(self, nbytes: int):
        self.nbytes, self.live = nbytes, True


class OpCounter(TorchDispatchMode):
    """Counts every local op run while it is active into ``stats``, and
    the storages they allocate on ``device`` (a device type)."""

    def __init__(self, device: str = "meta"):
        super().__init__()
        self.stats = OpStats()
        self.device = device
        self.live = self.peak = 0
        self._blocks: dict = {}         # storage address -> _Block
        self._frames: list = []         # open repeated() regions

    def __exit__(self, *exc):
        self.stats.live_peak, self.stats.live_end = self.peak, self.live
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # let DTensor issue its local ops
        name = func._overloadpacket.__name__
        resized = name in ("resize_", "resize_as_")
        before = self._size(args[0]) if resized else 0
        out = func(*args, **kwargs)
        if not self._counts(args, kwargs):
            return out
        self._count(func, args, kwargs, out)
        if resized:
            self._resize(args[0], before)
        else:
            self._allocated(args, kwargs, out)
        if name in _SCRATCH and self._mine(args[0]):
            self.peak = max(self.peak, self.live + _SCRATCH[name](args))
        return out

    # ---------------------------------------------------------- memory
    def _mine(self, t) -> bool:
        return type(t) in (torch.Tensor, torch.nn.Parameter) \
            and t.device.type == self.device

    def _size(self, t) -> int:
        return block_bytes(t.untyped_storage().nbytes()) \
            if self._mine(t) else 0

    def _allocated(self, args, kwargs, out) -> None:
        """Counts each storage ``out`` holds that no input holds and that
        is not counted already: the op allocated it."""
        inputs = None
        for o in tree_flatten(out)[0]:
            if not self._mine(o):
                continue
            st = o.untyped_storage()
            key = _address(st)
            if key in self._blocks:
                continue
            if inputs is None:
                inputs = {_address(a if isinstance(a, torch.UntypedStorage)
                                   else a.untyped_storage())
                          for a in tree_flatten((args, kwargs))[0]
                          if isinstance(a, torch.UntypedStorage)
                          or self._mine(a)}
            if key in inputs:
                continue
            self._add(st, block_bytes(st.nbytes()))

    def _add(self, st, nbytes: int) -> None:
        block = _Block(nbytes)
        self._blocks[_address(st)] = block
        weakref.finalize(st, self._free, _address(st), block)
        for frame in self._frames:
            frame[0].append(block)
        self.live += nbytes
        self.peak = max(self.peak, self.live)

    def _free(self, key: int, block: _Block) -> None:
        if self._blocks.get(key) is block:
            del self._blocks[key]
        if block.live:
            block.live = False
            self.live -= block.nbytes

    def _forget(self, t) -> None:
        if not self._mine(t):
            return
        block = self._blocks.get(_address(t.untyped_storage()))
        if block is not None and block.live:
            block.live = False          # stays in _blocks: not new again
            self.live -= block.nbytes

    def _resize(self, t, before: int) -> None:
        """``resize_`` grew or shrank ``t``'s storage in place."""
        after = self._size(t)
        if after == before:
            return
        st = t.untyped_storage()
        block = self._blocks.get(_address(st))
        if block is None:               # an argument's storage grew
            if after > before:
                self._add(st, after - before)
            return
        block.nbytes += after - before
        if block.live:
            self.live += after - before
            self.peak = max(self.peak, self.live)

    def _open(self):
        frame = ([], self.peak)
        self._frames.append(frame)
        self.peak = self.live           # the region's own high-water
        return frame

    def _close(self, frame, n: int) -> None:
        """One iteration stands for ``n``: what it left live counts ``n``
        times, and the loop's peak is this iteration's with the ``n - 1``
        others' kept storages under it."""
        self._frames.remove(frame)
        blocks, outer_peak = frame
        kept = [b for b in blocks if b.live]
        extra = (n - 1) * sum(b.nbytes for b in kept)
        for b in kept:
            b.nbytes *= n
        self.live += extra
        self.peak = max(outer_peak, self.peak + extra)

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


def count_ops(fn, *args, device: str = "meta", **kwargs):
    """``(fn(*args, **kwargs), OpStats)`` of one call on this rank; memory
    is counted on ``device`` (a device type)."""
    counter = OpCounter(device)
    with counter:
        out = fn(*args, **kwargs)
    return out, counter.stats
