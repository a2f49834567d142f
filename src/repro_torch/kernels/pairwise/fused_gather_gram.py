"""Fused gather+Gram: the shuffle streams straight into each reducer's block.

Port of ``repro.kernels.pairwise.fused_gather_gram``: the Pallas TPU kernels
``fused_gather_gram`` / ``_fused_kernel`` (square) and
``fused_gather_gram_rect`` / ``_fused_rect_kernel`` (rectangular, X2Y).
For every reducer ``r`` of a capacity bucket they compute, in fp32,

* square: ``out[r] = X[idx_r] · X[idx_r]ᵀ`` of shape ``(L, L)``;
* rect:   ``out[r] = X[xidx_r] · Y[yidx_r]ᵀ`` of shape ``(Lx, Ly)``, over
  two tables with independent gather maps and widths,

zeroing masked slots at gather time; the gathered blocks are never written
out.  With a ``metric`` both wrappers return the blocks finished into
similarities instead (what the reference's fused executor computes after
its kernel): in the kernel's epilogue where a bucket is one tile a side
(``L <= 32``; rect ``Lx, Ly <= 32``), else in torch
(:func:`finish_fused_blocks`, :func:`finish_rect_blocks`), and they can
write them into a slice of a larger buffer (``out``).

``fused_gather_gram`` and ``fused_gather_gram_rect`` are the wrappers: on
CUDA tensors they launch the hand-written kernels in
``csrc/fused_gather_gram.cu`` and ``csrc/fused_gather_gram_rect.cu`` (built
for ``sm_90a`` at first use, see those files for their bounds and designs)
or raise; on CPU tensors they run ``fused_gather_gram_ref`` /
``fused_gather_gram_rect_ref``, the plain PyTorch versions.  There is no
fallback from the card to the plain versions.  A masked slot's index is
never read by either, so a plan may leave anything there.

Precision: the reference multiplies fp32 with fp32 accumulation and is held
at 1e-5.  The kernels use plain fp32 FMA, never TF32, and the plain versions
run ``torch.bmm`` with ``torch.backends.cuda.matmul.allow_tf32 = False``
so that both stay within that bound on the card.

Each square launch (or plain call on the CPU) runs inside an obs ``gram``
span with its ``width`` and ``R``, device-timed on the card
(``repro_torch.obs.trace``); a finish in torch runs inside a ``finish``
span.  Every square call with a metric counts one bucket in the obs counter
``fused.finish{where=kernel|torch}``, by where its finish ran.  Each rect
launch (or plain call) runs inside a ``gram`` span too, with its ``width``,
``ywidth`` and ``R``, and every rect call with a metric counts one bucket
in ``fused.finish{where=kernel|torch, shape=rect}``.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from repro_torch.obs import REGISTRY as _REGISTRY
from repro_torch.obs import span as _obs_span

from .. import _build

__all__ = ["FINISH_MAX_WIDTH", "METRICS", "finish_fused_blocks",
           "fused_gather_gram", "fused_gather_gram_ref",
           "finish_rect_blocks",
           "fused_gather_gram_rect", "fused_gather_gram_rect_ref",
           "fused_traffic_model", "gather_bytes", "gather_rows",
           "ieee_fp32", "launch_count",
           "rect_gather_bytes", "rect_table_norms", "rect_tile_widths",
           "reset_launch_count", "tile_width"]

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SQUARE_ARGS = [_P, _I, _P, _P, _P, _LL, _I, _I, _I, _I, _P]
# the square kernel's `metric` codes (Metric in csrc/fused_gather_gram.cu)
METRICS = {None: 0, "dot": 1, "cosine": 2, "l2": 3}
# the widest bucket (rect: on either side) whose block is one tile a side,
# so that the kernel's epilogue holds all of it (FINISH_MAX_L in
# csrc/fused_gather_gram.cu and csrc/fused_gather_gram_rect.cu)
FINISH_MAX_WIDTH = 32
_RECT_ARGS = [_P, _P, _I, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _I,
              _P, _P, _P]
# the rect kernel's tile widths per side (TMIN / TMAX in
# csrc/fused_gather_gram_rect.cu)
RECT_TMIN, RECT_TMAX = 1, 32
_TABLE_DTYPES = (torch.float32, torch.bfloat16)
_INT32_MAX = torch.iinfo(torch.int32).max


def tile_width(L: int) -> int:
    """The square kernel's tile width T for a bucket of width ``L``: the
    smallest power of two >= L, capped at 32 (wider buckets take
    ``ceil(L / T)`` tiles per side)."""
    if L < 1:
        raise ValueError(f"bucket width {L}: want >= 1")
    return min(32, 1 << (L - 1).bit_length())


def gather_bytes(mask, d: int, itemsize: int) -> int:
    """Table bytes the square kernel's gather streams for one bucket with
    ``(R, L)`` mask ``mask``: every valid slot's row of ``d`` elements is
    staged once per tile pair it enters (``it <= jt``), which is
    ``ceil(L / T)`` times; masked slots are zero-filled and read nothing.
    With the table in L2 this is the kernel's L2 read stream."""
    L = mask.shape[1]
    n_t = -(-L // tile_width(L))
    return int(mask.sum()) * n_t * d * itemsize


def rect_tile_widths(Lx: int, Ly: int) -> tuple:
    """The rect kernel's tile widths ``(TM, TN)`` for a bucket of widths
    ``(Lx, Ly)``: per side the smallest power of two >= the width, within
    ``[RECT_TMIN, RECT_TMAX]`` (wider sides take ``ceil(L / T)`` tiles)."""
    if Lx < 1 or Ly < 1:
        raise ValueError(f"bucket widths {Lx} x {Ly}: want >= 1")
    return tuple(min(RECT_TMAX, max(RECT_TMIN, 1 << (L - 1).bit_length()))
                 for L in (Lx, Ly))


def rect_gather_bytes(xmask, ymask, d: int, itemsize: int) -> int:
    """Table bytes the rect kernel's gather streams for one bucket with
    ``(R, Lx)`` / ``(R, Ly)`` masks: a tile pair stages the valid slots of
    its X tile and its Y tile, so every valid X slot's row of ``d``
    elements is read ``ceil(Ly / TN)`` times and every valid Y slot's
    ``ceil(Lx / TM)`` times; masked slots are zero-filled and read
    nothing.  With the tables in L2 this is the kernel's L2 read stream."""
    Lx, Ly = xmask.shape[1], ymask.shape[1]
    TM, TN = rect_tile_widths(Lx, Ly)
    rows = int(xmask.sum()) * -(-Ly // TN) + int(ymask.sum()) * -(-Lx // TM)
    return rows * d * itemsize


def fused_traffic_model(buckets, d: int, itemsize: int,
                        bl: int = 128) -> dict:
    """The reference's analytic HBM bytes of its TPU kernel's dataflow vs
    the unfused pipeline, copied unchanged (its ``bl=128`` row tiles), so
    the dry run reports the same model beside :func:`gather_bytes`, which
    models this port's kernel.

    Per reducer of bucket width Lb with n = ceil(Lb/bl) row tiles:

      fused    — xi gathered once per tile row (Lb rows), xj re-gathered per
                 (i, j) tile (n·Lb rows), plus the (Lb, Lb) fp32 block write.
      unfused  — the gather writes (Lb, d) then the Gram kernel reads it as
                 both operands (3·Lb·d round trip counted once each way ->
                 4·Lb·d with the gather's own table read), plus the block.

    Returns totals plus ``saved_bytes`` (the materialized-gather round trip
    the fused kernel removes, net of its tile re-reads).
    """
    fused = unfused = blocks = 0
    for b in buckets:
        Rb, Lb = int(b.idx.shape[0]), int(b.idx.shape[1])
        n = -(-Lb // bl)
        fused += Rb * (1 + n) * Lb * d * itemsize
        unfused += Rb * 4 * Lb * d * itemsize
        blocks += Rb * Lb * Lb * 4
    return {
        "fused_bytes": fused + blocks,
        "unfused_bytes": unfused + blocks,
        "saved_bytes": unfused - fused,
        "block_bytes": blocks,
    }


def launch_count() -> int:
    """Launches of the square kernel made by :func:`fused_gather_gram` in
    this process (``_build.launch_counts()`` has every kernel's)."""
    return _build.launch_counts().get("fused_gather_gram", 0)


def reset_launch_count() -> None:
    """Zero every kernel's launch count."""
    _build.reset_launch_counts()


@contextlib.contextmanager
def ieee_fp32():
    """fp32 matrix products and convolutions in full fp32 (TF32 off in
    cuBLAS and cuDNN) inside the block: the fp32 contracts the plain
    versions are held to on the card."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def gather_rows(x: torch.Tensor, idx: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` with masked slots zeroed: ``(m, d)``, ``(R, L)`` ->
    ``(R, L, d)``.  A masked slot's index is never read (it gathers row 0
    instead), so a plan may leave anything there."""
    mask = mask.bool()
    safe = torch.where(mask, idx, 0).reshape(-1).long()
    g = x.index_select(0, safe).reshape(*idx.shape, x.shape[1])
    return torch.where(mask[..., None], g, 0.0)


def fused_gather_gram_ref(x: torch.Tensor, idx: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """Plain version: gather -> mask -> batched Gram in fp32."""
    g = gather_rows(x, idx, mask).float()
    with ieee_fp32():
        return torch.bmm(g, g.transpose(1, 2))


def finish_fused_blocks(g: torch.Tensor, mask: torch.Tensor,
                        metric: str) -> torch.Tensor:
    """Metric post-processing of a masked per-reducer Gram stack, in torch.

    Mirrors ``allpairs.block_similarity`` exactly: norms are the Gram
    diagonal (masked rows were zeroed at gather time, so their norms are 0),
    invalid pairs -> 0.  The square kernel's epilogue computes the same
    values bit for bit.  Runs inside an obs ``finish`` span with the
    blocks' ``width``, device-timed on the card.
    """
    with _obs_span("finish", device=g.device, width=g.shape[1]):
        if metric != "dot":
            n2 = torch.diagonal(g, dim1=1, dim2=2)            # (Rb, Lb)
            if metric == "l2":
                g = n2[:, :, None] + n2[:, None, :] - 2.0 * g
            elif metric == "cosine":
                nrm = torch.sqrt(n2 + 1e-9)
                g = g / (nrm[:, :, None] * nrm[:, None, :])
            else:
                raise ValueError(metric)
        valid = mask[:, :, None] & mask[:, None, :]
        return torch.where(valid, g, 0.0)


def fused_gather_gram_rect_ref(x: torch.Tensor, y: torch.Tensor,
                               xidx: torch.Tensor, xmask: torch.Tensor,
                               yidx: torch.Tensor,
                               ymask: torch.Tensor) -> torch.Tensor:
    """Plain version of the rectangular kernel: gather both sides -> mask
    -> batched cross Gram in fp32."""
    gx = gather_rows(x, xidx, xmask).float()
    gy = gather_rows(y, yidx, ymask).float()
    with ieee_fp32():
        return torch.bmm(gx, gy.transpose(1, 2))


def rect_table_norms(x: torch.Tensor, y: torch.Tensor, metric: str):
    """Per-row fp32 squared norms of both tables, ``(n2x, n2y)``
    (``(None, None)`` for ``dot``, which needs none): what the rect finish
    reads for each slot, in torch or in the kernel's epilogue."""
    if metric == "dot":
        return None, None
    return x.float().square().sum(-1), y.float().square().sum(-1)


def _take_masked(v, idx, mask):
    """``v[idx]`` with masked slots 0; a masked slot's index is not read."""
    return torch.where(mask, v[torch.where(mask, idx, 0).long()], 0.0)


def finish_rect_blocks(g, xidx, xmask, yidx, ymask, n2x, n2y,
                       metric: str) -> torch.Tensor:
    """Metric post-processing of a masked rectangular cross-Gram stack, in
    torch.

    Mirrors ``allpairs.block_similarity_x2y``.  Cross blocks carry no Gram
    diagonal, so per-slot squared norms are gathered from the table-level
    fp32 vectors ``n2x``/``n2y`` (:func:`rect_table_norms`; ``None`` for
    ``dot``; masked slots -> 0, matching the zero-masked gathers of the
    reference path); invalid pairs -> 0.  The rect kernel's epilogue
    computes the same values bit for bit.  Masks are bool.  Runs in an obs
    ``finish`` span with the blocks' ``width`` and ``ywidth``, device-timed
    on the card."""
    with _obs_span("finish", device=g.device, width=g.shape[1],
                   ywidth=g.shape[2]):
        if metric != "dot":
            gx = _take_masked(n2x, xidx, xmask)               # (Rb, Lx)
            gy = _take_masked(n2y, yidx, ymask)               # (Rb, Ly)
            if metric == "l2":
                g = gx[:, :, None] + gy[:, None, :] - 2.0 * g
            elif metric == "cosine":
                g = g / (torch.sqrt(gx + 1e-9)[:, :, None]
                         * torch.sqrt(gy + 1e-9)[:, None, :])
            else:
                raise ValueError(metric)
        valid = xmask[:, :, None] & ymask[:, None, :]
        return torch.where(valid, g, 0.0)


def _check_out(out, shape, x):
    """Raise unless ``out`` (when given) is an fp32 contiguous tensor of
    ``shape`` on ``x``'s device."""
    if out is not None and (out.shape != shape or out.dtype != torch.float32
                            or out.device != x.device
                            or not out.is_contiguous()):
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} on "
                         f"{out.device}: want {shape} float32, "
                         f"contiguous, on {x.device}")


def _cuda_operands(tables, index_pairs):
    """Check what the kernels take — one CUDA device, fp32 or bf16 tables
    of one dtype, int32 indices, bool/uint8 masks, all contiguous — and
    return the masks as uint8 views."""
    dev, dtype = tables[0].device, tables[0].dtype
    arrays = (*tables, *(a for pair in index_pairs for a in pair))
    if any(a.device != dev for a in arrays):
        raise ValueError("tables, indices and masks must lie on one device")
    if dtype not in _TABLE_DTYPES or any(t.dtype != dtype for t in tables):
        raise TypeError(f"table dtypes {[t.dtype for t in tables]}: want "
                        "float32 or bfloat16, one dtype for all")
    masks = []
    for idx, mask in index_pairs:
        if idx.dtype != torch.int32:
            raise TypeError(f"idx dtype {idx.dtype}: want int32")
        if mask.dtype == torch.bool:
            mask = mask.view(torch.uint8)
        elif mask.dtype != torch.uint8:
            raise TypeError(f"mask dtype {mask.dtype}: want bool or uint8")
        masks.append(mask)
    if not all(a.is_contiguous() for a in arrays):
        raise ValueError("tables, indices and masks must be contiguous")
    if any(t.shape[0] > _INT32_MAX for t in tables):
        raise ValueError("table rows overflow int32 indices")
    return masks


def _device_of(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


def refuse_autograd(name: str, *tensors: torch.Tensor) -> None:
    """Raise when autograd would have to differentiate through kernel
    ``name``.  No hand-written kernel has a backward (nor has the
    reference's Pallas kernel), and a launch through ctypes would cut the
    gradient without a word; the plain version on CPU tensors refuses too,
    so both devices behave alike."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward (nor has the reference's kernel): "
            "train through the non-kernel route, "
            "RuntimeFlags(use_pallas=False); see ROADMAP.md")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def fused_gather_gram(x: torch.Tensor, idx: torch.Tensor,
                      mask: torch.Tensor, metric=None,
                      out=None) -> torch.Tensor:
    """``(m, d)`` table, ``(R, L)`` int32 idx, ``(R, L)`` bool mask ->
    ``(R, L, L)`` fp32 masked per-reducer Gram blocks, or with ``metric``
    (``"dot"``, ``"cosine"``, ``"l2"``) those blocks finished into
    similarities, bit for bit what :func:`finish_fused_blocks` gives on the
    raw blocks.  ``out``, an ``(R, L, L)`` fp32 contiguous tensor on
    ``x``'s device (a view into a larger buffer will do), receives the
    result and is returned.

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (fp32 or bf16 table, contiguous, all on one device) or raise.  A metric
    is finished in the kernel's epilogue up to width ``FINISH_MAX_WIDTH``
    and in torch (:func:`finish_fused_blocks`) beyond it and on the CPU.
    Valid slots must index rows of ``x``: the plain version raises
    otherwise, and the kernel, which cannot raise without a sync, gives NaN
    for every entry such a slot touches (it never reads outside the
    table)."""
    if idx.dim() != 2 or mask.shape != idx.shape or x.dim() != 2:
        raise ValueError(f"want x (m, d), idx/mask (R, L); got "
                         f"{tuple(x.shape)}, {tuple(idx.shape)}, "
                         f"{tuple(mask.shape)}")
    if metric not in METRICS:
        raise ValueError(f"metric {metric!r}: want one of {list(METRICS)}")
    R, L = idx.shape
    _check_out(out, (R, L, L), x)
    in_kernel = (metric is not None and x.is_cuda
                 and L <= FINISH_MAX_WIDTH)
    if metric is not None:
        _REGISTRY.counter("fused.finish",
                          where="kernel" if in_kernel else "torch").inc()
    if _device_of(x) == "cpu":
        with _obs_span("gram", width=L, R=R):
            g = fused_gather_gram_ref(x, idx, mask)
    else:
        (mask8,) = _cuda_operands([x], [(idx, mask)])
        g = out if out is not None and (metric is None or in_kernel) else \
            torch.empty((R, L, L), dtype=torch.float32, device=x.device)
        if R == 0:
            return g if out is None else out
        # the span holds the launch alone, so that its device interval is
        # the kernel's and the host's checks before it count as the caller's
        with _obs_span("gram", device=x.device, width=L, R=R), \
                torch.cuda.device(x.device):
            _build.launch(
                "fused_gather_gram", _SQUARE_ARGS,
                (x.data_ptr(), int(x.dtype == torch.bfloat16),
                 idx.data_ptr(), mask8.data_ptr(), g.data_ptr(), R, L,
                 x.shape[1], x.shape[0], METRICS[metric if in_kernel
                                                 else None], _stream(x)),
                what=f"R={R}, L={L}, d={x.shape[1]}, metric={metric}")
    if metric is not None and not in_kernel:
        g = finish_fused_blocks(g, mask.bool(), metric)
    if out is None or g is out:
        return g
    return out.copy_(g)


def fused_gather_gram_rect(x: torch.Tensor, y: torch.Tensor,
                           xidx: torch.Tensor, xmask: torch.Tensor,
                           yidx: torch.Tensor, ymask: torch.Tensor,
                           metric=None, out=None,
                           norms=None) -> torch.Tensor:
    """``(mx, d)`` X table, ``(my, d)`` Y table, ``(R, Lx)`` X-side and
    ``(R, Ly)`` Y-side int32 idx / bool mask -> ``(R, Lx, Ly)`` fp32 masked
    per-reducer cross-Gram blocks, or with ``metric`` (``"dot"``,
    ``"cosine"``, ``"l2"``) those blocks finished into similarities, bit
    for bit what :func:`finish_rect_blocks` gives on the raw blocks.
    ``norms``, the tables' ``(n2x, n2y)`` of :func:`rect_table_norms`, is
    computed here when not given.  ``out``, an ``(R, Lx, Ly)`` fp32
    contiguous tensor on ``x``'s device (a view into a larger buffer will
    do), receives the result and is returned.

    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise.  A metric is finished in the kernel's epilogue when both widths
    are at most ``FINISH_MAX_WIDTH`` and in torch beyond them and on the
    CPU.  ``x`` and ``y`` may be row slices of one table, even
    overlapping ones (block serving passes ``x[i0:i1]`` and ``x[j0:j1]``):
    the kernel only reads them.  Entry ``(i, j)`` is the product of X slot
    ``i``'s row and Y slot ``j``'s row, a masked slot standing for a zero
    row: zero beside a finite row, NaN beside an Inf or NaN one, in the
    kernel as in the plain version.  Valid slots must index rows of their
    tables: the plain version raises otherwise, and the kernel gives NaN
    for every entry of that slot's row (X) or column (Y) (it never reads
    outside a table), finished or not.  The kernel reads only valid slots'
    rows."""
    if (xidx.dim() != 2 or xmask.shape != xidx.shape or yidx.dim() != 2
            or ymask.shape != yidx.shape or yidx.shape[0] != xidx.shape[0]
            or x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]):
        raise ValueError(f"want x (mx, d), y (my, d), xidx/xmask (R, Lx), "
                         f"yidx/ymask (R, Ly); got {tuple(x.shape)}, "
                         f"{tuple(y.shape)}, {tuple(xidx.shape)}, "
                         f"{tuple(xmask.shape)}, {tuple(yidx.shape)}, "
                         f"{tuple(ymask.shape)}")
    if metric not in METRICS:
        raise ValueError(f"metric {metric!r}: want one of {list(METRICS)}")
    (R, Lx), Ly = xidx.shape, yidx.shape[1]
    _check_out(out, (R, Lx, Ly), x)
    in_kernel = (metric is not None and x.is_cuda
                 and max(Lx, Ly) <= FINISH_MAX_WIDTH)
    if metric is not None:
        _REGISTRY.counter("fused.finish", where="kernel" if in_kernel
                          else "torch", shape="rect").inc()
        if norms is None:
            norms = rect_table_norms(x, y, metric)
    if _device_of(x) == "cpu":
        with _obs_span("gram", width=Lx, ywidth=Ly, R=R):
            g = fused_gather_gram_rect_ref(x, y, xidx, xmask, yidx, ymask)
    else:
        xm8, ym8 = _cuda_operands([x, y], [(xidx, xmask), (yidx, ymask)])
        g = out if out is not None and (metric is None or in_kernel) else \
            torch.empty((R, Lx, Ly), dtype=torch.float32, device=x.device)
        if g.numel() == 0:
            return g if out is None else out
        n2 = (None, None)
        if in_kernel and metric != "dot":
            n2 = tuple(_norm_operand(n, t, side)
                       for n, t, side in zip(norms, (x, y), "xy"))
        # the span holds the launch alone, so that its device interval is
        # the kernel's (as in the square wrapper)
        with _obs_span("gram", device=x.device, width=Lx, ywidth=Ly, R=R), \
                torch.cuda.device(x.device):
            _build.launch(
                "fused_gather_gram_rect", _RECT_ARGS,
                (x.data_ptr(), y.data_ptr(), int(x.dtype == torch.bfloat16),
                 xidx.data_ptr(), xm8.data_ptr(), yidx.data_ptr(),
                 ym8.data_ptr(), g.data_ptr(), R, Lx, Ly, x.shape[1],
                 x.shape[0], y.shape[0],
                 METRICS[metric if in_kernel else None],
                 *(n.data_ptr() if n is not None else None for n in n2),
                 _stream(x)),
                what=f"R={R}, Lx={Lx}, Ly={Ly}, d={x.shape[1]}, "
                     f"metric={metric}")
    if metric is not None and not in_kernel:
        g = finish_rect_blocks(g, xidx, xmask.bool(), yidx, ymask.bool(),
                               *norms, metric)
    if out is None or g is out:
        return g
    return out.copy_(g)


def _norm_operand(n2, table, side: str) -> torch.Tensor:
    """Check a table's squared norms for the rect epilogue, which reads
    them by row: an fp32 contiguous vector of one entry a row, on the
    table's device."""
    if (n2 is None or n2.shape != (table.shape[0],)
            or n2.dtype != torch.float32 or n2.device != table.device
            or not n2.is_contiguous()):
        got = None if n2 is None else (tuple(n2.shape), n2.dtype, n2.device)
        raise ValueError(f"norms of {side}: got {got}, want "
                         f"({table.shape[0]},) float32, contiguous, on "
                         f"{table.device}")
    return n2
