"""
The neighbor gathers of the MD step as hand-written kernels
(``csrc/gather.cu``), each beside its plain torch version:

- ``gather_rows(table, idx)``: ``out[..., c] = table[idx[...], c]``, the
  neighbor row gather (positions out to the (N, K) rows);
- ``gather_lanes(t, li)``: ``out[a, b] = t[a, li[a, b]]``, the gather
  within each row;
- ``rev_gather(part, idx, rev)``: ``out[..., c] = part[idx[...],
  rev[...], c]``, the reverse-slot gather of the packed slot partials
  (the gather inside ``trio.assemble_forces``).

They are the port of the TPU probes' Pallas gathers (``benchmarks/``:
``step_anatomy.py``, ``probe_dynamic_gather.py``, ``probe_dg2.py``,
``probe_dg3.py``, ``probe_gather2.py``, ``probe_wg.py``,
``proto_dyngather.py``, ``proto_pallas_gather.py``, ``probe_mosaic.py``;
``csrc/gather.cu`` names each), and are measured by
``uf3_tpu_torch.benchmarks.probe_gather`` and ``step_anatomy``.  No MD,
calculator or fit path calls them.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the
plain version, which computes the flat offsets the kernel computes
(``row_offsets``, ``lane_offsets``, ``rev_offsets``) and copies through
them.  Float32 and float64, int32 and int64 indices;
the results are equal bit for bit.  Indices must lie in range: the
kernels do not check them (that would cost a host sync).  Each
wrapper's ``launches`` counts its kernel launches.

``gather_plan`` is the choice of instance that the wrappers make, as a
plain function of the shapes, element sizes and alignment; the C entries
only dispatch on it.  The row gather goes by the row's width in 32-bit
words (an instance for 1, 2, 3, 4, 6, 8 and 16 words, ``rows_any`` for
the others below 32, ``rows_wide`` from 32 on), and so does the
reverse-slot gather, which is the row gather of ``part`` viewed as the
(R Kp, W) table at rows ``idx Kp + rev`` (``rev_w<words>``, ``rev_any``,
``rev_wide``: the same kernels reading both indices); the lane gather
goes by the table's width (the warp-shuffle instance of T rounded up to
a power of two, up to 32 lanes); 64-bit offsets only where an operand
passes 2^31 words.  ``gather_occupancy`` gives the registers and warps
per SM of a plan's instance.
"""

import ctypes
import functools
from typing import NamedTuple

import torch

from uf3_tpu_torch.ops import _build

# NVIDIA H100 SXM device memory rate (data sheet, at 700 W)
PEAK_BYTES = 3.35e12
# the granule in bytes in which the card reads device memory
SECTOR = 32
_FLOATS = (torch.float32, torch.float64)
_INDICES = (torch.int32, torch.int64)
# row widths in 32-bit words with a row-gather instance of their own
# (csrc/gather.cu's rows_of); narrower others take rows_any
ROW_WORDS = (1, 2, 3, 4, 6, 8, 16)
# rows of this many 32-bit words or more take rows_wide (a warp a row)
WIDE_WORDS = 32
# the widest table the lane gather's warp-shuffle instance takes
SHUFFLE_LANES = 32
# the largest offset, in 32-bit words, of the 32-bit instances
MAX_OFFSET = 2 ** 31 - 1


class GatherPlan(NamedTuple):
    """The instance a gather runs, and what its C entry is told:
    ``kernel`` "rows_w<words>", "rows_any", "rows_wide" (and "rev_..."
    for the reverse-slot gather, the same kernels reading idx and rev),
    "lanes_shuffle" or "lanes_direct"; ``code`` the row width in words
    (0: rows_any, ``WIDE_WORDS``: rows_wide) or log2 of the shuffle's lane
    group T' (T rounded up to a power of two; -1: one thread per
    output); ``wide`` 64-bit offsets; ``values_align`` the bytes that the
    table's rows start at multiples of (16, 8 or 4), which decide whether
    the row instances copy 16- or 8-byte chunks or words (the lane
    gather reads whole elements: their size)."""
    kernel: str
    code: int
    wide: bool
    values_align: int


def alignment(*byte_counts) -> int:
    """The largest of 16, 8 and 4 bytes that divides each of
    ``byte_counts`` (addresses, strides); 1 where 4 does not."""
    bits = 16
    for count in byte_counts:
        bits |= count
    return _low_align(bits)


def _low_align(bits: int) -> int:
    """``alignment`` of the byte counts OR-ed into ``bits`` with 16."""
    low = bits & -bits
    return low if low >= 4 else 1


def gather_plan(kind: str, values_shape, index_shape, elem_bytes: int,
                index_bytes: int, values_align: int = 16) -> GatherPlan:
    """The instance a gather of ``kind`` ("rows", "rev" or "lanes") runs
    for a contiguous table of ``values_shape`` ((R, W); for "rev" the
    partials (R, Kp, W) viewed as (R Kp, W); (A, T)) and indices of
    ``index_shape``, ``elem_bytes`` 4 or 8 and ``index_bytes`` 4 or 8,
    with the table's rows aligned to ``values_align`` bytes."""
    entries = 1
    for size in index_shape:
        entries *= size
    return _plan(kind, *values_shape, entries, elem_bytes, index_bytes,
                 values_align)


@functools.lru_cache(maxsize=1024)
def _plan(kind: str, rows: int, width: int, entries: int, elem_bytes: int,
          index_bytes: int, values_align: int) -> GatherPlan:
    """``gather_plan`` of an (R, W) or (A, T) table of ``rows`` x
    ``width`` and ``entries`` indices; cached on these integers, so that
    a wrapper's call pays a lookup.  "rev" offsets reach row R Kp - 1 of
    the (R Kp, W) view, as "rows" offsets reach row R - 1."""
    if elem_bytes not in (4, 8) or index_bytes not in (4, 8):
        raise ValueError(f"gather_plan: element and index sizes 4 or 8; "
                         f"got {elem_bytes}, {index_bytes}")
    per_word = elem_bytes // 4
    if kind in ("rows", "rev"):
        words = width * per_word
        wide = max(rows * words, entries * words, entries) > MAX_OFFSET
        if words in ROW_WORDS:
            return GatherPlan(f"{kind}_w{words}", words, wide, values_align)
        if words >= WIDE_WORDS:
            return GatherPlan(f"{kind}_wide", WIDE_WORDS, wide, values_align)
        return GatherPlan(f"{kind}_any", 0, wide, values_align)
    if kind == "lanes":
        wide = max(rows * width, entries) * per_word > MAX_OFFSET
        if width <= SHUFFLE_LANES and not wide:
            return GatherPlan("lanes_shuffle",
                              max(width - 1, 0).bit_length(), False,
                              values_align)
        return GatherPlan("lanes_direct", -1, wide, values_align)
    raise ValueError(f"gather_plan: no instances of kind {kind!r} (rows, "
                     "rev, lanes)")


# uf3_gather_occupancy's kind of a plan, by its kernel's first word
PLAN_KINDS = {"rows": 0, "lanes": 1, "rev": 2}


def gather_occupancy(plan: GatherPlan, elem_bytes: int,
                     index_bytes: int) -> dict:
    """The launch plan of ``plan``'s instance from the CUDA runtime,
    nothing launched: registers, local (spill) bytes a thread, static
    shared bytes and threads a block, resident blocks and warps an
    SM."""
    out = (ctypes.c_int * 6)()
    kind = PLAN_KINDS[plan.kernel.split("_")[0]]
    err = _build.library().uf3_gather_occupancy(
        kind, plan.code, int(plan.wide), elem_bytes, index_bytes, out)
    if err != 0:
        raise RuntimeError(f"uf3_gather_occupancy failed ({err})")
    return dict(kernel=plan.kernel, registers=out[0], local_bytes=out[1],
                shared_bytes=out[2], threads=out[3], blocks_per_sm=out[4],
                warps_per_sm=out[5])


def row_offsets(table, idx):
    """The flat offsets idx * W + c into the (R, W) ``table`` that
    ``gather_rows`` reads: (..., W)."""
    w = table.shape[1]
    cols = torch.arange(w, device=table.device)
    return idx.long()[..., None] * w + cols


def lane_offsets(t, li):
    """The flat offsets a * T + li into the (A, T) ``t`` that
    ``gather_lanes`` reads: (A, B)."""
    a, width = t.shape
    rows = torch.arange(a, device=t.device)[:, None] * width
    return rows + li.long()


def rev_offsets(part, idx, rev):
    """The flat offsets (idx * Kp + rev) * W + c into the (R, Kp, W)
    ``part`` that ``rev_gather`` reads: (..., W)."""
    _, kp, w = part.shape
    cols = torch.arange(w, device=part.device)
    flat = (idx.long() * kp + rev.long()) * w
    return flat[..., None] + cols


# the offsets each gather reads, by its kind
OFFSETS = {"rows": row_offsets, "lanes": lane_offsets, "rev": rev_offsets}


def gather_rows_torch(table, idx):
    """Plain version of ``gather_rows``: (..., W) rows of the (R, W)
    ``table`` at ``idx``, copied through ``row_offsets``."""
    return torch.take(table, row_offsets(table, idx))


def gather_lanes_torch(t, li):
    """Plain version of ``gather_lanes``: (A, B) entries of each row of
    the (A, T) ``t`` at the row's lanes ``li``, copied through
    ``lane_offsets``."""
    return torch.take(t, lane_offsets(t, li))


def rev_gather_torch(part, idx, rev):
    """Plain version of ``rev_gather``: (..., W) rows ``part[idx, rev]``
    of the (R, Kp, W) ``part``, copied through ``rev_offsets``."""
    return torch.take(part, rev_offsets(part, idx, rev))


def _check_operands(name: str, values, *indices):
    if values.dtype not in _FLOATS:
        raise TypeError(f"{name} takes float32 or float64 values; got "
                        f"{values.dtype}")
    for index in indices:
        if index.dtype not in _INDICES:
            raise TypeError(f"{name} takes int32 or int64 indices; got "
                            f"{index.dtype}")
        if index.device != values.device:
            raise ValueError(f"{name}: operands on different devices "
                             f"({values.device}, {index.device})")
    if values.device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {values.device}")


def _sizes(values, index):
    return values.element_size(), index.element_size()


def _launch(name: str, entry: str, device, *args):
    """Call C entry ``entry`` with ``args`` and the handle of ``device``'s
    current stream (a CUDA device; the capture stream inside a CUDA
    graph's capture), raising on failure; ``device`` is made the current
    device for the call only where it is not already.  The handle comes
    from ``torch._C._cuda_getCurrentRawStream``: a
    ``torch.cuda.current_stream()`` object inside a device context cost
    ``rev_gather``'s wrapper ~10 of its ~39 host us a call
    (``benchmarks/gather_host.py``; PERF.md section 6)."""
    fn = getattr(_build.library(), entry)
    index = device.index
    if index == torch.cuda.current_device():
        _build.launch(name, fn, *args,
                      torch._C._cuda_getCurrentRawStream(index))
        return
    with torch.cuda.device(device):
        _build.launch(name, fn, *args,
                      torch._C._cuda_getCurrentRawStream(index))


def rows_plan(table, idx) -> GatherPlan:
    """``gather_plan`` for ``gather_rows(table, idx)`` as the wrapper
    launches it: the alignment read off the table's pointer and row
    width in bytes (a table that is not contiguous is copied first, to a
    new allocation, which is aligned)."""
    elem = table.element_size()
    rows, width = table.shape
    start = table.data_ptr() if table.is_contiguous() else 0
    return _plan("rows", rows, width, idx.numel(), elem, idx.element_size(),
                 alignment(start, width * elem))


def rev_plan(part, idx) -> GatherPlan:
    """``gather_plan`` for ``rev_gather(part, idx, rev)`` on contiguous
    operands, as the wrapper launches them: ``part`` (R, Kp, W) as the
    (R Kp, W) table, its rows' alignment read off its pointer and row
    width in bytes (for partials that are not contiguous, plan the
    ``.contiguous()`` copy the wrapper makes)."""
    rows, kp, width = part.shape
    return _rev_plan(rows * kp, width, idx.numel(), *_sizes(part, idx),
                     part.data_ptr())


def _rev_plan(rows: int, width: int, entries: int, elem: int, index: int,
              start: int) -> GatherPlan:
    """``rev_plan`` from the numbers read off the operands (the (R Kp, W)
    table's rows and width, the entries, the element and index sizes and
    the table's address), which the wrapper reads once for the plan and
    the launch both."""
    return _plan("rev", rows, width, entries, elem, index,
                 _low_align(16 | start | width * elem))


def gather_rows(table, idx):
    """Rows of the (R, W) ``table`` at the indices ``idx`` (any shape):
    an (idx.shape + (W,)) tensor.  A CUDA tensor runs the kernel of
    ``csrc/gather.cu`` that ``rows_plan`` picks (a table that is not
    contiguous is copied first) or raises; a CPU tensor runs the plain
    version."""
    if table.dim() != 2:
        raise ValueError(f"gather_rows takes an (R, W) table; got shape "
                         f"{tuple(table.shape)}")
    if table.device.type == "cpu":
        return gather_rows_torch(table, idx)
    _check_operands("gather_rows", table, idx)
    table, idx = table.contiguous(), idx.contiguous()
    w = table.shape[1]
    out = torch.empty(tuple(idx.shape) + (w,), dtype=table.dtype,
                      device=table.device)
    if out.numel() == 0:
        return out
    plan = rows_plan(table, idx)
    _launch("gather_rows", "uf3_gather_rows", table.device,
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.numel(), w,
            *_sizes(table, idx), plan.code, int(plan.wide), plan.values_align)
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


def lanes_plan(t, li) -> GatherPlan:
    """``gather_plan`` for ``gather_lanes(t, li)`` on contiguous
    operands."""
    elem = t.element_size()
    rows, width = t.shape
    return _plan("lanes", rows, width, li.numel(), elem, li.element_size(),
                 elem)


def gather_lanes(t, li):
    """Entries of each row of the (A, T) ``t`` at that row's lanes ``li``
    (A, B): an (A, B) tensor.  A CUDA tensor runs the kernel of
    ``csrc/gather.cu`` that ``lanes_plan`` picks (the warp shuffle up to
    32 lanes) or raises; a CPU tensor runs the plain version."""
    if t.dim() != 2 or li.dim() != 2 or li.shape[0] != t.shape[0]:
        raise ValueError(f"gather_lanes takes (A, T) and (A, B); got "
                         f"{tuple(t.shape)} and {tuple(li.shape)}")
    if t.device.type == "cpu":
        return gather_lanes_torch(t, li)
    _check_operands("gather_lanes", t, li)
    t, li = t.contiguous(), li.contiguous()
    out = torch.empty(tuple(li.shape), dtype=t.dtype, device=t.device)
    if out.numel() == 0:
        return out
    plan = lanes_plan(t, li)
    _launch("gather_lanes", "uf3_gather_lanes", t.device, t.data_ptr(),
            li.data_ptr(), out.data_ptr(), li.shape[0], li.shape[1],
            t.shape[1], *_sizes(t, li), plan.code, int(plan.wide))
    gather_lanes.launches += 1
    return out


gather_lanes.launches = 0


def rev_gather(part, idx, rev):
    """Rows ``part[idx, rev]`` of the (R, Kp, W) partials ``part`` at the
    slot indices ``idx`` and reverse slots ``rev`` (one shape, one
    dtype): an (idx.shape + (W,)) tensor.  A CUDA tensor runs the kernel
    of ``csrc/gather.cu`` that ``rev_plan`` picks (partials that are not
    contiguous are copied first) or raises; a CPU tensor runs the plain
    version."""
    if part.dim() != 3 or idx.shape != rev.shape:
        raise ValueError(f"rev_gather takes (R, Kp, W) partials and "
                         f"indices of one shape; got {tuple(part.shape)}, "
                         f"{tuple(idx.shape)} and {tuple(rev.shape)}")
    if idx.dtype != rev.dtype:
        raise TypeError(f"rev_gather: idx {idx.dtype} and rev {rev.dtype} "
                        "differ")
    if part.device.type == "cpu":
        return rev_gather_torch(part, idx, rev)
    _check_operands("rev_gather", part, idx, rev)
    part, idx, rev = part.contiguous(), idx.contiguous(), rev.contiguous()
    r, kp, w = part.shape
    out = torch.empty(tuple(idx.shape) + (w,), dtype=part.dtype,
                      device=part.device)
    if out.numel() == 0:
        return out
    n, (elem, index), start = idx.numel(), _sizes(part, idx), part.data_ptr()
    plan = _rev_plan(r * kp, w, n, elem, index, start)
    _launch("rev_gather", "uf3_rev_gather", part.device, start,
            idx.data_ptr(), rev.data_ptr(), out.data_ptr(), n, w, kp, elem,
            index, plan.code, int(plan.wide), plan.values_align)
    rev_gather.launches += 1
    return out


rev_gather.launches = 0


# each gather's kernel and plain version, by its kind
KERNELS = {"rows": gather_rows, "lanes": gather_lanes, "rev": rev_gather}
PLAIN = {"rows": gather_rows_torch, "lanes": gather_lanes_torch,
         "rev": rev_gather_torch}


def sector_bytes(values, offsets) -> int:
    """The bytes of ``values`` in the 32-byte sectors that the flat
    ``offsets`` reach (the card reads memory in sectors), counted from the
    tensor's start, which the allocator aligns to a sector; at most all
    of ``values``."""
    size = values.element_size()
    sectors = torch.unique(offsets.reshape(-1) * size // SECTOR).numel()
    return min(sectors * SECTOR, values.numel() * size)


def gather_bytes(kind: str, out, values, *indices) -> int:
    """The bytes one gather of ``kind`` ("rows", "lanes" or "rev") must
    move on these operands: the indices read once, the output written
    once, and of the table only the sectors that these indices reach
    (``sector_bytes``)."""
    return sector_bytes(values, OFFSETS[kind](values, *indices)) + sum(
        t.numel() * t.element_size() for t in (out,) + indices)


def gather_bound(kind: str, out, values, *indices):
    """The least time in ms the card needs for one gather of ``kind``:
    ``gather_bytes`` over the device memory rate (a gather does no
    arithmetic).  Returns (ms, "bytes", bytes)."""
    n_bytes = gather_bytes(kind, out, values, *indices)
    return 1e3 * n_bytes / PEAK_BYTES, "bytes", n_bytes
