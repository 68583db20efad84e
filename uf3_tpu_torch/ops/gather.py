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
"""

import torch

from uf3_tpu_torch.ops import _build

# NVIDIA H100 SXM device memory rate (data sheet, at 700 W)
PEAK_BYTES = 3.35e12
# the granule in bytes in which the card reads device memory
SECTOR = 32
_FLOATS = (torch.float32, torch.float64)
_INDICES = (torch.int32, torch.int64)


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



def gather_rows(table, idx):
    """Rows of the (R, W) ``table`` at the indices ``idx`` (any shape):
    an (idx.shape + (W,)) tensor.  A CUDA tensor runs the kernel of
    ``csrc/gather.cu`` or raises; a CPU tensor runs the plain version."""
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
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        _build.launch("gather_rows", _build.library().uf3_gather_rows,
                      table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                      idx.numel(), w, *_sizes(table, idx), stream)
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


def gather_lanes(t, li):
    """Entries of each row of the (A, T) ``t`` at that row's lanes ``li``
    (A, B): an (A, B) tensor.  A CUDA tensor runs the kernel of
    ``csrc/gather.cu`` or raises; a CPU tensor runs the plain version."""
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
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        _build.launch("gather_lanes", _build.library().uf3_gather_lanes,
                      t.data_ptr(), li.data_ptr(), out.data_ptr(), li.shape[0],
                      li.shape[1], t.shape[1], *_sizes(t, li), stream)
    gather_lanes.launches += 1
    return out


gather_lanes.launches = 0


def rev_gather(part, idx, rev):
    """Rows ``part[idx, rev]`` of the (R, Kp, W) partials ``part`` at the
    slot indices ``idx`` and reverse slots ``rev`` (one shape, one
    dtype): an (idx.shape + (W,)) tensor.  A CUDA tensor runs the kernel
    of ``csrc/gather.cu`` or raises; a CPU tensor runs the plain
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
    _, kp, w = part.shape
    out = torch.empty(tuple(idx.shape) + (w,), dtype=part.dtype,
                      device=part.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(part.device):
        stream = torch.cuda.current_stream(part.device).cuda_stream
        _build.launch("rev_gather", _build.library().uf3_rev_gather,
                      part.data_ptr(), idx.data_ptr(), rev.data_ptr(),
                      out.data_ptr(), idx.numel(), w, kp, *_sizes(part, idx),
                      stream)
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
