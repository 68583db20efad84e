"""
The TPU probes' fragments of the fused trio block as three hand-written
kernels (``csrc/fragments.cu``), each beside its plain torch version:

- ``relayout(x, mode, ...)``: a copy through an index map, ``out[o] =
  x[src(o)]``: "reshape" (to ``shape``), "transpose" (of a 2-D x),
  "tile" and "repeat" (of each row, ``reps`` times; ``jnp.tile`` and
  ``jnp.repeat``; "tile" with ``pair=True`` writes two outputs from one
  read), "select" (``h``'s (K, 3, 9) slice 1 tiled along the row:
  ``out[a, j] = h[a K + q div 9, 9 + q mod 9]``, q = j mod 9K);
- ``lane_contract(x, mode, w=None)``: ``out[a, j] = sum_t x[a, off(j,
  t)] w[t, j]`` in the order t = 0 .. T-1: "sum_axis2" and "sum_axis1"
  (the sums of an (A, K*K) array viewed (A, K, K) over its last or middle
  axis), "matmul" ((M, T) @ (T, J));
- ``lane_map(op, x=None, idx=None, grid=None)``: the elementwise chains
  "onehot_count" (sum over w < 12 of (w == idx)), "onehot_sum" (sum over
  w < 9 of (idx == w ? x : 0) (w + 1)), "cardinal" (the cardinal interval:
  t = 2.5 x + 4, i = clip(floor t, 0, 8), u = t - i, u u (3 - 2u) + i),
  "grid3" (sum over b, c < 3 of grid[b, b, c] x), "rchain" (x / sqrt(
  where(x x > 0, x x, 1))), "multi" (2 x and x + 1, two outputs).

They are the port of the Pallas fragment probes of
``benchmarks/probe_mosaic.py`` (every ``try_kernel`` case but the lane
gathers, which are ``ops/gather.py``'s, and ``k_multi``) and the layout
primitives of ``benchmarks/probe_gather2.py`` (p2, p3, p5, p5b);
``csrc/fragments.cu`` names each.  They are measured by
``uf3_tpu_torch.benchmarks.probe_mosaic``.  No MD, calculator or fit path
calls them.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version.  The plain versions write each probe's expression op by op in
its order (the sums as a loop over t, the one-hots as the loop over w);
``relayout_torch`` copies through the index map the kernel computes
(``relayout_offsets``).  Float32 and float64 values, int32 indices.  The
kernels round each operation once, in the plain versions' order, so
``relayout`` and ``lane_map`` equal them bit for bit (NaN where they give
NaN) and ``lane_contract`` does too on the card, where the tests hold it
to 1e-6 (float32) of the sum of its terms' magnitudes.  Each wrapper's
``launches`` counts its kernel launches.
"""

import ctypes
import math

import torch

from uf3_tpu_torch.ops import _build
from uf3_tpu_torch.ops.gather import PEAK_BYTES

# NVIDIA H100 SXM float32 and float64 rates outside the tensor cores
# (data sheet, at 700 W)
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
_FLOATS = (torch.float32, torch.float64)
RELAYOUT_MODES = {"reshape": 0, "transpose": 1, "tile": 2, "repeat": 3,
                  "select": 4}
CONTRACT_MODES = ("sum_axis2", "sum_axis1", "matmul")
LANE_MAP_OPS = {"onehot_count": 0, "onehot_sum": 1, "cardinal": 2,
                "grid3": 3, "rchain": 4, "multi": 5}
# the probes' one-hot widths: the 3-D one-hot's 12 (probe_mosaic.py:100),
# the unrolled 2-D one-hot's 9 (:108)
ONEHOT_CLASSES = {"onehot_count": 12, "onehot_sum": 9}
# h's rows: (3, 9) per slot, of which "select" takes part 1 (:137)
H_PARTS, H_PART = 3, 1
# the cardinal interval's constants (probe_mosaic.py:165-166)
CARD_SCALE, CARD_SHIFT, CARD_LAST = 2.5, 4.0, 8.0
# per element, the operations each chain does (the bound's count): per
# class a compare and an add; a compare, two products and an add; the
# cardinal chain's 11; the grid's 9 products and adds; square, compare,
# sqrt, divide; one product and one add for two outputs
LANE_MAP_OPS_PER_ELEMENT = {"onehot_count": 2 * 12, "onehot_sum": 4 * 9,
                            "cardinal": 11, "grid3": 18, "rchain": 4,
                            "multi": 2}
# the shared memory lane_contract's weights may take
MAX_CONTRACT_W_BYTES = 48 * 1024


# -- relayout ---------------------------------------------------------------
def relayout_shape(x, mode: str, reps: int = None, shape=None, k: int = None,
                   lanes: int = None):
    """The output shape of ``relayout(x, mode, ...)``; raises on a shape
    the mode does not take."""
    if mode not in RELAYOUT_MODES:
        raise ValueError(f"relayout: no mode {mode!r}; modes "
                         f"{sorted(RELAYOUT_MODES)}")
    if mode == "reshape":
        shape = tuple(int(s) for s in shape)
        if math.prod(shape) != x.numel():
            raise ValueError(f"relayout: cannot reshape {tuple(x.shape)} "
                             f"to {shape}")
        return shape
    if x.dim() != 2:
        raise ValueError(f"relayout {mode} takes a 2-D tensor; got shape "
                         f"{tuple(x.shape)}")
    rows, cols = x.shape
    if mode == "transpose":
        return cols, rows
    if mode in ("tile", "repeat"):
        if reps is None or reps < 1:
            raise ValueError(f"relayout {mode} takes reps >= 1; got {reps}")
        return rows, cols * reps
    if k is None or lanes is None or k < 1 or lanes < 1 or rows % k \
            or cols % H_PARTS:
        raise ValueError(f"relayout select takes h (A K, {H_PARTS} w), k and "
                         f"lanes; got shape {tuple(x.shape)}, k={k}, "
                         f"lanes={lanes}")
    return rows // k, lanes


def relayout_offsets(x, mode: str, reps: int = None, shape=None,
                     k: int = None, lanes: int = None):
    """The flat offsets into ``x`` that ``relayout`` copies to each output
    element, in the output's shape."""
    out_shape = relayout_shape(x, mode, reps, shape, k, lanes)
    if mode == "reshape":
        return torch.arange(x.numel(), device=x.device).reshape(out_shape)
    a = torch.arange(out_shape[0], device=x.device)[:, None]
    j = torch.arange(out_shape[1], device=x.device)[None, :]
    cols = x.shape[1]
    if mode == "transpose":
        return j * cols + a
    if mode == "tile":
        return a * cols + j % cols
    if mode == "repeat":
        return a * cols + j // reps
    w = cols // H_PARTS
    q = j % (k * w)
    return (a * k + q // w) * cols + H_PART * w + q % w


def relayout_torch(x, mode: str, reps: int = None, shape=None, k: int = None,
                   lanes: int = None, pair: bool = False):
    """Plain version of ``relayout``: ``x`` copied through
    ``relayout_offsets``; with ``pair`` (tile only) two such copies."""
    out = torch.take(x, relayout_offsets(x, mode, reps, shape, k, lanes))
    return (out, out.clone()) if pair else out


def relayout(x, mode: str, reps: int = None, shape=None, k: int = None,
             lanes: int = None, pair: bool = False):
    """``x`` copied through the index map of ``mode`` (module docstring):
    one tensor, or two equal ones with ``pair`` ("tile" only).  A CUDA
    tensor runs the kernel of ``csrc/fragments.cu`` or raises; a CPU
    tensor runs the plain version."""
    if pair and mode != "tile":
        raise ValueError("relayout: pair=True is for mode 'tile'")
    out_shape = relayout_shape(x, mode, reps, shape, k, lanes)
    _check_dtypes("relayout", x)
    if _on_cpu("relayout", x):
        return relayout_torch(x, mode, reps, shape, k, lanes, pair)
    x = x.contiguous()
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    out2 = torch.empty_like(out) if pair else None
    if out.numel():
        cols = x.shape[-1] if x.dim() == 2 else 0   # the reshape reads none
        in_cols, out_cols, kk, w, offset = cols, out_shape[-1], 0, 0, 0
        if mode == "repeat":
            kk = reps
        elif mode == "select":
            kk, w = k, cols // H_PARTS
            offset = H_PART * w
        _build.launch_on("relayout", x.device, _build.library().uf3_relayout,
                         x.data_ptr(), out.data_ptr(),
                         out2.data_ptr() if pair else None, out.numel(),
                         max(out.numel(), x.numel()), RELAYOUT_MODES[mode],
                         in_cols, out_cols, kk, w, offset, x.element_size())
        relayout.launches += 1
        relayout.launches_by_mode[mode] = \
            relayout.launches_by_mode.get(mode, 0) + 1
    return (out, out2) if pair else out


relayout.launches = 0
relayout.launches_by_mode = {}  # mode -> its launches


def relayout_occupancy(mode: str, dtype=torch.float32) -> dict:
    """The launch plan of ``relayout``'s kernel for ``mode`` on ``dtype``
    words with 32-bit offsets, from the CUDA runtime: registers and local
    (spill) bytes per thread, resident blocks of 256 threads (the
    transpose's tiles among them) and warps per SM."""
    if mode not in RELAYOUT_MODES:
        raise ValueError(f"relayout: no mode {mode!r}; modes "
                         f"{sorted(RELAYOUT_MODES)}")
    out = (ctypes.c_int * 4)()
    err = _build.library().uf3_relayout_occupancy(
        RELAYOUT_MODES[mode], torch.empty((), dtype=dtype).element_size(),
        out)
    if err != 0:
        raise RuntimeError(f"uf3_relayout_occupancy failed ({err})")
    return dict(registers=out[0], local_bytes=out[1], blocks_per_sm=out[2],
                warps_per_sm=out[3])


# -- lane_contract ----------------------------------------------------------
def contract_plan(x, mode: str, w=None):
    """(rows, cols_out, terms, sj, st): ``out[a, j] = sum over t < terms
    of x[a, j sj + t st] (w[t, j])``; raises on shapes the mode does not
    take."""
    if mode not in CONTRACT_MODES:
        raise ValueError(f"lane_contract: no mode {mode!r}; modes "
                         f"{CONTRACT_MODES}")
    if x.dim() != 2:
        raise ValueError(f"lane_contract takes a 2-D x; got shape "
                         f"{tuple(x.shape)}")
    rows, cols = x.shape
    if mode == "matmul":
        if w is None or w.dim() != 2 or w.shape[0] != cols:
            raise ValueError(f"lane_contract matmul takes x (M, T) and w "
                             f"(T, J); got {tuple(x.shape)} and "
                             f"{None if w is None else tuple(w.shape)}")
        return rows, w.shape[1], cols, 0, 1
    if w is not None:
        raise ValueError(f"lane_contract {mode} takes no w")
    k = math.isqrt(cols)
    if k * k != cols:
        raise ValueError(f"lane_contract {mode} takes x (A, K*K); got "
                         f"{tuple(x.shape)}")
    return (rows, k, k, k, 1) if mode == "sum_axis2" else (rows, k, k, 1, k)


def lane_contract_torch(x, mode: str, w=None):
    """Plain version of ``lane_contract``: a zero accumulator and, for t =
    0 .. T-1 in order, ``acc = acc + x[:, j sj + t st] (* w[t])``."""
    rows, cols_out, terms, sj, st = contract_plan(x, mode, w)
    cols = torch.arange(cols_out, device=x.device) * sj
    acc = torch.zeros((rows, cols_out), dtype=x.dtype, device=x.device)
    for t in range(terms):
        term = x[:, cols + t * st]
        acc = acc + (term if w is None else term * w[t])
    return acc


def lane_contract(x, mode: str, w=None):
    """The (A, J) contraction of ``mode`` (module docstring).  A CUDA
    tensor runs the kernel of ``csrc/fragments.cu`` or raises; a CPU
    tensor runs the plain version."""
    rows, cols_out, terms, sj, st = contract_plan(x, mode, w)
    operands = (x,) if w is None else (x, w)
    _check_dtypes("lane_contract", *operands)
    if _on_cpu("lane_contract", *operands):
        return lane_contract_torch(x, mode, w)
    if w is not None and w.numel() * w.element_size() > MAX_CONTRACT_W_BYTES:
        raise ValueError(f"lane_contract: w of {tuple(w.shape)} passes the "
                         f"{MAX_CONTRACT_W_BYTES} bytes of shared memory")
    x = x.contiguous()
    w = None if w is None else w.contiguous()
    out = torch.empty((rows, cols_out), dtype=x.dtype, device=x.device)
    if out.numel():
        _build.launch_on("lane_contract", x.device,
                         _build.library().uf3_lane_contract, x.data_ptr(),
                         None if w is None else w.data_ptr(), out.data_ptr(),
                         out.numel(), max(out.numel(), x.numel()), cols_out,
                         terms, x.shape[1], sj, st,
                         int(x.dtype == torch.float64))
        lane_contract.launches += 1
    return out


lane_contract.launches = 0

CONTRACT_KERNELS = ("tile", "rows", "rows_along_outputs", "sum_tiles")


def lane_contract_occupancy(x, mode: str, w=None) -> dict:
    """The launch plan of the kernel that ``lane_contract(x, mode, w)``
    launches (on a CUDA ``x``; nothing is launched), from the CUDA
    runtime: registers and local (spill) bytes per thread, resident
    blocks of 256 threads and warps per SM at its shared memory, the
    kernel (``CONTRACT_KERNELS``: the product's tile, one output a
    thread, 16-byte vectors along the outputs, or the staged tiles of
    the sum over axis 2) and the blocks it launches."""
    rows, cols_out, terms, sj, st = contract_plan(x, mode, w)
    n = rows * cols_out
    if not n:
        raise ValueError("lane_contract_occupancy: an empty output")
    x = x.contiguous()
    w = None if w is None else w.contiguous()
    out = (ctypes.c_int * 6)()
    # the output the wrapper allocates starts on a 16-byte boundary, as
    # the null pointer given in its place does
    err = _build.library().uf3_lane_contract_occupancy(
        x.data_ptr(), None if w is None else w.data_ptr(), None, n,
        max(n, x.numel()), cols_out, terms, x.shape[1], sj, st,
        int(x.dtype == torch.float64), out)
    if err != 0:
        raise RuntimeError(f"uf3_lane_contract_occupancy failed ({err})")
    return dict(registers=out[0], local_bytes=out[1], blocks_per_sm=out[2],
                warps_per_sm=out[3], kernel=CONTRACT_KERNELS[out[4]],
                blocks=out[5])


# -- lane_map ---------------------------------------------------------------
def _map_operands(op: str, x, idx, grid, dtype):
    """(shape, dtype) of the op's output; raises on missing, extra or
    mismatched operands."""
    if op not in LANE_MAP_OPS:
        raise ValueError(f"lane_map: no op {op!r}; ops "
                         f"{sorted(LANE_MAP_OPS)}")
    needs = {"x": op != "onehot_count",
             "idx": op in ONEHOT_CLASSES, "grid": op == "grid3"}
    given = {"x": x is not None, "idx": idx is not None,
             "grid": grid is not None}
    if needs != given:
        raise ValueError(f"lane_map {op} takes "
                         f"{[k for k, v in needs.items() if v]}; got "
                         f"{[k for k, v in given.items() if v]}")
    if idx is not None and idx.dtype != torch.int32:
        raise TypeError(f"lane_map takes int32 indices; got {idx.dtype}")
    if x is not None and idx is not None and x.shape != idx.shape:
        raise ValueError(f"lane_map {op}: x {tuple(x.shape)} and idx "
                         f"{tuple(idx.shape)} differ")
    if grid is not None and (grid.dim() != 3 or min(grid.shape) < 3
                             or grid.dtype != x.dtype):
        raise ValueError(f"lane_map grid3 takes a (>=3, >=3, >=3) grid of "
                         f"x's dtype; got {tuple(grid.shape)} {grid.dtype}")
    if x is not None:
        return tuple(x.shape), x.dtype
    return tuple(idx.shape), dtype or torch.float32


def lane_map_torch(op: str, x=None, idx=None, grid=None, dtype=None):
    """Plain version of ``lane_map``: the probe's expression op by op."""
    _, out_dtype = _map_operands(op, x, idx, grid, dtype)
    if op == "onehot_count":
        acc = torch.zeros(idx.shape, dtype=out_dtype, device=idx.device)
        for w in range(ONEHOT_CLASSES[op]):
            acc = acc + (idx == w).to(out_dtype)
        return acc
    if op == "onehot_sum":
        # (idx == w) x as XLA compiles the probe's one-hot product: a
        # select, so that an infinite or NaN x adds nothing where idx != w
        acc = torch.zeros_like(x)
        zero = torch.zeros_like(x)
        for w in range(ONEHOT_CLASSES[op]):
            acc = acc + torch.where(idx == w, x, zero) * float(w + 1)
        return acc
    if op == "cardinal":
        # clip(floor t, 0, 8) in floating point: the probe's int32 cast is
        # exact on [0, 8], and on a NaN t the result is NaN either way
        t = x * CARD_SCALE + CARD_SHIFT
        i = torch.clamp(torch.floor(t), 0.0, CARD_LAST)
        u = t - i
        return u * u * (3.0 - 2.0 * u) + i
    if op == "grid3":
        acc = torch.zeros_like(x)
        for b in range(3):
            for c in range(3):
                acc = acc + grid[b, b, c] * x
        return acc
    if op == "rchain":
        r2 = x * x
        r = torch.sqrt(torch.where(r2 > 0, r2, torch.ones_like(r2)))
        return x / r
    return x * 2.0, x + 1.0


def lane_map(op: str, x=None, idx=None, grid=None, dtype=None):
    """The elementwise chain ``op`` (module docstring) on ``x`` and / or
    the int32 ``idx`` (and ``grid`` for "grid3"): one tensor of x's shape
    and dtype (idx's shape and ``dtype``, float32 by default, for
    "onehot_count"), two for "multi".  A CUDA tensor runs the kernel of
    ``csrc/fragments.cu`` or raises; a CPU tensor runs the plain
    version."""
    shape, out_dtype = _map_operands(op, x, idx, grid, dtype)
    _check_dtypes("lane_map", *(t for t in (x, grid) if t is not None))
    if out_dtype not in _FLOATS:
        raise TypeError(f"lane_map gives float32 or float64; got {out_dtype}")
    if _on_cpu("lane_map", *(t for t in (x, idx, grid) if t is not None)):
        return lane_map_torch(op, x, idx, grid, dtype)
    lead = x if x is not None else idx
    x, idx, grid = (None if t is None else t.contiguous()
                    for t in (x, idx, grid))
    out = torch.empty(shape, dtype=out_dtype, device=lead.device)
    out2 = torch.empty_like(out) if op == "multi" else None
    if out.numel():
        g_s0, g_s1 = (grid.shape[1] * grid.shape[2], grid.shape[2]) \
            if grid is not None else (0, 0)
        pointers = (None if t is None else t.data_ptr()
                    for t in (x, idx, grid, out, out2))
        _build.launch_on("lane_map", lead.device,
                         _build.library().uf3_lane_map, LANE_MAP_OPS[op],
                         *pointers, out.numel(), ONEHOT_CLASSES.get(op, 0),
                         g_s0, g_s1, int(out_dtype == torch.float64))
        lane_map.launches += 1
    return (out, out2) if op == "multi" else out


lane_map.launches = 0


def _check_dtypes(name: str, *values):
    """Float32 or float64 values, all of one dtype."""
    for t in values:
        if t.dtype not in _FLOATS:
            raise TypeError(f"{name} takes float32 or float64 values; got "
                            f"{t.dtype}")
        if t.dtype != values[0].dtype:
            raise TypeError(f"{name}: operands of {values[0].dtype} and "
                            f"{t.dtype}")


def _on_cpu(name: str, *tensors) -> bool:
    """Whether the operands lie on the CPU (the plain version); raises
    where they lie on different devices or on a device with no kernel."""
    device = tensors[0].device
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: operands on different devices "
                             f"({device}, {t.device})")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {name} kernel for device {device}")
    return device.type == "cpu"



# each kernel and its plain version, by name
KERNELS = {"relayout": relayout, "lane_contract": lane_contract,
           "lane_map": lane_map}
PLAIN = {"relayout": relayout_torch, "lane_contract": lane_contract_torch,
         "lane_map": lane_map_torch}


def fragment_bound(n_bytes: int, flops: float, dtype):
    """The least time in ms the card needs to move ``n_bytes`` (each input
    read once, each output written once) and do ``flops`` operations at
    ``dtype``'s rate: (ms, "bytes" or "operations")."""
    by_bytes = 1e3 * n_bytes / PEAK_BYTES
    by_ops = 1e3 * flops / PEAK_FLOPS[dtype]
    return (by_ops, "operations") if by_ops > by_bytes else (by_bytes,
                                                             "bytes")
