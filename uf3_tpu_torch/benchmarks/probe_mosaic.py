"""
The fragment kernels of ``ops/fragments.py`` at the TPU probes' shapes
and at the full bench system, one case per Pallas fragment kernel of
``benchmarks/probe_mosaic.py`` (every ``try_kernel`` case but the lane
gathers, which ``probe_gather.py`` runs, and ``k_multi``) and per layout
primitive of ``benchmarks/probe_gather2.py`` (p2, p3, p5, p5b), named
``<probe>.<case>`` after the JAX script and its case.

Three kernels cover them (``csrc/fragments.cu``):

- relayout       tile and repeat of (N, 16) rows to 256 lanes
                 (``pltpu.repeat`` tiles: the JAX probe's interpret mode
                 gives ``jnp.tile``), the reshape p2, the transpose p3, p5's
                 two tiles of one read, and the h pattern (slot part 1 of
                 (N 16, 27) tiled along 256 lanes);
- lane_contract  the K x K sums over axis 2 and axis 1 of (N, 256), and the
                 (N 16, 3) @ (3, 27) product;
- lane_map       the one-hots, the cardinal interval, the grid-scalar sum,
                 the r-chain, and k_multi's two outputs of one read.

Each case runs at two sizes: the probe's own (BA = 512 rows, K = 16; p2
(128, 128), p3 (16, 128), p5 / p5b (256, 16)) and the full system (9,856
rows: the bench's 9,826 W atoms padded as ``probe_gather.N_PAD``; p2 as
(1232, 128), the 128-lane tiling of ``probe_gather2.p7``; p3 as (16,
9856), the (K, N) layout of ``probe_dg2.py``).  Each reports the kernel,
the plain version and, where one PyTorch call computes the function, the
library call (``.reshape().clone()``, ``.t().contiguous()``, ``.repeat(1,
K)``, ``.repeat_interleave(K, 1)``, ``torch.index_select`` of h's (A, K
27) view, ``.view(A, K, K).sum(2 | 1)``, ``x @ w`` with TF32 off; none
for the one-hots and the chains), each from a
CUDA graph replay of at least 30 calls, each call on its own copy of the
operands so that they come from device memory (the full system's
operands, 10-30 MB, would otherwise stay in the 50 MB L2 cache from one
call to the next, and the kernels beat the memory bound: the kernel's
time on repeated operands is ``kernel_warm_ms``); the bound (every input
read and every output written once over the card's memory rate, or the
operations over its float rate where that is longer; of a relayout's
input the 32-byte sectors its map reaches; ``fragments.fragment_bound``),
the reached share, ``correct`` and the kernel's largest difference from
the plain version.  ``relayout`` and ``lane_map`` must equal the plain version
bit for bit; ``lane_contract`` and the library's sums and product must lie
within 1e-6 (float32) of the sum of their terms' magnitudes.  Float32
operands drawn from seed 0 as the JAX probes draw them (normal values;
one-hot indices uniform in [0, 9); the (9, 9, 15) grid normal).  A case
that fails to build, launch or match fails the run.

    python -m uf3_tpu_torch.benchmarks.probe_mosaic [--device cpu]

writes ``benchmarks_data/artifacts_torch/probe_mosaic.json``.  With
``--device cpu`` (and ``--max-rows``, which caps each case's rows) it
runs the plain versions and the library calls only: the times are null.
"""

import argparse
import contextlib
import json
from typing import NamedTuple

import numpy as np
import torch

from uf3_tpu_torch.benchmarks import common
from uf3_tpu_torch.benchmarks.probe_gather import N_PAD
from uf3_tpu_torch.ops import fragments, gather


class Case(NamedTuple):
    """One probe case: ``kernel`` relayout / lane_contract / lane_map,
    ``mode`` its mode or op, ``rows`` the probe's own row count (the
    full system has ``N_PAD``)."""
    name: str
    kernel: str
    mode: str
    rows: int


BA, K = 512, 16          # probe_mosaic.py:35
LANES = K * K
H_LANES = LANES          # reshape_4d_index keeps the first 256 lanes
GRID = (9, 9, 15)        # probe_mosaic.py:214
ONEHOT_HIGH = 9          # the probes' indices: randint(0, 9) (:96)
SEED = 0
# float32: the sums and the product against the sum of their terms'
# magnitudes
CONTRACT_TOL = {torch.float32: 1e-6, torch.float64: 2e-15}

CASES = (
    Case("probe_mosaic.tile_lanes", "relayout", "tile", BA),
    Case("probe_mosaic.repeat_lanes", "relayout", "repeat", BA),
    Case("probe_mosaic.pltpu_repeat", "relayout", "tile", BA),
    Case("probe_mosaic.onehot_3d_middle", "lane_map", "onehot_count", BA),
    Case("probe_mosaic.onehot_2d_unrolled", "lane_map", "onehot_sum", BA),
    Case("probe_mosaic.matmul_tiny_k3", "lane_contract", "matmul", BA),
    Case("probe_mosaic.reshape_4d_index", "relayout", "select", BA),
    Case("probe_mosaic.reshape_kk_reduce", "lane_contract", "sum_axis2", BA),
    Case("probe_mosaic.reshape_kk_reduce_ax1", "lane_contract", "sum_axis1",
         BA),
    Case("probe_mosaic.cardinal_interval", "lane_map", "cardinal", BA),
    Case("probe_mosaic.multi_output", "lane_map", "multi", BA),
    Case("probe_mosaic.grid3_scalar_index", "lane_map", "grid3", BA),
    Case("probe_mosaic.sqrt_where_div", "lane_map", "rchain", BA),
    Case("probe_gather2.p2_reshape_128x128_to_1024x16", "relayout",
         "reshape", 1024),
    Case("probe_gather2.p3_transpose_16x128", "relayout", "transpose", 128),
    Case("probe_gather2.p5_repeat_tile_lanes", "relayout", "tile", 256),
    Case("probe_gather2.p5b_jnp_repeat", "relayout", "repeat", 256),
)
SIZES = ("probe", "full")


def operands(case: Case, n: int, rng, device):
    """(args, kwargs) of the case's kernel call at ``n`` rows (the rows
    of the (n, 16) slot layout or of the (n, 256) lanes), drawn from
    ``rng`` in float32."""
    def normal(*shape):
        return torch.as_tensor(rng.randn(*shape), dtype=torch.float32,
                               device=device)

    if case.kernel == "relayout":
        if case.mode == "reshape":     # (n 16 / 128, 128) -> (n, 16)
            return (normal(n * K // 128, 128), case.mode), dict(
                shape=(n, K))
        if case.mode == "transpose":   # (16, n) -> (n, 16)
            return (normal(K, n), case.mode), {}
        if case.mode == "select":      # h (n 16, 27) -> (n, 256)
            return (normal(n * K, 27), case.mode), dict(k=K, lanes=H_LANES)
        return (normal(n, K), case.mode), dict(
            reps=K, pair=case.name.startswith("probe_gather2.p5_"))
    if case.kernel == "lane_contract":
        if case.mode == "matmul":      # (n 16, 3) @ (3, 27)
            return (normal(n * K, 3), case.mode, normal(3, 27)), {}
        return (normal(n, LANES), case.mode), {}
    kwargs = {}
    if case.mode in fragments.ONEHOT_CLASSES:
        kwargs["idx"] = torch.as_tensor(
            rng.randint(0, ONEHOT_HIGH, size=(n, LANES)), dtype=torch.int32,
            device=device)
    if case.mode != "onehot_count":
        kwargs["x"] = normal(n, LANES)
    if case.mode == "grid3":
        kwargs["grid"] = normal(*GRID)
    return (case.mode,), kwargs


_SELECT_COLUMNS = {}


def _select_columns(h, k: int, lanes: int):
    """The columns of h's (n, k w) view that "select" copies to the
    output's, on h's device; made once per shape, so that a timed call
    (or a graph capture) makes none."""
    key = (tuple(h.shape), k, lanes, h.device)
    if key not in _SELECT_COLUMNS:
        _SELECT_COLUMNS[key] = fragments.relayout_offsets(
            h, "select", k=k, lanes=lanes)[0].contiguous()
    return _SELECT_COLUMNS[key]


def library_call(case: Case, args, kwargs):
    """The one PyTorch call that computes the case's function, or None: a
    yardstick, used nowhere in the port."""
    if case.kernel == "relayout":
        x, mode = args
        if mode == "reshape":
            return lambda: x.reshape(kwargs["shape"]).clone()
        if mode == "transpose":
            return lambda: x.t().contiguous()
        if mode == "tile":
            if kwargs["pair"]:
                return lambda: (x.repeat(1, K), x.repeat(1, K))
            return lambda: x.repeat(1, K)
        if mode == "repeat":
            return lambda: x.repeat_interleave(K, 1)
        # select: h's rows of each slot side by side, (n, K 27), and the
        # output's columns picked from them
        cols = _select_columns(x, kwargs["k"], kwargs["lanes"])
        rows = x.view(-1, kwargs["k"] * x.shape[1])
        return lambda: torch.index_select(rows, 1, cols)
    if case.kernel == "lane_contract":
        x, mode = args[:2]
        if mode == "matmul":
            w = args[2]
            return lambda: x @ w
        axis = 2 if mode == "sum_axis2" else 1
        return lambda: x.view(-1, K, K).sum(axis)
    return None


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


def same(a, b) -> bool:
    """Equal shapes, dtypes and values, NaN where the other has NaN."""
    return all(x.shape == y.shape and x.dtype == y.dtype
               and bool(((x == y) | (torch.isnan(x) & torch.isnan(y))).all())
               for x, y in zip(_tuple(a), _tuple(b)))


def contract_scale(args):
    """The sum of the terms' magnitudes of each output of
    ``lane_contract(*args)``: the contraction of |x| (and |w|)."""
    x, mode = args[:2]
    w = args[2] if len(args) > 2 else None
    return fragments.lane_contract_torch(
        x.abs(), mode, None if w is None else w.abs())


def agrees(case: Case, got, ref, args) -> bool:
    """``relayout`` and ``lane_map``: equal bit for bit; ``lane_contract``:
    within ``CONTRACT_TOL`` of the sum of its terms' magnitudes."""
    if case.kernel != "lane_contract":
        return same(got, ref)
    tol = CONTRACT_TOL[ref.dtype] * contract_scale(args)
    return got.shape == ref.shape and bool(((got - ref).abs() <= tol).all())


def max_abs_err(got, ref) -> float:
    return max(float((x.double() - y.double()).abs().max()) if x.numel()
               else 0.0 for x, y in zip(_tuple(got), _tuple(ref)))


def bound(case: Case, args, kwargs, out):
    """The case's bound (``fragments.fragment_bound``): its inputs read
    and its outputs written once (of a relayout's input, the sectors its
    map reaches: h's select reads 9 of every 27 columns) and its
    operations.  Returns (ms, "bytes" or "operations", bytes,
    operations)."""
    outs = _tuple(out)
    written = sum(t.numel() * t.element_size() for t in outs)
    if case.kernel == "relayout":
        x = args[0]
        offsets = fragments.relayout_offsets(x, case.mode, **{
            k: v for k, v in kwargs.items() if k != "pair"})
        n_bytes, flops = gather.sector_bytes(x, offsets) + written, 0
    else:
        n_bytes = written + sum(
            t.numel() * t.element_size()
            for t in list(args) + list(kwargs.values())
            if isinstance(t, torch.Tensor))
        if case.kernel == "lane_contract":
            terms = args[0].shape[1] if case.mode == "matmul" else K
            flops = (2 if case.mode == "matmul" else 1) * terms \
                * outs[0].numel()
        else:
            flops = fragments.LANE_MAP_OPS_PER_ELEMENT[case.mode] \
                * outs[0].numel()
    ms, bound_by = fragments.fragment_bound(n_bytes, flops, outs[0].dtype)
    return ms, bound_by, n_bytes, flops


def run_case(case: Case, size: str, rng, device, max_rows: int = None,
             before=None) -> dict:
    """One case at one size: the kernel and the library call held to the
    plain version (a mismatch raises), the bound and, on a card, the
    device ms of each on operands the L2 cache does not hold
    (``common.graph_cold_ms`` over ``copies`` copies of the operands,
    which together pass twice the cache, at most 128), and the kernel's
    ms on the same operands every call (``kernel_warm_ms``; they then
    stay in the cache).  With ``before`` (a call that makes one graph
    node), each timed call follows that node instead of the call before
    it: its ms are the pair's less ``before_ms``, the node's own, chained
    alone in the same way."""
    n = case.rows if size == "probe" else N_PAD
    if max_rows:
        n = min(n, max_rows)
    args, kwargs = operands(case, n, rng, device)
    kernel = fragments.KERNELS[case.kernel]
    plain = fragments.PLAIN[case.kernel]
    library = library_call(case, args, kwargs)
    ref = plain(*args, **kwargs)
    out = kernel(*args, **kwargs)
    checks = {"kernel": out}
    if library is not None:
        with _no_tf32():
            checks["library"] = library()
    for name, got in checks.items():
        if not agrees(case, got, ref, args):
            raise AssertionError(f"{case.name} ({size}): the {name} differs "
                                 "from the plain version")
    bound_ms, bound_by, n_bytes, flops = bound(case, args, kwargs, out)
    inputs = [list(t.shape) for t in list(args) + list(kwargs.values())
              if isinstance(t, torch.Tensor)]
    record = dict(kernel=case.kernel, mode=case.mode, rows=n, inputs=inputs,
                  outputs=[list(t.shape) for t in _tuple(out)],
                  dtype="float32", bytes=n_bytes, flops=flops,
                  bound_ms=bound_ms, bound_by=bound_by, correct=True,
                  max_abs_err=max_abs_err(out, ref))
    on_card = device.type == "cuda"
    copies = common.cold_copies(n_bytes) if on_card else 0
    sets = [(args, kwargs)] + [_clone(args, kwargs)
                               for _ in range(copies - 1)]
    timed = {"kernel": lambda a, k: kernel(*a, **k),
             "plain": lambda a, k: plain(*a, **k),
             "library": None if library is None
             else lambda a, k: library_call(case, a, k)()}
    before_ms = common.graph_ms(before) \
        if on_card and before is not None else 0.0
    for name, fn in timed.items():
        if fn is None or not on_card:
            record[f"{name}_ms"] = None
            continue
        with _no_tf32():
            record[f"{name}_ms"] = common.graph_cold_ms(
                fn, sets, before=before) - before_ms
    record["copies"] = copies
    if before is not None:
        record["before_ms"] = before_ms if on_card else None
    record["kernel_warm_ms"] = common.graph_ms(
        lambda: kernel(*args, **kwargs)) if on_card else None
    record["reached"] = None if record["kernel_ms"] is None \
        else bound_ms / record["kernel_ms"]
    return record


def _clone(args, kwargs):
    """The operands copied to addresses of their own."""
    def copy(v):
        return v.clone() if isinstance(v, torch.Tensor) else v

    return (tuple(copy(a) for a in args),
            {k: copy(v) for k, v in kwargs.items()})


@contextlib.contextmanager
def _no_tf32():
    """float32 products in full float32 (the library's ``x @ w``)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def main(device=None, max_rows: int = None, out_dir: str = common.ARTIFACTS,
         commit: str = None) -> dict:
    """Run every case at both sizes and write ``probe_mosaic.json`` to
    ``out_dir``.  Returns the artifact."""
    device = common.resolve_device(device)
    rng = np.random.RandomState(SEED)
    artifact = common.header(device, commit)
    artifact.update(scan_len=common.SCAN_LEN, max_rows=max_rows,
                    full_rows=N_PAD, cases={})
    for case in CASES:
        artifact["cases"][case.name] = {
            size: run_case(case, size, rng, device, max_rows)
            for size in SIZES}
    path = common.write_artifact(artifact, out_dir, "probe_mosaic.json")
    print(json.dumps(artifact, indent=1))
    print(f"wrote {path}")
    return artifact


def cli(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--max-rows", type=int, default=None,
                        help="cap each case's rows (a CPU smoke run)")
    parser.add_argument("--out-dir", default=common.ARTIFACTS)
    parser.add_argument("--commit", default=None,
                        help="the artifact's tag (default: git's short "
                             "commit)")
    args = parser.parse_args(argv)
    main(args.device, args.max_rows, out_dir=args.out_dir,
         commit=args.commit)


if __name__ == "__main__":
    cli()
