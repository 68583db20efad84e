"""
The neighbor-gather kernels of ``ops/gather.py`` at the shapes and index
dtypes of the TPU gather probes, one case per Pallas gather kernel of
``benchmarks/``, named ``<probe>.<case>`` after the JAX script and its
case.  Consolidates ``probe_dynamic_gather.py``, ``probe_dg2.py``,
``probe_dg3.py``, ``probe_gather2.py``, ``probe_wg.py``,
``proto_dyngather.py``, ``proto_pallas_gather.py`` and the gather fragments
of ``probe_mosaic.py``.  The Pallas gather of ``step_anatomy.py`` (``gk``)
is the step anatomy's ``kernel_gather``, timed there on the MD step's own
list.

Three functions cover them (``csrc/gather.cu``):

- rows   ``gather_rows(table, idx)``: out[..., c] = table[idx[...], c].
         A broadcast-then-take_along_axis(axis=0) of a (R, 1) column is
         this gather with W = 1; ``probe_dg2.py``'s transposed (K, N)
         forms are the same kernel on the transposed index; the JAX
         probes' (N, 3K) component-major layout of a 3-component gather
         is the (N, K, 3) rows here; ``probe_wg.py``'s P3 (one dynamic
         row broadcast) gathers one 128-wide row for every index.
- lanes  ``gather_lanes(t, li)``: out[a, b] = t[a, li[a, b]]
         (take_along_axis(axis=1)); ``probe_gather2.py``'s p1 takes a
         table broadcast from one row.
- rev    ``rev_gather(part, idx, rev)``: out[..., c] = part[idx[...],
         rev[...], c].  ``probe_dg2.py``'s kernel_c is it on the (K, N)
         slot-major partials, transposed; take_along_axis(axis=0) of a
         materialized (R, C) table (``probe_dg3.py``'s table cases,
         ``probe_gather2.py``'s p6, ``probe_wg.py``'s P2) is it with the
         column as the slot: out[i, c] = t[idx[i, c], c].

Beside them, the engine's own row gathers (``engine.*``): the float32
positions through the int64 neighbor lists that the port's builder
makes on bcc W, as ``ops/neighbors.py``'s ``cached_displacements``
gathers them (``positions[nbr.idx]``): the bench's 3-body list (9,826 x
16) and pair list (9,826 x 72), the plain Verlet defaults' pair list
(9,826 x 78) and the melting protocol's (31,104 x 88).  A real list's
locality is what the table reads see, so these are not drawn at random.

Each case reports the kernel and the library call (``table[idx]``,
``torch.gather(t, 1, li)``, ``part[idx, rev]``), each checked equal to
the plain version bit for bit, the time of each and of the plain
version from a CUDA graph replay of 30 calls on the same operands
(``*_ms``: they stay in the 50 MB L2 across the calls, as in a step
that gathers what it has just written) and on operand copies that
together pass the L2 (``*_cold_ms``, ``common.graph_cold_ms`` over
``common.cold_copies``: what the bound counts, each byte from device
memory), ns per gathered row, the bound (``gather.gather_bytes``: the
indices and output, and the table's sectors that the indices reach,
over the card's memory rate), ``reached`` (the bound over the cold
time), the instance ``gather.gather_plan`` chose, and the kernel's warm
time past a graph node's floor (less ``common.node_floor_ms``'s empty
kernel, measured in the same run: at the step's shapes the bound lies
under that floor).  ``host_us`` holds the host microseconds per eager
call of each wrapper beside its library call (``common.host_chain_ms``,
30 calls ended by a synchronize) at the step's 9,826 x 16 rows and the
defaults' 9,826 x 78: what a caller in the engine would pay on the
host.
Float32 values and int32 indices drawn from seed 0, as the JAX probes.  The JAX
probes' per-case ``try``/``except`` existed because Mosaic might not
compile a kernel; here a case that fails to build, launch or match
fails the run, and the key ``compiles`` is gone.

    python -m uf3_tpu_torch.benchmarks.probe_gather [--device cpu]

writes ``benchmarks_data/artifacts_torch/probe_gather.json``.  With
``--device cpu`` (and ``--max-rows``, which caps every dimension of the
probes' cases, and of the engine cases' index, whose lists then come
from a 128-atom cell) it runs the plain versions and the library calls
only: the device times are null.
"""

import argparse
import json
from typing import NamedTuple, Tuple

import numpy as np
import torch

from uf3_tpu_torch.benchmarks import common
from uf3_tpu_torch.ops import gather


class Case(NamedTuple):
    """One probe case: ``kind`` rows / lanes / rev; ``values`` the table
    shape ((R, W), (A, T) or (R, Kp, W)); ``index`` the index shape;
    ``fill`` how the operands are drawn ("random"; "const": every index
    row 5, as probe_wg.py's P3; "column": rev = the column, for the
    column gathers; "broadcast": a table of one row repeated, as
    probe_gather2.py's p1)."""
    name: str
    kind: str
    values: Tuple[int, ...]
    index: Tuple[int, ...]
    fill: str = "random"


N_PAD = 9856   # 9,826 atoms padded to a sublane multiple (the probes)
N_MD = 9826
N_PROTOCOL = 31104

CASES = (
    Case("probe_dynamic_gather.kernel0", "rows", (N_PAD, 1), (N_PAD, 16)),
    Case("probe_dynamic_gather.kernel1", "lanes", (N_PAD, 16), (N_PAD, 16)),
    Case("probe_dynamic_gather.kernel3", "rows", (N_PAD, 3), (N_PAD, 16)),
    Case("probe_dg2.kernel_a", "rows", (N_PAD, 1), (16, N_PAD)),
    Case("probe_dg2.kernel_b", "rows", (N_PAD, 3), (16, N_PAD)),
    Case("probe_dg2.kernel_c", "rev", (N_PAD, 16, 1), (16, N_PAD)),
) + tuple(
    Case(f"probe_dg2.kernel_d_n{nb}", "rows", (nb, 1), (nb, 16))
    for nb in (256, 1024, 4096, N_PAD)
) + tuple(
    Case(f"probe_dg3.bcast_axis0_n{n}", "rows", (n, 1), (n, 16))
    for n in (8, 64, 256, 1024, 4096, N_PAD)
) + tuple(
    Case(f"probe_dg3.table_axis0_n{n}", "rev", (n, 16, 1), (n, 16), "column")
    for n in (256, N_PAD)
) + (
    Case("probe_dg3.bcast_axis0_n1024_k128", "rows", (1024, 1), (1024, 128)),
    Case("probe_dg3.grid_axis0_full_column", "rows", (N_PAD, 1),
         (N_PAD, 16)),
    Case("probe_gather2.p1_lane_taa_128w", "lanes", (128, 128), (128, 128),
         "broadcast"),
    Case("probe_gather2.p4_lane_taa_mismatch", "lanes", (1024, 128),
         (1024, 16)),
    Case("probe_gather2.p6_tile_axis0_taa", "rev", (8, 128, 1), (8, 128),
         "column"),
    Case("probe_gather2.p7_tilegather_fori", "rows", (N_PAD, 1),
         (N_PAD * 16 // 128, 128)),
    Case("probe_gather2.p7b_tilegather_unrolled", "rows", (N_PAD, 1),
         (N_PAD * 16 // 128, 128)),
) + tuple(
    Case(f"probe_wg.lane_gather_w{w}", "lanes", (256, w), (256, 16))
    for w in (128, 256, 512, 1280)
) + (
    Case("probe_wg.sublane_gather_8row_256idx", "rev", (8, 128, 1),
         (256, 128), "column"),
    Case("probe_wg.dyn_sublane_broadcast", "rows", (8, 128), (256, 1),
         "const"),
    Case("probe_wg.composite_full_onehot8", "rows", (N_PAD, 1), (N_PAD, 16)),
    Case("proto_dyngather.kernel2", "rows", (9832, 1), (9832, 128)),
    Case("proto_dyngather.kernel_lane", "lanes", (9832, 128), (9832, 128)),
    Case("proto_pallas_gather.kernel", "rows", (N_MD, 8), (N_MD, 72)),
    Case("probe_mosaic.lane_taa_k16", "lanes", (512, 16), (512, 16)),
    Case("probe_mosaic.lane_taa_256", "lanes", (512, 256), (512, 256)),
) + tuple(
    Case(f"engine.positions_k{k}", "rows", (n, 3), (n, k), "engine")
    for n, k in ((N_MD, 16), (N_MD, 72), (N_MD, 78), (N_PROTOCOL, 88))
)

# each engine case's list: bcc W repeats, the engine's settings, and the
# list (nbr3: the 3-body list; nbr2: the pair list)
ENGINE = {"engine.positions_k16": ((17, 17, 17), common.BENCH, "nbr3"),
          "engine.positions_k72": ((17, 17, 17), common.BENCH, "nbr2"),
          "engine.positions_k78": ((17, 17, 17), {}, "nbr2"),
          "engine.positions_k88": (common.PROTOCOL_REPS, common.PROTOCOL,
                                   "nbr2")}
# the bcc W cell of the engine cases where every dimension is capped (a
# CPU smoke run)
SMALL_REPS = (4, 4, 4)
# the cases whose wrappers' host cost per call is recorded
HOST_CASES = ("engine.positions_k16", "engine.positions_k78")

SEED = 0
# the kind each kernel computes, by the kernel's name
KIND = {"gather_rows": "rows", "gather_lanes": "lanes", "rev_gather": "rev"}


def library_call(kind: str, operands):
    """The one PyTorch call that computes the case's function: a
    yardstick, used nowhere in the port.  ``torch.gather`` takes int64
    lanes, so it reads an int64 copy made here, before any timing."""
    if kind == "rows":
        table, idx = operands
        return lambda: table[idx]
    if kind == "lanes":
        t, li = operands
        li64 = li.long()
        return lambda: torch.gather(t, 1, li64)
    part, idx, rev = operands
    return lambda: part[idx, rev]


_lists = {}  # the engine cases' (positions, list), built once a process


def engine_state(name: str, device, small: bool = False):
    """(float32 positions, the neighbor list) of the engine case
    ``name``: ``MDSystem`` on bcc W (a = 3.1652 A) at the case's repeats
    (``SMALL_REPS`` where ``small``) and settings, 300 K velocities from
    seed 0, its list from the port's builder at the initial
    positions."""
    from uf3_tpu_torch.data.atoms import bulk
    from uf3_tpu_torch.forcefield.md import MDSystem
    key = (name, str(device), small)
    if key not in _lists:
        reps, engine, which = ENGINE[name]
        geom = bulk("W", "bcc", a=3.1652) * (SMALL_REPS if small else reps)
        system = MDSystem(common.MODEL, geom, dtype=torch.float32,
                          device=device, **engine)
        state = system.init_state(temperature=300.0, seed=0)
        _lists[key] = (state.positions, getattr(state, which))
    return _lists[key]


def operands(case: Case, rng, device, max_rows: int = None):
    """The case's float32 table and int32 indices, drawn from ``rng``
    (values normal, indices uniform over the table's rows or lanes),
    every dimension capped at ``max_rows`` where given; an engine case's
    positions and int64 list (``engine_state``)."""
    def cap(shape):
        return tuple(min(s, max_rows) if max_rows else s for s in shape)

    if case.fill == "engine":
        x, nbr = engine_state(case.name, device, small=bool(max_rows))
        idx = nbr.idx
        if max_rows:
            idx = idx[:max_rows, :max_rows].contiguous()
        return x, idx
    values, index = cap(case.values), cap(case.index)
    if case.fill == "broadcast":
        table = np.broadcast_to(rng.randn(1, values[1]), values).copy()
    else:
        table = rng.randn(*values)
    t = torch.as_tensor(table, dtype=torch.float32, device=device)

    def draw(high):
        return torch.as_tensor(rng.randint(0, high, size=index),
                               dtype=torch.int32, device=device)

    if case.kind == "rows":
        if case.fill == "const":
            return t, torch.full(index, min(5, values[0] - 1),
                                 dtype=torch.int32, device=device)
        return t, draw(values[0])
    if case.kind == "lanes":
        return t, draw(values[1])
    idx = draw(values[0])
    if case.fill == "column":
        rev = torch.arange(index[-1], dtype=torch.int32,
                           device=device).expand(index).contiguous()
    else:
        rev = draw(values[1])
    return t, idx, rev


def cold_sets(ops, n_bytes: int):
    """``ops`` and copies of them at their own addresses, as many as
    together pass the L2 twice where each call moves ``n_bytes``
    (``common.cold_copies``)."""
    return [ops] + [tuple(t.clone() for t in ops)
                    for _ in range(common.cold_copies(n_bytes) - 1)]


def cold_ms(calls) -> float:
    """Device ms of one of ``calls`` (each a call on its own operand
    copy), the copies taken in turn in one CUDA graph
    (``common.graph_cold_ms``)."""
    return common.graph_cold_ms(lambda call: call(), [(c,) for c in calls])


def run_case(case: Case, rng, device, max_rows: int = None) -> dict:
    """One case: the kernel and the library call held to the plain
    version bit for bit (a mismatch raises), and on a card the device
    ms of each (``SCAN_LEN`` calls in one CUDA graph) on the same
    operands and on copies past the L2, ns per row and the bound."""
    ops = operands(case, rng, device, max_rows)
    kernel, plain = gather.KERNELS[case.kind], gather.PLAIN[case.kind]
    library = library_call(case.kind, ops)
    ref = plain(*ops)
    out = kernel(*ops)
    for name, got in (("kernel", out), ("library", library())):
        if not torch.equal(got, ref):
            raise AssertionError(f"{case.name}: the {name} differs from "
                                 "the plain version")
    rows = ops[1].numel()
    bound_ms, bound_by, n_bytes = gather.gather_bound(case.kind, out, *ops)
    record = dict(kind=case.kind,
                  values=list(ops[0].shape), index=list(ops[1].shape),
                  dtype=str(ops[0].dtype)[6:],
                  index_dtype=str(ops[1].dtype)[6:],
                  rows=rows, bytes=n_bytes, bound_ms=bound_ms,
                  bound_by=bound_by, correct=True,
                  instance=plan_of(case.kind, ops)._asdict()
                  if case.kind != "rev" else None)
    on_card = device.type == "cuda"
    sets = cold_sets(ops, n_bytes) if on_card else None
    record["cold_copies"] = None if sets is None else len(sets)
    for name, fn in (("kernel", kernel), ("plain", plain),
                     ("library", None)):
        def call(o, fn=fn):
            return (lambda: fn(*o)) if fn else library_call(case.kind, o)
        ms = common.graph_ms(call(ops)) if on_card else None
        record[f"{name}_ms"] = ms
        record[f"{name}_cold_ms"] = cold_ms([call(o) for o in sets]) \
            if on_card else None
        record[f"{name}_ns_per_row"] = None if ms is None \
            else ms * 1e6 / rows
    record["reached"] = None if record["kernel_cold_ms"] is None \
        else bound_ms / record["kernel_cold_ms"]
    return record


def plan_of(kind: str, ops):
    """The instance the row or lane wrapper runs on ``ops`` (its
    ``gather.GatherPlan``)."""
    return (gather.rows_plan if kind == "rows" else gather.lanes_plan)(*ops)


def host_costs(device, max_rows: int = None) -> dict:
    """Host microseconds per eager call (``common.host_chain_ms``: 30
    calls, then a synchronize on a card; best of 3) of each gather's
    wrapper and its library call, at the step's 9,826 x 16 rows and the
    defaults' 9,826 x 78: the row gather of the positions through the
    list, the lane gather of an (N, K) table at random lanes (int64),
    and, on the 3-body list, the reverse-slot gather of (N, 16, 5)
    partials through its reverse slots (a pair list holds none)."""
    rng = np.random.RandomState(SEED)
    out = {}
    for name in HOST_CASES:
        x, nbr = engine_state(name, device, small=bool(max_rows))
        idx = nbr.idx
        n, k = idx.shape
        t = torch.as_tensor(rng.randn(n, k), dtype=torch.float32,
                            device=device)
        li = torch.as_tensor(rng.randint(0, k, size=(n, k)), device=device)
        calls = {"rows": (x, idx), "lanes": (t, li)}
        if name == "engine.positions_k16":
            calls["rev"] = (torch.as_tensor(rng.randn(n, k, 5),
                                            dtype=torch.float32,
                                            device=device), idx, nbr.rev)
        record = {}
        for kind, ops in calls.items():
            for who, fn in (("kernel", lambda: gather.KERNELS[kind](*ops)),
                            ("library", library_call(kind, ops))):
                record[f"{kind} {who}"] = 1e3 * common.host_chain_ms(
                    lambda y, fn=fn: (fn(), y)[1], x)
        out[f"{n} x {k}"] = record
    return out


def main(device=None, max_rows: int = None, out_dir: str = common.ARTIFACTS,
         commit: str = None) -> dict:
    """Run every case and write ``probe_gather.json`` to ``out_dir``.
    Returns the artifact."""
    device = common.resolve_device(device)
    rng = np.random.RandomState(SEED)
    artifact = common.header(device, commit)
    floor = common.node_floor_ms(device) if device.type == "cuda" else None
    artifact.update(scan_len=common.SCAN_LEN, max_rows=max_rows,
                    node_floor_ms=floor, cases={})
    for case in CASES:
        record = run_case(case, rng, device, max_rows)
        record["past_floor_ms"] = None if floor is None \
            else record["kernel_ms"] - floor["empty kernel"]
        artifact["cases"][case.name] = record
    artifact["host_us"] = host_costs(device, max_rows)
    path = common.write_artifact(artifact, out_dir, "probe_gather.json")
    print(json.dumps(artifact, indent=1))
    print(f"wrote {path}")
    return artifact


def cli(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--max-rows", type=int, default=None,
                        help="cap every dimension (a CPU smoke run)")
    parser.add_argument("--out-dir", default=common.ARTIFACTS)
    parser.add_argument("--commit", default=None,
                        help="the artifact's tag (default: git's short "
                             "commit)")
    args = parser.parse_args(argv)
    main(args.device, args.max_rows, out_dir=args.out_dir,
         commit=args.commit)


if __name__ == "__main__":
    cli()
