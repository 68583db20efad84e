"""
Per-phase anatomy of the 3-level r-RESPA step on the card, host against
device.  Port of ``benchmarks/anatomy_3l.py``.

The engine: bcc W 17^3 = 9,826 atoms, ``model_2and3.json``, float32
(float64 on the CPU), skins 0.5 / 1.2 A, 72 / 16 slots, 3-level r-RESPA
at ``cadence`` = (n_respa, respa_mid, rebuild_every): the reference's
9/3/27 by default, at the engine's default switch (3.0, 3.5) A as the
reference runs it; at the bench path's 12/6/36 the bench engine
(``common.BENCH``), its (2.5, 3.5) A switch included.  135 Langevin
steps at 300 K warm it up, the end-to-end windows run (below), and the
phases are timed on the state's positions and lists after them, each built
from the port's own engine functions (R = rebuild_every; the weight of
each in a rebuild cycle on the right):

    inner_force_fresh_gather  pair_short_forces, (N, 16) rows     R
    gather_only               the rows' gather, displacements
    inner_math_only           the switched pair chain, fixed rows
    trio_map_comps_reuse      trio_forces (the trio kernel,       R / respa_mid
                              its assembly), fixed rows, full lanes
    trio_map_triangle         the same on the triangle lanes
    tail_force                pair_tail_forces, (N, 72) rows       R / n_respa
    stale_check_both          needs_rebuild on both lists          R
    langevin                  the Langevin kick, drawn from the    R
                              state's own generator
    rebuild_3b_filter         filter_neighbor_list from the pair   refilters
                              list
    rebuild_full_standalone   the full branch: wrap, then          full builds
                              MDSystem.build_lists

Device ms: ``SCAN_LEN`` chained bodies in one CUDA graph, replayed
between CUDA events (``common.graph_chain_ms``), in place of the
reference's scan less a null scan: a graph holds no dispatch to
subtract, so ``net_of_null_ms`` equals the phases' device ms, and a
graph node's floor (``node_floor_ms``) stands beside them in place of
``null_scan``.  The Langevin body registers its generator with the
graph.  The refilter and the full build read the card on the host
(``_compact``'s ``nonzero``, the cell list's ``bincount`` and
index-put, its stencil copies), which a graph cannot capture: they run
eagerly, and their device ms is the profiler's busy time per call
(``common.profiled_device_ms``).  Host ms: the same bodies run eagerly,
ended by a synchronize (``common.host_chain_ms``).

End to end: one warm window, then ``windows`` windows of
``window_cycles`` rebuild cycles (20: 540 steps at 9/3/27, 720 at
12/6/36) with ``launch_chunks=10, sync=False``; ms per step of the
median window, beside the least and the greatest.  The reference times
its windows after the phases; here they run first, and as many again
after the phases (``e2e_after_phases_ms_per_step``): the host's rate
swings within one process on the card, and the two sets show how far
over the run.  The cycle model per step, once from device ms and once
from host ms:

    [R (inner + stale + langevin) + R / respa_mid trio
     + R / n_respa tail + refilters x refilter + full builds x full] / R

with the refilters and full builds per cycle counted in the timed
windows (``MDSystem.rebuild_branches``).  The reference weighs 0.6
refilter a cycle and no full build (``benchmarks/anatomy_3l.py:229-237``),
a constant of a rebuild scheme the engine no longer runs: it refilters
on every cycle where no full build is due.  ``unmodeled_ms_per_step`` is
the end-to-end time less the host model, ``unmodeled_device_ms_per_step``
the end-to-end time less the device model.

    python -m uf3_tpu_torch.benchmarks.anatomy_3l [--cadence 12 6 36]
        [--device cpu --reps 4 4 4]

writes ``anatomy_3l_<n_respa>_<respa_mid>_<rebuild_every>.json`` under
``benchmarks_data/artifacts_torch/``.  On the CPU the device keys are
null.
"""

import argparse
import json
import math
import statistics
import time
from typing import Callable, NamedTuple

import torch

from uf3_tpu_torch.benchmarks import common
from uf3_tpu_torch.forcefield import units
from uf3_tpu_torch.forcefield.md import MDSystem
from uf3_tpu_torch.ops import neighbors as nb
from uf3_tpu_torch.ops.pair import (pair_row_forces, pair_short_forces,
                                    pair_tail_forces)
from uf3_tpu_torch.ops.trio import trio_forces

# benchmarks/anatomy_3l.py:74-84
CADENCE = (9, 3, 27)
ENGINE = dict(skin=0.5, skin_2b=1.2, capacity_2b=72, capacity_3b=16)
REPS = (17, 17, 17)
WARM_STEPS = 135
WINDOW_CYCLES = 20
WINDOWS = 3
LAUNCH_CHUNKS = 10
TEMPERATURE = 300.0
DT_FS = 2.0
FRICTION_PS = 2.0
FULL_BUILD_CALLS = 5
EPS = 1e-30
# the phases a graph cannot capture, run eagerly with their device time
# from the profiler, and the calls each is timed over (None: the chain's
# length)
EAGER = {"rebuild_3b_filter": None,
         "rebuild_full_standalone": FULL_BUILD_CALLS}


def engine(cadence) -> dict:
    """The engine's settings at ``cadence``: the bench engine at its own
    cadence, else the reference's (the engine's default switch)."""
    n_respa, respa_mid, rebuild_every = cadence
    bench = common.BENCH
    if (n_respa, respa_mid, rebuild_every) == (
            bench["n_respa"], bench["respa_mid"], bench["rebuild_every"]):
        return dict(bench)
    return dict(ENGINE, n_respa=n_respa, respa_mid=respa_mid,
                rebuild_every=rebuild_every)


class Parts(NamedTuple):
    """What the phases read at the measured positions: the potential,
    both lists and their per-cycle invariants, the 3-body rows there,
    the switch band, the skins and the 3-body list's radius and
    capacity, the Langevin constants and noise stream, and the engine's
    wrap and list build."""
    positions: torch.Tensor   # (N, 3), where the chains start
    potential: object
    nbr2: nb.NeighborList
    nbr3: nb.NeighborList
    cache2: nb.ListCache
    cache3: nb.ListCache
    d0: torch.Tensor          # (N, K3, 3) 3-body rows at ``positions``
    cell: torch.Tensor
    r_lo: float
    r_hi: float
    n_basis_short: int
    skin: float
    list_skin: float
    r_cut_3: float
    capacity_3b: int
    c1: float
    cn: torch.Tensor          # (N, 1)
    generator: torch.Generator
    wrap: Callable
    build_lists: Callable

    @classmethod
    def from_state(cls, system: MDSystem, state):
        """The parts of ``system`` at ``state``'s positions and lists."""
        dt = DT_FS * units.fs
        c1 = math.exp(-(FRICTION_PS / units.ps) * dt)
        cn = torch.sqrt((1 - c1 ** 2) * units.kB * TEMPERATURE
                        / system.masses[:, None])
        r_lo, r_hi = system.respa_switch
        cache2, cache3 = system.list_caches(state.nbr2, state.nbr3,
                                            state.cell)
        return cls(state.positions, system.potential, state.nbr2,
                   state.nbr3, cache2, cache3,
                   nb.cached_displacements(state.positions, state.nbr3,
                                           cache3),
                   state.cell, r_lo, r_hi, system.n_basis_short,
                   system.skin, system._list_skin,
                   system.r_cut_3b + system.skin, system.capacity_3b, c1, cn,
                   state.generator, system._wrap, system.build_lists)


def inner_force(p: Parts, x):
    """The inner step's force: the switched short pair force S(r) V(r)
    (N, 3) on a fresh gather of the 3-body rows."""
    pot = p.potential
    return pair_short_forces(
        pot.pair_coefficients, x, p.cell, p.nbr3, spec_pair=pot.pair_spec,
        n_basis_pair=p.n_basis_short, with_energy=False, r_lo=p.r_lo,
        r_hi=p.r_hi, cache3=p.cache3)[1]


def gather(p: Parts, x):
    """The 3-body rows' gather: displacements (N, K3, 3)."""
    return nb.cached_displacements(x, p.nbr3, p.cache3)


def inner_math(p: Parts, d):
    """The switched pair chain alone on the rows ``d``: forces (N, 3)."""
    pot = p.potential
    return pair_row_forces(pot.pair_coefficients, d, p.cache3.valid,
                           pot.pair_spec, p.n_basis_short, with_energy=False,
                           side="short", r_lo=p.r_lo, r_hi=p.r_hi)[1]


def trio_force(p: Parts, x, d, triangle: bool = False):
    """The 3-body force (N, 3) on the rows ``d``: the trio kernel (on
    the triangle lanes with ``triangle``) and the reverse-slot
    assembly."""
    return trio_forces(p.potential, x, p.cell, p.nbr3, with_energy=False,
                       cache3=p.cache3, d=d, triangle=triangle)[1]


def tail_force(p: Parts, x):
    """The outer step's force: (1 - S(r)) V(r) (N, 3) on the pair
    rows."""
    pot = p.potential
    return pair_tail_forces(
        pot.pair_coefficients, x, p.cell, p.nbr2, spec_pair=pot.pair_spec,
        n_basis_pair=pot.pair_spec.n_basis, with_energy=False, r_lo=p.r_lo,
        r_hi=p.r_hi, cache2=p.cache2)[1]


def stale_flag(p: Parts, x):
    """The engine's staleness flag at ``x`` (a device bool): either
    list's two largest drifts past its skin."""
    return (nb.needs_rebuild(p.nbr2, x, p.list_skin)
            | nb.needs_rebuild(p.nbr3, x, p.skin))


def refilter(p: Parts, x) -> nb.NeighborList:
    """The 3-body list filtered from the pair list at ``x``, as the
    engine's refilter branch."""
    return nb.filter_neighbor_list(p.nbr2, x, p.cell, p.r_cut_3,
                                   p.capacity_3b, reference_positions=x)


def full_build(p: Parts, x):
    """The engine's full branch: ``x`` wrapped into the cell, then both
    lists built there.  Returns (nbr2, nbr3)."""
    return p.build_lists(p.wrap(x, p.cell), p.cell)


def bodies(p: Parts) -> dict:
    """Each phase as a chainable body x -> x' on the positions (N, 3),
    carrying a data dependency without moving the atoms, in the
    reference's order."""
    eps = EPS

    def wiggle(x, f):
        return x + eps * f

    def rows(x):
        # the fixed rows, made to depend on the chain
        return p.d0 + eps * x[0, 0]

    def langevin(x):
        noise = torch.randn(x.shape, generator=p.generator, dtype=x.dtype,
                            device=x.device)
        return x * (1.0 + eps) + eps * (p.c1 * p.cn * noise)

    return {
        "inner_force_fresh_gather": lambda x: wiggle(x, inner_force(p, x)),
        "gather_only": lambda x: wiggle(x, torch.sum(gather(p, x), dim=1)),
        "inner_math_only": lambda x: wiggle(x, inner_math(p, rows(x))),
        "trio_map_comps_reuse": lambda x: wiggle(
            x, trio_force(p, x, rows(x))),
        "trio_map_triangle": lambda x: wiggle(
            x, trio_force(p, x, rows(x), triangle=True)),
        "tail_force": lambda x: wiggle(x, tail_force(p, x)),
        "stale_check_both": lambda x: x * (
            1.0 + eps * stale_flag(p, x).to(x.dtype)),
        "langevin": langevin,
        "rebuild_3b_filter": lambda x: wiggle(
            x, refilter(p, x).shift[:, :3, 0]),
        "rebuild_full_standalone": lambda x: wiggle(
            x, full_build(p, x)[0].shift[:, :3, 0]),
    }


def measure(p: Parts, scan_len: int = common.SCAN_LEN, phases=None,
            eager=EAGER):
    """(device ms, host ms) of every phase of ``bodies(p)`` (or of
    ``phases``, name -> chainable body, with ``eager`` naming those a
    graph cannot capture, as ``EAGER``), each chain starting at
    ``p.positions``; the device ms are None on the CPU."""
    x0 = p.positions
    on_card = x0.is_cuda
    device, host = {}, {}
    for name, fn in (bodies(p) if phases is None else phases).items():
        if name in eager:
            length = eager[name] or scan_len
            host[name] = common.host_chain_ms(fn, x0, length)
            device[name] = common.profiled_device_ms(
                lambda: fn(x0), length) if on_card else None
            continue
        generators = (p.generator,) if name == "langevin" else ()
        device[name] = common.graph_chain_ms(
            fn, x0, scan_len, generators) if on_card else None
        host[name] = common.host_chain_ms(fn, x0, scan_len)
    return device, host


def end_to_end(system: MDSystem, state, windows: int, window_cycles: int,
               warm: bool = True):
    """One warm window (with ``warm``), then ``windows`` timed windows of
    ``window_cycles`` rebuild cycles (Langevin at 300 K, launches of
    ``LAUNCH_CHUNKS`` cycles, ``sync=False``, the card synchronized
    before each clock read).  Returns (state, ms per step of each
    window, the cycles by rebuild branch in the timed windows)."""
    steps = window_cycles * system.rebuild_every
    kw = dict(n_steps=steps, dt_fs=DT_FS, thermostat="langevin",
              temperature=TEMPERATURE, launch_chunks=LAUNCH_CHUNKS,
              sync=False)
    if warm:
        state = system.run(state, **kw)
    common.sync(system.device)
    before = dict(system.rebuild_branches)
    ms = []
    for _ in range(windows):
        t0 = time.perf_counter()
        state = system.run(state, **kw)
        common.sync(system.device)
        ms.append(1e3 * (time.perf_counter() - t0) / steps)
    if system.overflowed(state):
        raise RuntimeError("neighbor overflow in the anatomy's windows")
    branches = {k: system.rebuild_branches[k] - before[k] for k in before}
    return state, ms, branches


def cycle_weights(cadence, branches: dict) -> dict:
    """Calls of each phase per rebuild cycle at ``cadence``: R inner
    forces, staleness checks and Langevin kicks, R / respa_mid trio
    forces, R / n_respa tail forces, and the refilters and full builds
    per cycle that ``branches`` counted."""
    n_respa, respa_mid, rebuild_every = cadence
    cycles = sum(branches.values())
    return {"inner_force_fresh_gather": rebuild_every,
            "trio_map_comps_reuse": rebuild_every / respa_mid,
            "tail_force": rebuild_every / n_respa,
            "stale_check_both": rebuild_every,
            "langevin": rebuild_every,
            "rebuild_3b_filter": branches["refilter"] / cycles,
            "rebuild_full_standalone": branches["full"] / cycles}


def cycle_model(ms: dict, weights: dict, rebuild_every: int):
    """ms per step of the weighted phases (None where a phase has no
    time)."""
    if any(ms[name] is None for name in weights):
        return None
    return sum(w * ms[name] for name, w in weights.items()) / rebuild_every


def run(cadence=CADENCE, reps=REPS, warm_steps: int = WARM_STEPS,
        windows: int = WINDOWS, window_cycles: int = WINDOW_CYCLES,
        scan_len: int = common.SCAN_LEN, device=None, model=common.MODEL,
        commit: str = None, keep: dict = None) -> dict:
    """The anatomy at ``cadence``: warm-up from 300 K velocities (seed
    0), the end-to-end windows, the phases and the cycle models.
    ``keep``, where given, receives the system, the last state and the
    parts the phases were timed on."""
    device = common.resolve_device(device)
    dtype = torch.float32 if device.type == "cuda" else torch.float64
    cadence = tuple(int(c) for c in cadence)
    geom = common.bcc_w(reps)
    system = MDSystem(model, geom, dtype=dtype, device=device,
                      **engine(cadence))
    state = system.init_state(temperature=TEMPERATURE, seed=0)
    state = system.run(state, n_steps=warm_steps, dt_fs=DT_FS,
                       thermostat="langevin", temperature=TEMPERATURE)
    state, windows_ms, branches = end_to_end(system, state, windows,
                                             window_cycles)
    parts = Parts.from_state(system, state)
    device_ms, host_ms = measure(parts, scan_len)
    floor = common.node_floor_ms(device) if device.type == "cuda" else None
    state, after_ms, _ = end_to_end(system, state, windows, window_cycles,
                                    warm=False)
    e2e = statistics.median(windows_ms)
    weights = cycle_weights(cadence, branches)
    rebuild_every = cadence[2]
    model_host = cycle_model(host_ms, weights, rebuild_every)
    model_device = cycle_model(device_ms, weights, rebuild_every)
    result = {
        "config": {"n_atoms": len(geom), "n_respa": cadence[0],
                   "respa_mid": cadence[1], "rebuild_every": rebuild_every,
                   "capacity_2b": system.capacity_2b,
                   "capacity_3b": system.capacity_3b,
                   "platform": common.platform(device),
                   "respa_switch": list(system.respa_switch),
                   "dtype": str(dtype).replace("torch.", "")},
        "scan_chained_ms": device_ms,
        "net_of_null_ms": {k: v for k, v in device_ms.items()
                           if k != "rebuild_full_standalone"},
        "node_floor_ms": floor,
        "host_ms": host_ms,
        "device_ms_from": {k: "profiler" if k in EAGER else "graph"
                           for k in device_ms},
        "e2e_ms_per_step": e2e,
        "e2e_ms_per_step_min": min(windows_ms),
        "e2e_ms_per_step_max": max(windows_ms),
        "e2e_windows_ms_per_step": windows_ms,
        "e2e_after_phases_ms_per_step": statistics.median(after_ms),
        "e2e_after_phases_windows_ms_per_step": after_ms,
        "window_steps": window_cycles * rebuild_every,
        "rebuild_branches": branches,
        "cycle_weights": weights,
        "cycle_model_ms_per_step": model_host,
        "unmodeled_ms_per_step": e2e - model_host,
        "cycle_model_device_ms_per_step": model_device,
        "unmodeled_device_ms_per_step":
            None if model_device is None else e2e - model_device,
        "scan_len": scan_len,
    }
    if keep is not None:
        keep.update(system=system, state=state, parts=parts)
    return common.stamp(result, device, commit)


def artifact_name(cadence) -> str:
    return "anatomy_3l_{}_{}_{}.json".format(*cadence)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    parser.add_argument("--cadence", type=int, nargs=3, default=CADENCE,
                        metavar=("N_RESPA", "RESPA_MID", "REBUILD_EVERY"),
                        help="default 9 3 27 (the reference's); 12 6 36 is "
                             "the bench path")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--reps", type=int, nargs=3, default=REPS,
                        help="bcc W supercell (default 17 17 17)")
    parser.add_argument("--out-dir", default=common.ARTIFACTS)
    parser.add_argument("--commit", default=None,
                        help="the artifact's commit (default: git's short "
                             "commit)")
    args = parser.parse_args(argv)
    result = run(tuple(args.cadence), tuple(args.reps), device=args.device,
                 commit=args.commit)
    print(json.dumps(result, indent=1))
    path = common.write_artifact(result, args.out_dir,
                                 artifact_name(args.cadence))
    print(f"wrote {path}")
    return result


if __name__ == "__main__":
    main()
