"""
Smoke run of uf3_tpu_torch on one NVIDIA GPU: builds the CUDA kernels
from the sources in this checkout (no register spills allowed), holds
each against its plain torch twin at the shapes of every MD path, then
drives the MD engine through the trio kernel on four paths at the bench
model's full width (2+3-body W, 9,826 atoms, float32, Langevin at
300 K, 2 fs): 3-level r-RESPA 12/6/36 (the benchmark configuration),
plain velocity Verlet with the engine's defaults (and an NVE energy
drift check), 2-level r-RESPA 12/36; then the small and non-periodic
cells against the CPU, and the ``md`` command as a user runs it.

    python3 chip_smoke.py

Exits non-zero, without a result line, when no CUDA device is present
or any phase fails.  The line before the last is a JSON object with the
kernels' launch counts, errors, times and bounds; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from uf3_tpu_torch.data.atoms import bulk  # noqa: E402
from uf3_tpu_torch.forcefield.md import MDSystem  # noqa: E402
from uf3_tpu_torch.ops import _build  # noqa: E402
from uf3_tpu_torch.ops import neighbors as nb  # noqa: E402
from uf3_tpu_torch.ops import trio  # noqa: E402
from uf3_tpu_torch.ops.pair import (pair_row_forces,  # noqa: E402
                                    pair_short_forces, pair_tail_forces)
from uf3_tpu_torch.ops.potential import (UF3Potential,  # noqa: E402
                                         grid_sparsity)
from uf3_tpu_torch.ops.splines import _leg_interval  # noqa: E402

MODEL = os.path.join(REPO, "benchmarks_data", "model_2and3.json")
BENCH = dict(rebuild_every=36, skin=0.5, skin_2b=1.2, capacity_2b=72,
             capacity_3b=16, n_respa=12, respa_mid=6,
             respa_switch=(2.5, 3.5))
F64_TOL = 1e-10   # same arithmetic, another summation order
FORCE_TOL = 2e-4  # eV/A, f32 vs f64 (tests/test_tpu_numerics.py)
WINDOW_STEPS = 720  # per timed window, as bench.py
T_TARGET, T_BAND = 300.0, 30.0
NVE_DRIFT = 2e-4  # eV/atom over 720 steps (the criterion in ROADMAP.md)
# NVIDIA H100 SXM peaks (data sheet): float32 outside the tensor cores,
# HBM3 bandwidth
PEAK_F32_FLOPS, PEAK_BYTES = 67e12, 3.35e12


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def environment(device):
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(device)}")
    print(f"card: {card_line()}")
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()
    print(f"nvcc: {nvcc[-1]}")
    try:
        import triton
        print(f"triton: {triton.__version__}")
    except ImportError:
        print("triton: not importable")


def build_kernels():
    info = _build.build(force=True)
    print(f"kernel build: {info['seconds']:.2f} s "
          f"({_build.LIBRARY} from {_build.CSRC})")
    spills = []
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
        if "spill" in line and " 0 bytes spill stores, 0 bytes spill loads" \
                not in line:
            spills.append(line.strip())
    if spills:
        raise AssertionError(f"ptxas reports register spills: {spills}")
    _build.library()


def bench_geometry(reps, rattle=None):
    geom = bulk("W", "bcc", a=3.1652) * reps
    if rattle is not None:
        geom.rattle(rattle, seed=11)
    return geom


def with_grid(pot: UF3Potential, grid: np.ndarray) -> UF3Potential:
    active_bc, window, symmetric = grid_sparsity(grid)
    bundle = pot.trio._replace(grid=grid, active_bc=active_bc,
                               window=window, symmetric=symmetric)
    return UF3Potential(pot.pair_spec, pot.pair_coefficients.cpu().numpy(),
                        bundle, pot.offsets_1b.cpu().numpy(),
                        pot.z_to_species.cpu().numpy(), pot.r_cut_2b,
                        pot.r_cut_3b)


def cuda_ms(fn, repeats):
    """Mean device time of fn() in ms over ``repeats`` calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / repeats


def graph_ms(fn, repeats=20, replays=10):
    """Mean device time of fn() in ms: ``repeats`` calls captured in one
    CUDA graph, replayed ``replays`` times between CUDA events, so that
    the host's per-call cost (Python, ctypes, allocation) does not hide
    a kernel shorter than it."""
    fn()
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()  # warm the capture stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(repeats):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (replays * repeats)


def max_err(a, b) -> float:
    return float(torch.max(torch.abs(a.double().cpu() - b.double().cpu())))


def trio_bound(pot: UF3Potential, d, valid, with_energy: bool):
    """The least time the card needs for one trio_partials call on
    these rows: the flop the kernel's algorithm does for this data (an
    FMA is 2) over the float32 peak, against each input read once and
    each output written once over the memory rate.  Returns (ms,
    "operations" or "bytes", flop, bytes)."""
    trio_b = pot.trio
    w_lo, w_hi, c_lo, c_hi = trio_b.window
    ww, cw = w_hi - w_lo, c_hi - c_lo
    d = d.double()
    ok = valid != 0                                      # (N, K)
    r = torch.sqrt(torch.sum(d * d, -1).clamp_min(1e-300))
    idx = _leg_interval(trio_b.spec_l, r)                # first tap
    taps = torch.arange(4, device=d.device)
    b_live = (((idx[..., None] + taps) >= w_lo)
              & ((idx[..., None] + taps) < w_hi)).sum(-1)  # (N, K)
    diff = d[:, None, :, :] - d[:, :, None, :]            # [a, m, n]
    r_mn2 = torch.sum(diff * diff, -1)
    r_mn = torch.sqrt(r_mn2.clamp_min(1e-300))
    eye = torch.eye(d.shape[1], dtype=torch.bool, device=d.device)
    lane = (ok[:, :, None] & ok[:, None, :] & ~eye & (r_mn2 > 1e-10)
            & (r_mn >= trio_b.spec_n.t_min) & (r_mn <= trio_b.spec_n.t_max))
    cidx = _leg_interval(trio_b.spec_n, r_mn)
    c_live = (((cidx[..., None] + taps) >= c_lo)
              & ((cidx[..., None] + taps) < c_hi)).sum(-1)  # (N, K, K)
    b_lane = b_live[:, None, :].expand_as(cidx)           # row n's taps
    term = 6 if with_energy else 4    # 2 or 3 FMAs per (b, c) term
    # per live lane: 55 for d[n] - d[m], |.|, the interval and 4 values
    # + 4 derivatives by Horner; 9 (+1) for the sums over n; then the
    # (b, c) terms and the b-level FMAs
    per_lane = (55 + 9 + int(with_energy)
                + term * b_lane * c_live + term * b_lane)
    n_rows = int(ok.sum())
    flop = (float(torch.sum(per_lane * lane))
            + n_rows * (52 + 4)                    # row bases, fc
            + 4.0 * ww * cw * float(torch.sum(b_live * ok)))  # H, H1
    size = pot.grid_window.element_size()
    n_atoms, k = d.shape[:2]
    n_bytes = size * (n_atoms * k * 4 + pot.grid_window.numel()
                      + pot.leg_tables.numel() + n_atoms * (4 + 5 * k))
    t_flop, t_bytes = flop / PEAK_F32_FLOPS, n_bytes / PEAK_BYTES
    return (1e3 * max(t_flop, t_bytes),
            "operations" if t_flop >= t_bytes else "bytes", flop, n_bytes)


def compare_trio(device):
    """Kernel vs twin on the engines' 3-body rows: the bench grid and a
    random non-symmetric one, with and without energy, on the bench
    lists (16 slots) of 1,024 (rattled) and 9,826 atoms and on the
    one-tier default list of 9,826 atoms (23 slots: the KMAX = 32
    instance the plain Verlet path runs).  Returns the records of the
    9,826-atom shapes by slot count."""
    base = UF3Potential.from_json(MODEL)
    rng = np.random.RandomState(17)
    random_grid = rng.normal(0.0, 0.05, base.trio.grid.shape) \
        * (base.trio.grid != 0.0)
    assert not np.array_equal(random_grid, random_grid.transpose(1, 0, 2))
    grids = {"bench": base, "random": with_grid(base, random_grid)}
    records = {}
    for reps, rattle, engine in (((8, 8, 8), 0.05, BENCH),
                                 ((17, 17, 17), None, BENCH),
                                 ((17, 17, 17), None, {})):
        geom = bench_geometry(reps, rattle)
        system = MDSystem(base, geom, dtype=torch.float64, device=device,
                          **engine)
        state = system.init_state(temperature=T_TARGET, seed=0)
        nbr = state.nbr3
        cache = nb.list_cache(nbr, system.cell, torch.float64)
        d64 = nb.cached_displacements(state.positions, nbr, cache)
        v64 = cache.valid
        k = d64.shape[1]
        for name, pot64 in grids.items():
            pot64 = pot64.to(device)
            pot32 = with_grid(pot64, pot64.trio.grid).to(
                device=device, dtype=torch.float32)
            d32, v32 = d64.float(), v64.float()
            for with_energy in (True, False):
                twin = trio.trio_partials_torch(
                    d64, v64, pot64.grid, pot64.trio, with_energy)
                f_twin = trio.assemble_forces(*twin, d64, cache.rev_flat,
                                              nbr.mask)[1]
                k64 = trio.trio_partials(pot64, d64, v64, with_energy)
                k32 = trio.trio_partials(pot32, d32, v32, with_energy)
                torch.cuda.synchronize()
                f64 = trio.assemble_forces(*k64, d64, cache.rev_flat,
                                           nbr.mask)[1]
                f32 = trio.assemble_forces(*k32, d32, cache.rev_flat,
                                           nbr.mask)[1]
                err64 = max(max_err(a, b) for a, b in zip(k64, twin))
                err64 = max(err64, max_err(f64, f_twin))
                err32 = max_err(f32, f_twin)
                kernel_ms = graph_ms(lambda: trio.trio_partials(
                    pot32, d32, v32, with_energy))
                twin_ms = cuda_ms(lambda: trio.trio_partials_torch(
                    d32, v32, pot32.grid, pot32.trio, with_energy), 5)
                print(f"trio {name:6s} N={len(geom):5d} K={k} "
                      f"energy={with_energy!s:5s} f64 max err "
                      f"{err64:.3e} (<= {F64_TOL:g}), f32 max |dF| "
                      f"{err32:.3e} eV/A (<= {FORCE_TOL:g}); f32 kernel "
                      f"{kernel_ms:.4f} ms (graph replay), twin "
                      f"{twin_ms:.4f} ms (eager)")
                if not (err64 <= F64_TOL and err32 <= FORCE_TOL):
                    raise AssertionError("trio kernel disagrees with its "
                                         "twin")
                if name == "bench" and len(geom) == 9826 \
                        and not with_energy:
                    bound_ms, bound_by, flop, n_bytes = trio_bound(
                        pot32, d32, v32, with_energy)
                    occ = trio.trio_occupancy(pot32, k, with_energy)
                    print(f"trio bound at N=9826, K={k}: {flop:.4g} flop, "
                          f"{n_bytes:.4g} bytes -> {bound_ms:.5f} ms "
                          f"({bound_by}); kernel reaches "
                          f"{100 * bound_ms / kernel_ms:.1f}% of it")
                    print(f"trio launch plan (f32, K={k}): {occ}")
                    records[f"K{k}"] = dict(
                        max_abs_err=err32, ms=kernel_ms, plain_ms=twin_ms,
                        bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=None, registers=occ["registers"],
                        warps_per_sm=occ["warps_per_sm"])
    for k in (16, 32):
        print(f"trio launch plan (f64, KMAX={k}): "
              f"{trio.trio_occupancy(grids['bench'], k)}")
    if sorted(records) != ["K16", "K23"]:
        raise AssertionError(f"unexpected 3-body slot counts {records}")
    return records


def host_ms(fn, repeats=30):
    """Mean host time of fn() in ms, each call ended by a synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
        torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / repeats


def layer_times(system: MDSystem, state):
    """Per-call host times of the step's layers at ``state``, amortised
    by their cadence in the bench configuration (12/6/36)."""
    pot, cell, x = system.potential, state.cell, state.positions
    cache2 = nb.list_cache(state.nbr2, cell, system.dtype)
    cache3 = nb.list_cache(state.nbr3, cell, system.dtype)
    r_lo, r_hi = system.respa_switch
    spec = pot.pair_spec
    d3 = nb.cached_displacements(x, state.nbr3, cache3)
    layers = {
        "pair short, (N, 16) rows": (1.0, lambda: pair_short_forces(
            pot.pair_coefficients, x, cell, state.nbr3, spec_pair=spec,
            n_basis_pair=system.n_basis_short, with_energy=False,
            r_lo=r_lo, r_hi=r_hi, cache3=cache3)),
        "staleness triggers (needs_rebuild x2)": (1.0, lambda: (
            nb.needs_rebuild(state.nbr2, x, system.skin_2b)
            | nb.needs_rebuild(state.nbr3, x, system.skin))),
        "trio: kernel only": (1 / 6, lambda: trio.trio_partials(
            pot, d3, cache3.valid, False)),
        "trio: gather + kernel + assembly": (1 / 6, lambda: trio.trio_forces(
            pot, x, cell, state.nbr3, with_energy=False, cache3=cache3)),
        "pair tail, (N, 72) rows": (1 / 12, lambda: pair_tail_forces(
            pot.pair_coefficients, x, cell, state.nbr2, spec_pair=spec,
            n_basis_pair=spec.n_basis, with_energy=False, r_lo=r_lo,
            r_hi=r_hi, cache2=cache2)),
        "3-body refilter": (1 / 36, lambda: nb.filter_neighbor_list(
            state.nbr2, x, cell, system.r_cut_3b + system.skin,
            system.capacity_3b, reference_positions=x)),
        "full rebuild (wrap, cell list, filter)": (0.0, lambda:
            system.build_lists(system._wrap(x, cell), cell)),
    }
    for name, (cadence, fn) in layers.items():
        ms = host_ms(fn)
        print(f"layer {name}: {ms:.4f} ms per call, {cadence * ms:.4f} ms "
              "per step")


def layer_times_plain(system: MDSystem, state):
    """Per-call host times of the plain Verlet step's layers, and the
    device time of its whole force evaluation by graph replay: a host
    time far above the device time says the step waits on the host."""
    pot, cell, x = system.potential, state.cell, state.positions
    cache2 = nb.list_cache(state.nbr2, cell, system.dtype)
    cache3 = nb.list_cache(state.nbr3, cell, system.dtype)
    k2, k3 = state.nbr2.idx.shape[1], state.nbr3.idx.shape[1]
    spec = pot.pair_spec
    d2 = nb.cached_displacements(x, state.nbr2, cache2)
    d3 = torch.gather(d2, 1, state.nbr3.sel[:, :, None].expand(-1, -1, 3))

    def force():
        return system.energy_forces(x, state.nbr2, state.nbr3, cell=cell,
                                    with_energy=False, cache2=cache2,
                                    cache3=cache3)

    layers = {
        f"pair gather, (N, {k2}) rows": lambda: nb.cached_displacements(
            x, state.nbr2, cache2),
        f"pair forces on the (N, {k2}) rows": lambda: pair_row_forces(
            pot.pair_coefficients, d2, cache2.valid, spec, spec.n_basis,
            False),
        f"trio on (N, {k3}) rows selected from them: select + kernel + "
        "assembly": lambda: trio.trio_forces(
            pot, x, cell, state.nbr3, False, cache3=cache3,
            d=torch.gather(d2, 1, state.nbr3.sel[:, :, None].expand(
                -1, -1, 3))),
        "trio: kernel only": lambda: trio.trio_partials(
            pot, d3, cache3.valid, False),
        "staleness trigger (needs_rebuild)": lambda: nb.needs_rebuild(
            state.nbr2, x, system.skin_2b),
        "full force (energy_forces, no energy)": force,
    }
    for name, fn in layers.items():
        print(f"layer plain {name}: {host_ms(fn):.4f} ms per call (host)")
    print("layer plain full force on the device (graph replay): "
          f"{graph_ms(force):.4f} ms per call")


def drive(system: MDSystem, state, steps, **run_kw):
    """Run ``steps`` steps and wait for the card; returns (state,
    seconds)."""
    t0 = time.perf_counter()
    state = system.run(state, n_steps=steps, **run_kw)
    torch.cuda.synchronize()
    return state, time.perf_counter() - t0


def run_path(name, device, engine, run_kw):
    """One MD path at 9,826 atoms in float32 under Langevin: set-up, a
    144-step warm-up and three timed windows, with the trio launches
    counted from 0 over them.  Returns (system, state, launches,
    atom-steps/s, temperatures, stale)."""
    geom = bench_geometry((17, 17, 17))
    trio.trio_partials.launches = 0
    t0 = time.perf_counter()
    system = MDSystem(MODEL, geom, dtype=torch.float32, device=device,
                      **engine)
    state = system.init_state(temperature=T_TARGET, seed=0)
    state, _ = drive(system, state, 144, **run_kw)
    print(f"{name}: set-up + 144-step warm-up "
          f"{time.perf_counter() - t0:.2f} s (capacities "
          f"{system.capacity_2b}/{system.capacity_3b})")
    times, temps = [], []
    stale = False
    for _ in range(3):
        state, seconds = drive(system, state, WINDOW_STEPS, **run_kw)
        times.append(seconds)
        temps.append(system.temperature(state))
        stale = stale or bool(state.stale)
    launches = trio.trio_partials.launches
    rate = len(geom) * WINDOW_STEPS / sorted(times)[1]
    print(f"{name}: windows (s) {[round(t, 4) for t in times]}, "
          f"T (K) {[round(t, 2) for t in temps]}")
    return system, state, launches, rate, temps, stale


def check_path(name, system: MDSystem, state, launches, temps,
               split: bool):
    """The gates of one MD path on its final state: no overflow, finite
    state, trio launches, mean T, forces (carried split forces against a
    fresh evaluation for r-RESPA) and energy against float64."""
    energy, forces = system.energy_forces(state.positions, state.nbr2,
                                          state.nbr3, cell=state.cell)
    engine = dict(skin=system.skin, skin_2b=system.skin_2b,
                  capacity_2b=system.capacity_2b,
                  capacity_3b=system.capacity_3b,
                  rebuild_every=system.rebuild_every)
    system64 = MDSystem(MODEL, bench_geometry((17, 17, 17)),
                        dtype=torch.float64, device=system.device, **engine)
    e64, f64 = system64.energy_forces(state.positions.double(),
                                      state.nbr2, state.nbr3,
                                      cell=state.cell.double())
    split_err = max_err(state.forces, forces)
    f64_err = max_err(forces, f64)
    print(f"{name}: final E = {float(state.energy):.6f} eV, fresh "
          f"{float(energy):.6f} (f64 {float(e64):.6f}); max |F_state - "
          f"F_fresh| {split_err:.3e}, max |F_f32 - F_f64| {f64_err:.3e} "
          "eV/A")
    checks = {
        "no overflow": not system.overflowed(state),
        "finite energy and forces": bool(
            torch.isfinite(state.energy)
            and torch.isfinite(state.forces).all()
            and torch.isfinite(state.positions).all()),
        "trio kernel launched on this path": launches > 0,
        f"mean T within {T_TARGET:g} +- {T_BAND:g} K":
            abs(np.mean(temps) - T_TARGET) <= T_BAND,
        "f32 forces match f64": f64_err <= FORCE_TOL,
        "energy matches f64": abs(float(energy) - float(e64))
            <= 1e-6 * abs(float(e64)),
    }
    if split:
        checks["split forces match a fresh evaluation"] = \
            split_err <= FORCE_TOL
    for check, ok in checks.items():
        print(f"check {name} {check}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise AssertionError(f"{name} checks failed")


def run_nve(system: MDSystem, state):
    """720 NVE steps of 2 fs from ``state``; returns (launches, drift in
    eV/atom, atom-steps/s)."""
    n_atoms = state.positions.shape[0]
    e0 = float(state.energy) + system.kinetic_energy(state)
    trio.trio_partials.launches = 0
    state, seconds = drive(system, state, WINDOW_STEPS, dt_fs=2.0)
    launches = trio.trio_partials.launches
    e1 = float(state.energy) + system.kinetic_energy(state)
    drift = abs(e1 - e0) / n_atoms
    ok = drift <= NVE_DRIFT and not system.overflowed(state) \
        and launches > 0
    print(f"plain Verlet NVE: E_total {e0:.6f} -> {e1:.6f} eV over "
          f"{WINDOW_STEPS} steps, drift {drift:.3e} eV/atom "
          f"(<= {NVE_DRIFT:g}): {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError("plain Verlet NVE check failed")
    return launches, drift, n_atoms * WINDOW_STEPS / seconds


def list_keys(nbr) -> np.ndarray:
    """Per-row sorted keys of a list's (atom, image shift) set."""
    idx, shift, mask = (nbr.idx.cpu().numpy(), nbr.shift.cpu().numpy(),
                        nbr.mask.cpu().numpy())
    code = ((shift + 2) @ np.array([25, 5, 1])).astype(np.int64)
    return np.sort(np.where(mask, idx * 125 + code, -1), axis=1)


def compare_small_cells(device):
    """The engine on the card against its own CPU run, float64, from
    the same inputs: 54 atoms (periodic, the images builder), 128 atoms
    (the minimum-image builder), a 250-atom cluster (no pbc): entry
    energy, forces and neighbor sets, then 12 plain Verlet steps."""
    cells = {
        "54 atoms, periodic (images)": (3, True, {}),
        "128 atoms, periodic (minimum image)": (4, True, {}),
        "250 atoms, cluster (no pbc)": (5, False, dict(capacity_2b=64,
                                                       capacity_3b=20)),
    }
    for name, (reps, pbc, engine) in cells.items():
        geom = bench_geometry((reps,) * 3, rattle=0.05)
        geom.pbc = np.array([pbc] * 3)
        v0 = np.random.RandomState(reps).normal(0.0, 4e-3, (len(geom), 3))
        states = []
        for dev in ("cpu", device):
            system = MDSystem(MODEL, geom, dtype=torch.float64, device=dev,
                              **engine)
            entry = system.init_state(velocities=v0)
            states.append((entry, system.run(entry, n_steps=12, dt_fs=2.0)))
        (c0, c12), (g0, g12) = states
        errs = [max(max_err(a.energy, b.energy), max_err(a.forces, b.forces))
                for a, b in ((c0, g0), (c12, g12))]
        errs.append(max_err(c12.positions, g12.positions))
        same = all(np.array_equal(list_keys(a), list_keys(b))
                   for a, b in ((c0.nbr2, g0.nbr2), (c0.nbr3, g0.nbr3)))
        ok = max(errs) <= F64_TOL and same
        print(f"small cells {name}: card vs CPU f64 entry |dE|,|dF| "
              f"{errs[0]:.3e}, after 12 steps {errs[1]:.3e} (positions "
              f"{errs[2]:.3e}), neighbor sets equal {same} "
              f"(K2={c0.nbr2.idx.shape[1]}, K3={c0.nbr3.idx.shape[1]}): "
              f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"small cells {name}: card and CPU differ")


def run_md_command():
    """``python -m uf3_tpu_torch md`` at its defaults, as a user runs
    it: exit 0 and a finite T and E on its result line."""
    cmd = [sys.executable, "-m", "uf3_tpu_torch", "md",
           os.path.join("benchmarks_data", "model_2and3.json")]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    seconds = time.perf_counter() - t0
    lines = out.stdout.strip().splitlines()
    for line in lines:
        print(f"md command: {line}")
    found = re.search(r"\(([-+.\deE]+) atom-steps/s\); T = (\S+) K, "
                      r"E = (\S+) eV", lines[-1] if lines else "")
    ok = out.returncode == 0 and found is not None \
        and all(np.isfinite(float(x)) for x in found.groups())
    print(f"md command: exit {out.returncode} after {seconds:.2f} s: "
          f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"md command failed:\n{out.stderr[-4000:]}")
    return float(found.group(1))


def main():
    if not torch.cuda.is_available():
        print("no CUDA device: uf3_tpu_torch's kernels need an NVIDIA GPU",
              file=sys.stderr)
        sys.exit(1)
    device = torch.device("cuda", 0)
    environment(device)
    build_kernels()
    records = compare_trio(device)
    langevin = dict(dt_fs=2.0, thermostat="langevin", temperature=T_TARGET)
    rates, launches = {}, {}
    # the benchmark configuration: 3-level r-RESPA 12/6/36
    system, state, launches["respa3"], rates["3-level r-RESPA 12/6/36"], \
        temps, stale3 = run_path("3-level r-RESPA", device, BENCH,
                                 dict(langevin, launch_chunks=10))
    layer_times(system, state)
    check_path("3-level r-RESPA", system, state, launches["respa3"], temps,
               split=True)
    # plain velocity Verlet with the engine's default arguments
    system, state, launches["plain"], rates["plain Verlet (defaults)"], \
        temps, stale1 = run_path("plain Verlet", device, {}, langevin)
    layer_times_plain(system, state)
    check_path("plain Verlet", system, state, launches["plain"], temps,
               split=False)
    nve_launches, _, rates["plain Verlet NVE"] = run_nve(system, state)
    launches["plain"] += nve_launches
    # 2-level r-RESPA: the bench configuration without a mid level
    system, state, launches["respa2"], rates["2-level r-RESPA 12/36"], \
        temps, stale2 = run_path("2-level r-RESPA", device,
                                 dict(BENCH, respa_mid=1),
                                 dict(langevin, launch_chunks=10))
    check_path("2-level r-RESPA", system, state, launches["respa2"],
               temps, split=True)
    compare_small_cells(device)
    rates["md command (2,000 atoms, plain Verlet)"] = run_md_command()
    card = card_line()
    for (name, rate), stale in zip(rates.items(),
                                   (stale3, stale1, stale1, stale2, None)):
        print(f"MD {name}: {rate:.1f} atom-steps/s"
              + (f" (median of 3 x {WINDOW_STEPS} steps, 9826 atoms, "
                 f"float32), stale={stale}" if "command" not in name
                 and "NVE" not in name else "")
              + f", card: {card}")
    print(f"trio launches by path: {launches}")
    record = dict(records["K16"], max_abs_err=max(
        r["max_abs_err"] for r in records.values()))
    print(json.dumps({"kernels": [dict(
        name="trio_partials", route="cuda",
        source="uf3_tpu_torch/csrc/trio.cu",
        replaces="uf3_tpu/ops/pallas_trio.py:1044",
        launches=sum(launches.values()), launches_by_path=launches,
        **record, by_shape=records)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
