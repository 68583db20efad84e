"""
One run of one cell: the configuration and the traffic read by name,
the system built on the device, the cell's own launches warmed up, the
timed window, on ``--trace 1`` a profiled stretch after it, then the
check that decides ``correct`` and the result's line.

A cell's file (``workloads/<name>.json``) holds its traffic: the
lattice, the engine's settings, the entry point and its dynamics, the
launch size, the warm-up, and the limits of the numbers that decide
``correct``.  A configuration's file (``configs/<name>.json``) is the
model as it is run, with its source; ``reference`` names the module of
this folder that evaluates it plainly.  A per-layer metric is
``metrics/<name>.py``, whose ``read(ctx)`` returns a number or None.

The program under test is ``uf3_tpu_torch``: ``MDSystem``, its
``run`` / ``npt_run``, its counter ``rebuild_branches`` and the names
of its kernels in the profiler's trace.  Everything else here (the
lattice, the velocities, the reference, the arithmetic of the metrics)
is the benchmark's own.
"""

import gc
import importlib
import json
import os
import time
from typing import Dict

import numpy as np
import torch

from mdbench import yardstick

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
KB_EV = 8.617333262e-5   # Boltzmann constant, eV / K
STRUCTURES = {"bcc": [(0.0, 0.0, 0.0), (0.5, 0.5, 0.5)],
              "fcc": [(0.0, 0.0, 0.0), (0.0, 0.5, 0.5), (0.5, 0.0, 0.5),
                      (0.5, 0.5, 0.0)]}


def _json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT, "BENCHMARK.json")


def workload(name: str) -> dict:
    return _json(HERE, "workloads", f"{name}.json")


def config_path(name: str) -> str:
    return os.path.join(HERE, "configs", f"{name}.json")


def per_layer_names(bench: dict, cell: str):
    """The per-layer metrics that ``cell`` reports, in the file's
    order."""
    return [m["name"] for m in bench["per_layer"]
            if cell in m.get("workloads", [w["name"] for w in
                                           bench["workloads"]])]


def end_to_end_names(bench: dict, cell: str):
    return [m["name"] for m in bench["end_to_end"]
            if cell in m.get("workloads", [w["name"] for w in
                                           bench["workloads"]])]


def reader(name: str):
    return importlib.import_module(f"mdbench.metrics.{name}").read


# -- traffic ----------------------------------------------------------------
def lattice(spec: dict, reps=None):
    """(numbers, positions (N, 3) A, cell (3, 3) A) of the cubic crystal
    ``spec`` repeated ``reps`` times."""
    reps = tuple(spec["reps"] if reps is None else reps)
    a = float(spec["a"])
    basis = np.asarray(STRUCTURES[spec["structure"]])
    grid = np.stack(np.meshgrid(*[np.arange(r) for r in reps],
                                indexing="ij"), -1).reshape(-1, 1, 3)
    positions = ((grid + basis[None]) * a).reshape(-1, 3)
    cell = np.diag(np.asarray(reps, dtype=np.float64) * a)
    numbers = np.full(len(positions), int(spec["Z"]), dtype=np.int64)
    return numbers, positions, cell


def velocities(n: int, mass_amu: float, temperature: float, seed: int,
               device, dtype):
    """Maxwell-Boltzmann velocities at ``temperature`` (A per unit of
    sqrt(amu A^2 / eV)), zero total momentum, drawn on the device from
    ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    sigma = (KB_EV * temperature / mass_amu) ** 0.5
    v = sigma * torch.randn((n, 3), generator=gen, device=device,
                            dtype=dtype)
    return v - torch.mean(v, dim=0)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Run:
    """What one run of a cell measured and left for the check."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def drive(cell: str, seed: int, seconds: float, trace: bool,
          device="cuda", t_start: float = None, reps=None,
          warmup_launches: int = None, program_hook=None) -> Run:
    """Build the cell's system, warm up, run the timed window (and the
    profiled stretch), and gather the outputs.  ``reps`` and
    ``warmup_launches`` shrink a run for the CPU tests;
    ``program_hook(system)`` lets a test break the program."""
    from uf3_tpu_torch.data.atoms import Atoms
    from uf3_tpu_torch.forcefield.md import MDSystem
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    w = workload(cell)
    dtype = getattr(torch, w["dtype"])
    lat = w["lattice"]
    numbers, positions, box = lattice(lat, reps)
    n = len(numbers)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    engine = dict(w["engine"])
    if "respa_switch" in engine:
        engine["respa_switch"] = tuple(engine["respa_switch"])
    system = MDSystem(config_path(w["config"]),
                      Atoms(numbers, positions, box, pbc=True),
                      dtype=dtype, device=device, **engine)
    if program_hook is not None:
        program_hook(system)
    dyn = w["dynamics"]
    v0 = velocities(n, float(lat["mass_amu"]), dyn["temperature_K"], seed,
                    device, dtype)
    state = system.init_state(velocities=v0, seed=seed)
    launch_steps = int(w["launch_chunks"]) * system.rebuild_every
    kw = dict(n_steps=launch_steps, dt_fs=dyn["dt_fs"],
              thermostat=dyn["thermostat"],
              temperature=dyn["temperature_K"],
              friction_ps=dyn["friction_ps"],
              launch_chunks=int(w["launch_chunks"]))
    if w["entry"] != "run":
        raise ValueError(f"entry {w['entry']!r}")
    warm = int(w["warmup_launches"]) if warmup_launches is None \
        else warmup_launches
    for _ in range(warm):
        state = system.run(state, **kw)
    if system.overflowed(state):
        raise RuntimeError("neighbour overflow in the warm-up")
    sync(device)
    branches0 = dict(system.rebuild_branches)
    start_positions = state.positions.clone()
    setup_s = time.perf_counter() - t_start
    # the timed window: launches until the clock passes `seconds`, the
    # device synchronised at its two ends only
    steps = 0
    t0 = time.perf_counter()
    while True:
        state = system.run(state, sync=False, **kw)
        steps += launch_steps
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    window_s = time.perf_counter() - t0
    events = stretch = None
    trace_steps = 0
    if trace:
        from torch.profiler import ProfilerActivity, profile, \
            record_function
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with profile(activities=activities) as prof:
            with record_function(yardstick.WINDOW):
                sync(device)
                for _ in range(int(w["trace_launches"])):
                    state = system.run(state, sync=False, **kw)
                    trace_steps += launch_steps
                sync(device)
        events = yardstick.events_of(prof)
        stretch = yardstick.window_of(events)
        del prof
    if system.overflowed(state):
        raise RuntimeError("neighbour overflow in the window")
    step_forces = steps_path_forces(system, state)
    branches = {k: system.rebuild_branches[k] - branches0[k]
                for k in branches0}
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    out = Run(
        cell=cell, workload=w, device=device, n_atoms=n, seed=seed,
        setup_s=setup_s, window_s=window_s, window_steps=steps,
        trace_steps=trace_steps, events=events, stretch=stretch,
        branches=branches, memory_peak_bytes=int(peak),
        positions=state.positions.detach().clone(),
        start_positions=start_positions,
        forces=state.forces.detach().clone(),
        step_forces=step_forces.detach().clone(),
        temperature=float(dyn["temperature_K"]),
        energy=float(state.energy),
        cell_matrix=state.cell.detach().clone(),
        lists={name: (lst.idx.clone(), lst.shift.clone(), lst.mask.clone())
               for name, lst in (("2b", state.nbr2), ("3b", state.nbr3))
               if lst is not None},
        r_cut={"2b": system.r_cut_2b, "3b": system.r_cut_3b})
    del system, state, v0, step_forces
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def steps_path_forces(system, state) -> torch.Tensor:
    """The forces at ``state``'s positions, on the window's own lists,
    from the path that the window's steps run: the instances without
    the energy (the launch's last step alone computes it, and that is
    where ``state.forces`` comes from).  r-RESPA: its split forces
    summed; plain Verlet: the step's ``energy_forces`` on the lists'
    caches."""
    with torch.no_grad():
        if system.n_respa > 1:
            split = system._respa_split_forces_3l(state) \
                if system.respa_mid > 1 \
                else system._respa_split_forces(state)
            return sum(split)
        cache2, cache3 = system.list_caches(state.nbr2, state.nbr3,
                                            state.cell)
        return system.energy_forces(
            state.positions, state.nbr2, state.nbr3, cell=state.cell,
            with_energy=False, cache2=cache2, cache3=cache3)[1]


# -- the check that decides `correct` -----------------------------------------
def _pair_keys(i, j, s, n, base):
    half = base // 2
    return ((i * n + j) * base + (s[..., 0] + half)) * base * base \
        + (s[..., 1] + half) * base + (s[..., 2] + half)


def missing_pairs(run: Run, pairs, r_pairs) -> int:
    """Reference pairs inside each list's cutoff at the final positions
    that the program's list lacks (a valid slot with the same neighbour
    and image)."""
    i, j, s = pairs
    n = run.n_atoms
    missing = 0
    for name, (idx, shift, mask) in run.lists.items():
        cut = run.r_cut[name]
        near = r_pairs < cut
        ri, rj, rs = i[near], j[near], s[near]
        rows = torch.arange(n, device=idx.device)[:, None].expand_as(idx)
        ps = torch.round(shift).to(torch.int64)
        pi, pj, ps = rows[mask], idx[mask], ps[mask]
        base = 2 * int(max(int(rs.abs().max()) if len(rs) else 0,
                           int(ps.abs().max()) if len(ps) else 0)) + 1
        have = _pair_keys(pi, pj, ps, n, base)
        want = _pair_keys(ri, rj, rs.to(idx.device), n, base)
        missing += int((~torch.isin(want, have)).sum())
    return missing


def lattice_energy_per_atom(ref_mod, model, spec: dict, device) -> float:
    """The reference's energy per atom of the cell's perfect crystal,
    from a 4 x 4 x 4 repetition (every image within the cutoffs is
    searched, so the size does not change it)."""
    _, x, box = lattice(spec, (4, 4, 4))
    x = torch.as_tensor(x, dtype=torch.float64, device=device)
    box = torch.as_tensor(box, dtype=torch.float64, device=device)
    return ref_mod.energy_forces(model, x, box)[0] / len(x)


def check(run: Run, forces=None, energy=None):
    """The numbers that decide ``correct``, each against its limit, and
    the reference's neighbour counts (for the useful flop).  The
    reference evaluates the model at the program's final positions in
    float64.  Compared: the forces and energy of the launch's last
    step, the forces of the steps' own path (``steps_path_forces``),
    the lists, the atoms that moved, and the temperature that the
    potential energy above the perfect crystal gives, 2 (E/N - e0) /
    3 kB, against the thermostat's (equipartition in a harmonic
    crystal), which holds the integrator.  ``forces`` / ``energy``
    stand in for the program's forces of both paths and its energy
    (the control puts the reference's lower precision there)."""
    ref_mod = importlib.import_module(
        "mdbench." + _json(config_path(run.workload["config"]))
        .get("reference", "reference"))
    model = ref_mod.load(config_path(run.workload["config"]))
    x = run.positions
    pairs = ref_mod.neighbor_pairs(x, run.cell_matrix, model.r2)
    e_ref, f_ref, _ = ref_mod.energy_forces(
        model, x, run.cell_matrix, pairs=pairs)
    box = torch.diagonal(run.cell_matrix.double())
    i, j, s = pairs
    r_pairs = torch.linalg.norm(x.double()[j] - x.double()[i]
                                + s.double() * box, dim=-1)
    n = run.n_atoms
    n2 = torch.bincount(i, minlength=n)
    n3 = torch.bincount(i[r_pairs < model.r3], minlength=n) \
        if model.g3 is not None else torch.zeros_like(n2)
    step_forces = run.step_forces
    if forces is not None:
        step_forces = forces
    else:
        forces, energy = run.forces, run.energy
    e0 = lattice_energy_per_atom(ref_mod, model, run.workload["lattice"],
                                 x.device)
    t_pe = 2.0 * (e_ref / n - e0) / (3.0 * KB_EV)
    numbers = {
        "force_max_err_eV_A": float(torch.max(torch.abs(
            forces.double() - f_ref))),
        "step_force_max_err_eV_A": float(torch.max(torch.abs(
            step_forces.double() - f_ref))),
        "energy_err_eV_atom": abs(energy - e_ref) / n,
        "missing_pairs": float(missing_pairs(run, pairs, r_pairs)),
        "frozen_atoms": float(torch.mean(torch.all(
            run.positions == run.start_positions, dim=1).double())),
        "pe_temperature_gap": abs(t_pe - run.temperature)
        / run.temperature,
    }
    return numbers, dict(n2=n2, n3=n3, e_ref=e_ref, f_ref=f_ref)


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """[(name, number, limit, passed)]: a number passes where it is
    finite and no greater than its limit; a number with no limit
    fails."""
    out = []
    for name, value in numbers.items():
        limit = limits.get(name)
        ok = limit is not None and bool(np.isfinite(value)) \
            and value <= limit
        out.append((name, value, limit, ok))
    return out


# -- the result's line ----------------------------------------------------
class Context:
    """What a per-layer metric's reader may read."""

    def __init__(self, run: Run, useful_flop: float, model_file: dict):
        self.run = run
        self.events = run.events
        self.stretch = run.stretch
        self.on_device = run.device.type == "cuda"
        self.useful_flop = useful_flop
        self.model_file = model_file
        self.ms_per_step = 1e3 * run.window_s / run.window_steps
        self.steps = run.window_steps + run.trace_steps


def result(run: Run, trace: bool, numbers_judged, useful_flop: float,
           bench: dict) -> dict:
    cell = run.cell
    dev = run.device
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
              "kind": kind, "count": 1,
              "memory_peak_bytes": run.memory_peak_bytes}
    metrics = {}
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]
             + bench["per_layer"]}
    out = {}
    if not trace:
        values = {"atom_steps_per_s": run.n_atoms * run.window_steps
                  / run.window_s, "setup_s": run.setup_s}
        for name in end_to_end_names(bench, cell):
            metrics[name] = {"value": values[name], "unit": units[name]}
    else:
        model_file = _json(config_path(run.workload["config"]))
        ctx = Context(run, useful_flop, model_file)
        for name in per_layer_names(bench, cell):
            value = reader(name)(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
        if run.events is not None and run.stretch is not None:
            lo, hi = run.stretch
            device["busy_s"] = yardstick.busy_us(run.events, lo, hi) / 1e6
            device["window_s"] = (hi - lo) / 1e6
            out["breakdown"] = {
                "device_ops": yardstick.top_ops(run.events, 10),
                "idle_gaps": yardstick.idle_gaps(run.events, lo, hi, 10)}
    failed = sum(1 for *_, ok in numbers_judged if not ok)
    line = {"correct": failed == 0, "attempted": len(numbers_judged),
            "failed": failed, "metrics": metrics, "device": device}
    line.update(out)
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit, _ in numbers_judged}
    return line


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float = None, **kw):
    """One whole run: (the result's line, the judged numbers)."""
    bench = benchmark()
    run = drive(cell, seed, seconds, trace, device, t_start, **kw)
    numbers, counts = check(run)
    judged = judge(numbers, run.workload["limits"])
    useful = yardstick.useful_flops(counts["n3"], counts["n2"])
    line = result(run, trace, judged, useful, bench)
    return line, judged
