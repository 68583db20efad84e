"""
What the measurement scripts share: the device (the card unless asked
for the CPU, as ``MDSystem``), the chain length, CUDA-graph and eager
timing of a chained body, the device busy time of a call that a graph
cannot capture (from the profiler) and the host syncs it holds (by
site), the card's description, the commit, the artifact directory and
its stamp, the engine settings, models and 3-body rows that the trio
kernels are timed on, and the validation scripts' cell and total
energy.

Device times come from CUDA graphs: ``SCAN_LEN`` bodies chained (each
takes the previous one's output, as the JAX scripts' ``lax.scan``
chains them) are captured in one graph and replayed between CUDA
events, so that no host cost enters them.  ``graph_cold_ms`` gives each
call its own copy of the operands, so that they come from device memory
and not from the L2 cache.  Host times run the same
chain eagerly, ended by a synchronize.  A time is never divided by a
chain length it was not measured over.
"""

import inspect
import itertools
import json
import os
import subprocess
import time
import warnings

import numpy as np
import torch

from uf3_tpu_torch.forcefield import md
from uf3_tpu_torch.forcefield.md import _resolve_device as resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ARTIFACTS = os.path.join(REPO, "benchmarks_data", "artifacts_torch")
MODEL = os.path.join(REPO, "benchmarks_data", "model_2and3.json")
# the bench engine (bench.py) and the melting protocol's cell and engine
# settings (benchmarks/melting_run.py:101-106, 259)
BENCH = dict(rebuild_every=36, skin=0.5, skin_2b=1.2, capacity_2b=72,
             capacity_3b=16, n_respa=12, respa_mid=6,
             respa_switch=(2.5, 3.5))
PROTOCOL = dict(rebuild_every=16, skin=0.6, skin_2b=1.2, capacity_2b=88,
                capacity_3b=20)
PROTOCOL_REPS = (48, 18, 18)
# the validation scripts' cell: bcc W 17^3 = 9,826 atoms
LATTICE_A = 3.1652
VALIDATION_REPS = (17, 17, 17)
# the keys ``stamp`` adds to an artifact
CARD_FIELDS = ("device", "card", "torch", "commit")
SCAN_LEN = 30
L2_BYTES = 50 * 2 ** 20   # the H100's L2 cache (data sheet)


def long_trio_model():
    """Unary W whose 3-body cutoff (4 A) passes its 2-body cutoff (3 A),
    so that the engine builds its 3-body list on its own: pair r 1.5-3.0
    A in 8 intervals, trio legs up to (4, 4, 8) A in (6, 6, 12),
    coefficients from RandomState(0) at scale 0.05."""
    from uf3_tpu_torch import io
    from uf3_tpu_torch.data.composition import ChemicalSystem
    from uf3_tpu_torch.representation.basis import BSplineBasis
    basis = BSplineBasis(
        ChemicalSystem(["W"], degree=3), r_min_map={("W", "W"): 1.5},
        r_max_map={("W", "W"): 3.0, ("W", "W", "W"): [4.0, 4.0, 8.0]},
        resolution_map={("W", "W"): 8, ("W", "W", "W"): [6, 6, 12]})
    return io.FittedModel(basis, np.random.RandomState(0).normal(
        scale=0.05, size=sum(basis.partition_sizes)))


def trio_rows(device) -> dict:
    """The engines' float64 3-body rows at bcc W (a = 3.1652 A, 300 K
    velocities from seed 0): the bench list (K = 16) and the one-tier
    default list (K = 23) at 17^3 = 9,826 atoms, the melting protocol's
    list (K = 20) at 31,104 atoms, and the separately built list (K =
    32) of ``long_trio_model`` at 9,826 atoms rattled by 0.05 A (seed
    11).  name -> (potential, d, valid, rev_flat, mask)."""
    from uf3_tpu_torch.data.atoms import bulk
    from uf3_tpu_torch.forcefield.md import MDSystem
    from uf3_tpu_torch.ops import neighbors as nb
    out = {}
    for name, reps, rattle, engine, model in (
            ("K16", (17, 17, 17), None, BENCH, MODEL),
            ("K23", (17, 17, 17), None, {}, MODEL),
            ("K20", PROTOCOL_REPS, None, PROTOCOL, MODEL),
            ("K32", (17, 17, 17), 0.05, dict(skin=0.5, capacity_3b=32),
             long_trio_model())):
        geom = bulk("W", "bcc", a=3.1652) * reps
        if rattle is not None:
            geom.rattle(rattle, seed=11)
        system = MDSystem(model, geom, dtype=torch.float64, device=device,
                          **engine)
        state = system.init_state(temperature=300.0, seed=0)
        cache = nb.list_cache(state.nbr3, system.cell, torch.float64)
        d = nb.cached_displacements(state.positions, state.nbr3, cache)
        out[name] = (system.potential, d, cache.valid, cache.rev_flat,
                     state.nbr3.mask)
    return out


def species23_model(elements=("Ne", "Xe")):
    """A random 2+3-body model over ``elements``: the port's BSplineBasis, r
    1.0-5.0 A, resolution 8, coefficients from RandomState(11) at scale
    0.05 (for Ne/Xe the model of the JAX engine's
    test_multi_fused_matches_factorized), with each pair's last three
    coefficients at zero, as a fit with the basis's trailing trim holds
    them: random ones make the pair term jump at 5 A."""
    from uf3_tpu_torch import io
    from uf3_tpu_torch.data.composition import ChemicalSystem
    from uf3_tpu_torch.representation.basis import BSplineBasis
    basis = BSplineBasis(ChemicalSystem(list(elements), degree=3),
                         r_min_map=1.0, r_max_map=5.0, resolution_map=8)
    coefficients = np.random.RandomState(11).normal(
        scale=0.05, size=sum(basis.partition_sizes))
    sizes, offsets = basis.get_interaction_partitions()
    for pair in basis.interactions_map[2]:
        end = offsets[pair] + sizes[pair]
        coefficients[end - 3:end] = 0.0
    return io.FittedModel(basis, coefficients)


def ne_xe(reps, seed=3, a=5.4):
    """fcc at ``a`` with half the sites Xe by a seeded draw (the JAX
    engine's test_binary_md_runs)."""
    from uf3_tpu_torch.data.atoms import Atoms, bulk
    base = bulk("Ne", "fcc", a=a) * reps
    numbers = base.get_atomic_numbers()
    numbers[np.random.RandomState(seed).rand(len(numbers)) > 0.5] = 54
    return Atoms(numbers, base.get_positions(), base.get_cell(), pbc=True)


def ne_ar_xe(reps=(10, 10, 10)):
    """The ternary cut: fcc at a = 5.4 A, species Ne/Ar/Xe by a seeded
    draw, rattled by 0.08 A (10^3 x 4 = 4,000 atoms by default)."""
    from uf3_tpu_torch.data.atoms import Atoms, bulk
    base = bulk("Ne", "fcc", a=5.4) * reps
    numbers = np.array([10, 18, 54])[np.random.RandomState(7).randint(
        3, size=len(base))]
    geom = Atoms(numbers, base.get_positions(), base.get_cell(), pbc=True)
    geom.rattle(0.08, seed=1)
    return geom


def calculator_rows(calc, geom):
    """The multi-species 3-body rows that ``calc`` (a ``UFCalculator``)
    evaluates ``geom`` on: a full list build at its positions and cell.
    Returns (d, valid, s_slot, species, rev_flat, mask)."""
    from uf3_tpu_torch.ops import neighbors as nb
    system = calc.system
    cell = torch.as_tensor(geom.get_cell(), dtype=torch.float64,
                           device=calc.device)
    x = system._wrap(torch.as_tensor(geom.get_positions(),
                                     dtype=torch.float64,
                                     device=calc.device), cell)
    nbr2, nbr3 = system.build_lists(x, cell)
    _, cache = system.list_caches(nbr2, nbr3, cell)
    d = nb.cached_displacements(x, nbr3, cache)
    return (d, cache.valid, cache.s_slot, system.species, cache.rev_flat,
            nbr3.mask)


def multi_rows(device) -> dict:
    """The multi-species 3-body rows the multi-species trio kernel is
    timed on, float64: the random Ne/Xe model (``species23_model``) on
    ``ne_xe((13, 13, 13))`` (8,788 atoms, the route's K = 24 list, 18
    live slots a row), the Ne/Ar/Xe model on ``ne_ar_xe()`` (4,000
    atoms, 27 ordered types), and the calculator's rows of the Ne/Xe
    cell rattled by 0.05 A (seed 5).  name -> (potential, d, valid,
    s_slot, species, rev_flat, mask)."""
    from uf3_tpu_torch.forcefield.calculator import UFCalculator
    from uf3_tpu_torch.forcefield.md import MDSystem
    from uf3_tpu_torch.ops import neighbors as nb
    out = {}
    for name, model, geom in (
            ("binary", species23_model(), ne_xe((13, 13, 13))),
            ("ternary", species23_model(("Ne", "Ar", "Xe")), ne_ar_xe())):
        system = MDSystem(model, geom, dtype=torch.float64, device=device)
        state = system.init_state()
        _, cache = system.list_caches(state.nbr2, state.nbr3, state.cell)
        d = nb.cached_displacements(state.positions, state.nbr3, cache)
        out[name] = (system.potential, d, cache.valid, cache.s_slot,
                     system.species, cache.rev_flat, state.nbr3.mask)
    geom = ne_xe((13, 13, 13))
    geom.rattle(0.05, seed=5)
    calc = UFCalculator(species23_model(), device=device)
    calc.get_potential_energy(geom)
    out["calculator"] = (calc.potential,) + calculator_rows(calc, geom)
    return out


def chain(fn, x, length: int):
    """fn applied ``length`` times, each to the previous output."""
    for _ in range(length):
        x = fn(x)
    return x


def graph_chain_ms(fn, x0, length: int = SCAN_LEN, generators=(),
                   replays: int = 10) -> float:
    """Mean device ms per body: ``length`` chained bodies captured in one
    CUDA graph, replayed ``replays`` times between CUDA events, so that
    the host's per-call cost (Python, ctypes, allocation) does not hide
    a body shorter than it.  ``generators`` are the torch generators the
    body draws from, registered with the graph so that every replay
    draws anew.  A body that ignores its input times one call
    ``length`` times."""
    chain(fn, x0, length)
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        chain(fn, x0, length)  # warm the capture stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    for generator in generators:
        graph.register_generator_state(generator)
    with torch.cuda.graph(graph):
        chain(fn, x0, length)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (replays * length)


def graph_ms(fn, repeats: int = SCAN_LEN, replays: int = 10) -> float:
    """Mean device ms of one call fn(): ``repeats`` calls in one CUDA
    graph (``graph_chain_ms`` on a body that ignores its input)."""
    def body(x):
        fn()
        return x

    return graph_chain_ms(body, None, repeats, replays=replays)


def graph_cold_ms(fn, operand_sets, replays: int = 10,
                  before=None) -> float:
    """Mean device ms of one call ``fn(*operands)`` on operands that the
    L2 cache does not hold: ``max(SCAN_LEN, len(operand_sets))`` calls in
    one CUDA graph, each on the next of ``operand_sets`` in turn (copies
    at their own addresses, which together pass the cache:
    ``cold_copies``), replayed ``replays`` times.  ``graph_ms`` repeats
    one set of operands, which then stay in the cache.  ``before()``,
    where given, runs ahead of every call, so that each call follows the
    graph node it makes; its time is in the result."""
    turn = itertools.count()

    def body(x):
        if before is not None:
            before()
        fn(*operand_sets[next(turn) % len(operand_sets)])
        return x

    return graph_chain_ms(body, None, max(SCAN_LEN, len(operand_sets)),
                          replays=replays)


def node_floor_ms(device) -> dict:
    """Device ms of a graph node that does next to nothing, chained as
    ``graph_ms`` chains calls: an empty kernel (``torch.cuda._sleep(0)``)
    and a 16-byte device-to-device memcpy."""
    src = torch.zeros(4, device=device)
    dst = torch.empty_like(src)
    return {"empty kernel": graph_ms(lambda: torch.cuda._sleep(0)),
            "16-byte memcpy": graph_ms(lambda: dst.copy_(src))}


def cold_copies(n_bytes: int, most: int = 128) -> int:
    """How many copies of operands that move ``n_bytes`` per call pass
    twice the card's L2 cache together (at least 1, at most ``most``)."""
    return max(1, min(most, -(-2 * L2_BYTES // max(n_bytes, 1))))


def host_chain_ms(fn, x0, length: int = SCAN_LEN, repeats: int = 3) -> float:
    """Host ms per body: ``length`` chained bodies run eagerly, ended by
    a synchronize on a card; the best of ``repeats`` after one warm
    chain."""
    chain(fn, x0, length)
    sync(x0.device)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        chain(fn, x0, length)
        sync(x0.device)
        best = min(best, (time.perf_counter() - t0) / length)
    return 1e3 * best


def profiled_device_ms(fn, calls: int = 5) -> float:
    """Device busy time per call of fn() in ms: the kernels' and copies'
    own times that ``tracing.trace`` records over ``calls`` calls (it
    raises where the profiler traced no device activity).  For a call
    that a CUDA graph cannot capture (one that reads the device on the
    host)."""
    from uf3_tpu_torch.util import tracing
    fn()
    with tracing.trace() as rec:
        for _ in range(calls):
            fn()
    return rec.device_ms() / calls


def function_lines(module):
    """(first line, last line, name) of every function of ``module`` and
    method of its ``MDSystem``, to place a warning's line."""
    spans = []
    for obj in list(vars(module).values()) + list(
            vars(module.MDSystem).values()):
        obj = getattr(obj, "__func__", obj)
        if inspect.isfunction(obj) and obj.__module__ == module.__name__:
            lines, first = inspect.getsourcelines(obj)
            spans.append((first, first + len(lines) - 1, obj.__name__))
    return spans


def sync_sites(caught) -> dict:
    """Host syncs among recorded warnings, by function of the engine
    (``forcefield/md.py``) or by file:line elsewhere."""
    spans = function_lines(md)
    sites = {}
    for w in caught:
        if "synchronizing" not in str(w.message):
            continue
        where = f"{os.path.basename(w.filename)}:{w.lineno}"
        if w.filename == md.__file__:
            where = next((fn for a, b, fn in spans if a <= w.lineno <= b),
                         where)
        sites[where] = sites.get(where, 0) + 1
    return sites


def count_syncs(fn):
    """fn() under ``torch.cuda.set_sync_debug_mode("warn")``, the card
    synchronized first; returns (its result, host syncs by site, as
    ``sync_sites``)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sync_sites(caught)


def card(device: torch.device):
    """(name, "name, power limit" from nvidia-smi) of a card; (None,
    None) for the CPU."""
    if device.type != "cuda":
        return None, None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return (torch.cuda.get_device_name(device),
            out.stdout.strip().splitlines()[device.index or 0])


def platform(device: torch.device) -> str:
    """The device's platform as the artifacts name it: "gpu" for the
    card, else the device type."""
    return "gpu" if device.type == "cuda" else device.type


def commit() -> str:
    """The checkout's short commit, or "unknown" outside a git
    checkout."""
    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             cwd=REPO, capture_output=True, text=True,
                             timeout=60)
    except OSError:
        return "unknown"
    return out.stdout.strip() or "unknown"


def header(device: torch.device, commit_tag: str = None) -> dict:
    """The artifact's description of the run: platform, card, commit,
    time."""
    name, card_line = card(device)
    return {"platform": platform(device), "device": name, "card": card_line,
            "commit": commit_tag or commit(),
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S")}


def stamp(artifact: dict, device: torch.device,
          commit_tag: str = None) -> dict:
    """``artifact`` with the run's card fields added (``CARD_FIELDS``):
    the device's name, the card's name and power limit as nvidia-smi
    gives them (None on the CPU), the torch version and the commit."""
    name, card_line = card(device)
    artifact.update(device=name or device.type, card=card_line,
                    torch=torch.__version__,
                    commit=commit_tag or commit())
    return artifact


def sync(device: torch.device):
    """Wait for the card (nothing on the CPU): before a clock read."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bcc_w(reps):
    """bcc W at a = 3.1652 A, ``reps`` conventional cells a side."""
    from uf3_tpu_torch.data.atoms import bulk
    return bulk("W", "bcc", a=LATTICE_A) * tuple(reps)


def total_energy_per_atom(system, state) -> float:
    """(potential + kinetic energy) / N of an MD state, eV/atom: the
    energy the NVE drift checks follow."""
    energy = float(state.energy) + system.kinetic_energy(state)
    return energy / state.positions.shape[0]


def write_artifact(artifact: dict, out_dir: str, name: str) -> str:
    """Write ``artifact`` as JSON to ``out_dir``/``name``; returns the
    path."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        json.dump(artifact, f, indent=1)
    return path
