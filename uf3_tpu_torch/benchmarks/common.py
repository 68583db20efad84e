"""
What the measurement scripts share: the device (the card unless asked
for the CPU, as ``MDSystem``), the chain length, CUDA-graph and eager
timing of a chained body, the card's description, the commit, the
artifact directory, and the engine settings and 3-body rows that the
trio kernel is timed on.

Device times come from CUDA graphs: ``SCAN_LEN`` bodies chained (each
takes the previous one's output, as the JAX scripts' ``lax.scan``
chains them) are captured in one graph and replayed between CUDA
events, so that no host cost enters them.  ``graph_cold_ms`` gives each
call its own copy of the operands, so that they come from device memory
and not from the L2 cache.  Host times run the same
chain eagerly, ended by a synchronize.  A time is never divided by a
chain length it was not measured over.
"""

import itertools
import json
import os
import subprocess
import time

import numpy as np
import torch

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


def graph_cold_ms(fn, operand_sets, replays: int = 10) -> float:
    """Mean device ms of one call ``fn(*operands)`` on operands that the
    L2 cache does not hold: ``max(SCAN_LEN, len(operand_sets))`` calls in
    one CUDA graph, each on the next of ``operand_sets`` in turn (copies
    at their own addresses, which together pass the cache:
    ``cold_copies``), replayed ``replays`` times.  ``graph_ms`` repeats
    one set of operands, which then stay in the cache."""
    turn = itertools.count()

    def body(x):
        fn(*operand_sets[next(turn) % len(operand_sets)])
        return x

    return graph_chain_ms(body, None, max(SCAN_LEN, len(operand_sets)),
                          replays=replays)


def cold_copies(n_bytes: int, most: int = 128) -> int:
    """How many copies of operands that move ``n_bytes`` per call pass
    twice the card's L2 cache together (at least 1, at most ``most``)."""
    return max(1, min(most, -(-2 * L2_BYTES // max(n_bytes, 1))))


def host_chain_ms(fn, x0, length: int = SCAN_LEN, repeats: int = 3) -> float:
    """Host ms per body: ``length`` chained bodies run eagerly, ended by
    a synchronize on a card; the best of ``repeats`` after one warm
    chain."""
    def sync():
        if x0.is_cuda:
            torch.cuda.synchronize(x0.device)

    chain(fn, x0, length)
    sync()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        chain(fn, x0, length)
        sync()
        best = min(best, (time.perf_counter() - t0) / length)
    return 1e3 * best


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
    return {"platform": "gpu" if device.type == "cuda" else device.type,
            "device": name, "card": card_line,
            "commit": commit_tag or commit(),
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S")}


def write_artifact(artifact: dict, out_dir: str, name: str) -> str:
    """Write ``artifact`` as JSON to ``out_dir``/``name``; returns the
    path."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        json.dump(artifact, f, indent=1)
    return path
