"""
Smoke run of uf3_tpu_torch on one NVIDIA GPU: builds the CUDA kernels
from the sources in this checkout (no register spills allowed), holds
each against its plain torch twin at the shapes of every MD path, and
the 3-body virial from its partials against the twin's; then drives
the MD engine through the trio kernel at the bench model's full
width (2+3-body W, 9,826 atoms, float32, 2 fs): 3-level r-RESPA 12/6/36
(the benchmark configuration), plain velocity Verlet with the engine's
defaults (and an NVE energy drift check) and 2-level r-RESPA 12/36
under Langevin at 300 K, plain Verlet under Nose-Hoover at 300 K; then
the small and non-periodic cells and a deterministic SCR NPT run
against the CPU; then the two-phase melting protocol's path
(``benchmarks/melting_run.py``) at its full width, 31,104 atoms, with
each of its stages shortened to 256 steps: Langevin with capacity
regrowth, SCR NPT, SCR NPT with half the box pinned, SCR NPT released;
then a melting-point trial of the example
``uf3_tpu_torch/examples/melting_point.py`` at its full width (9,216
atoms, 4,000 K, the preparation cut to a quarter and 2,000 release
steps: the pinned half solid, the hot mobile half below it, the
reference's log keys, a verdict), through the bracket script's
``main`` (``uf3_tpu_torch/benchmarks/melting_run.py``); then the main
path's physics checks (``run_validation``, the scripts of ``uf3_tpu_torch/benchmarks/`` at
9,826 atoms): the long-horizon NVE of the bench path (5,184 steps,
drift and secular heating within 2e-4 eV/atom), the force error of a
frozen neighbor list past the stale trip line in float32 (within 2e-4
eV/A) and float64 (under 1e-5 eV/A, the stale-window gate's bound), the
staleness probe, and the first configuration of each r-RESPA sweep
(NVE drift within 2e-4 eV/atom); then the other measurement scripts of
``uf3_tpu_torch/benchmarks/`` at cut shapes (``run_measurement_scripts``:
the 3-level bench step's anatomy at 12/6/36, every phase's device and
host ms; the full rebuild at 9,826 atoms, its lists equal to the native
host cell list's; the MD rate at 31,250 atoms with no overflow; the
featurizer on 64 cells and the fit on 200, one configuration's rows on
the card within 1e-10 of the CPU's); and the ``md`` command as a user
runs it.  Then the reference's general
force path: the 2-body W model (``model_2.json``) at 9,826 atoms, the
binary Ne/Xe 2-body model (``model_pair.json``) at 8,788 atoms, a random
binary 2+3-body model at 4,000 atoms (the fused multi-species route
beside the factorized 3-body path), a model whose 3-body cutoff passes
its 2-body cutoff (its own 3-body list, the trio kernel on the separate
route) and the bench model with ``fused="separate"``, each against
float64 and, on a cut, the CPU; the queued overflow check; and the
``md`` command on the 2-body model.  Then the fused multi-species route
at full width (the random Ne/Xe 2+3-body model, 8,788 atoms, Langevin
at 10 K and 720 NVE steps, one launch of the multi-species trio kernel
per force call, the kernel held against its plain version on the
path's rows and on a 4,000-atom ternary Ne/Ar/Xe cut); plain Verlet
with ``static_rebuild`` (host syncs per cycle beside the adaptive
schedule's); the bench's 3-level r-RESPA with ``eager_refilter=False``;
and ``md --static-rebuild``.  Then the calculator and what runs on it:
``UFCalculator`` at 9,826 atoms in float64 and float32 (one trio
launch per force call, the card against the CPU on a cut, the trio
kernel's float64 instance against its plain version and bound), FIRE
on that cell, elastic constants and phonons against the CPU, the LAMMPS
export read back on the card, a checkpoint round trip that continues
bitwise, ``batch_relax`` over Ne/Xe structures of three signatures, the
calculator on the fused multi-species route at 8,788 atoms, and ``md
--traj``.  Then the fit on the card (``run_fit``): a training set of the
tungsten set's size (1,939 strained and rattled bcc W cells of 16, 54,
128 and 127 atoms, 150,924 atoms) labeled by the bench model through
``UFCalculator``, featurized on the card in the bench model's basis,
the Gram matrix on the card and the solve on the host, the fitted model
held to its teacher on a 20% hold-out and run in MD at 9,826 atoms,
and the ``tungsten_fit`` example on 50 of its configurations.  Then the
fit's data pipeline on the same labeled set (``run_data_pipeline``):
the configurations written as extended-xyz under four source
directories, read through ``parse_with_subsampling`` into a
``DataCoordinator`` (the first source also parsed by the native
tokenizer, ``uf3_tpu_torch/native``, and by the Python reader,
bit-equal, both timed), cached to an ase.db file and read back bit for
bit, filtered by force, featurized on the card into the ``.npz``,
``fit_from_file`` on the fit's training keys (its energies and forces
within 1e-8 of the fit's) and ``batched_predict`` on its hold-out keys;
then the ``featurize`` / ``fit`` / ``predict`` commands on 50 of them
with a non-default energy key and a PSTRESS source (each -P V shift to
1e-12), and ``md`` on their model with its trio launches counted.
Then the HDF5 feature store on the same set (``run_feature_store``):
``Featurizer.write_features`` on the card into 39 tables of 50
configurations (``util/hdf5.py``, no h5py), a rerun that adds none and
featurizes nothing, the committed fixture ``tests/data/features_ref.h5``
(written by h5py) read bit-equal to its ``.npz`` twin, ``fit_from_file``
and ``batched_predict`` on the ``.h5`` within 1e-10 of the ``.npz`` fit
and at a quarter of its host memory peak, and the commands on an
``.h5`` settings file with ``md`` on their model.  Then the last of the
reference's surface (``run_last_surface``): ``evaluate_parallel`` on two
spawned workers, bit-equal to ``evaluate``; ``UFLammps(backend=
"lammps")`` raising ``ImportError`` on this host, which has no
``lammps``; the native backend on a general triclinic cell against
``UFCalculator`` on the card and the CPU, and that cell's LAMMPS data
file (positive box lengths, rotated back within 1e-10).
Last, the multi-species fit
(``run_fit_multi``): 1,000
strained and rattled binary fcc Ne/Xe cells of 32, 108 and 256 atoms
(129,600 atoms), one in ten without forces, labeled by the random Ne/Xe
2+3-body model through ``UFCalculator`` on the fused multi-species
route, featurized on the card by the multi-species dataset path, fitted
and held to the teacher, its model run in MD at 8,788 atoms on the same
route; then the commands on ``model_pair.json``'s 2-body basis (the
multi-species device route), the ``nexe_pair_fit`` example on a LAMMPS
run (log and dump) of the same labeled frames, and the commands on a
basis of moved knots (the host route).  Then multi-shard MD and fitting on ``torch.distributed``
(``run_halo``): a NCCL group of world size 1 (one card holds one rank)
with a 4-shard mesh; the halo-exchange chunk and the
replicated-positions chunk in float64 at 9,826 atoms against the
single device; the halo chunk's float32 3-level r-RESPA NVE run with
its re-decompositions, one trio launch per mid step for all shards and
halo-sized collectives, beside the single-device rate; the trio
kernel's center weight on the path's rows; the sharded fits on the fit
commands' HDF5 features; then the ``multichip_demo`` example as a subprocess
(NCCL, world size 1, 4 shards: the halo energy within 1e-8 eV of the
single device's in float64).  The trio kernel's triangle lanes (the
``trio_triangle`` option; the halo path's layout on a symmetric grid)
are held to their plain version and to the full lanes on the bench, the
default, the protocol's and a separately built list (K = 16, 23, 20 and
32), timed beside the full lanes, and drive the bench path and plain
Verlet at 9,826 atoms (with 720 NVE steps each); one window of each of
those two paths runs under ``uf3_tpu_torch.util.tracing.trace``, which
reads the device's busy share, its busiest operations and its idle
gaps (the calculator's and the featurizer's busy times come from it
too); the halo chunk runs the triangle lanes.  The neighbor-gather
kernels (``csrc/gather.cu``: ``gather_rows``, ``gather_lanes``,
``rev_gather``) drive their own path through the two measurement
scripts' entry points, with their launch counts from 0: the step
anatomy at 9,826 atoms (``run_anatomy``: the MD inner step's prefixes
by CUDA graph replay beside their eager host times, its 3-body forces
against the float64 engine, the row and reverse-slot gathers timed at
the step's shapes) and the TPU gather probes' cases with the engine's
own position gathers through the port's lists (9,826 x 16, 72, 78 and
31,104 x 88) and slot partials (9,826 x 16 x 5; ``run_probe_gather``:
beside each the library call, the bound, the time on operand copies
past the L2 that the bound is reached against, the instance the plan
chose and the time past a graph node's floor measured in the same run,
and the wrappers' host cost per call; ``rev_gather``'s launches counted
by phase); then each is held bit for bit to its plain version on the
anatomy's system, the bench's pair list, a table that is not contiguous
and a misaligned one, both lane-gather instances, and every
reverse-slot instance, its column form, misaligned and non-contiguous
partials and 2^20 + 16 entries (``compare_gather``).  The fragment
kernels (``csrc/fragments.cu``: ``relayout``, ``lane_contract``,
``lane_map``) drive theirs through the fragment probes' entry point with
their counts from 0 (``run_probe_mosaic``: the 17 cases of the TPU
probes ``probe_mosaic.py`` and ``probe_gather2.py``'s layout primitives
at the probe's block and at the full 9,856-row system, each beside its
plain version, library call and bound; ``lane_contract``'s sum over axis
2, the staged tiles, bit for bit against its plain version at 512 and
9,856 rows in float32 and float64); then each is held to its plain
version at every case's full-system shape in float32 and float64, and
the tiled transpose at (16, 128), (16, 9,856), (37, 1,001), (1, 4,099)
and (4,099, 1) (``compare_fragments``).  The fragment probes also run alone
(``python -m uf3_tpu_torch.benchmarks.probe_mosaic [--device cpu]``);
``tests/test_torch_fragments.py`` holds their plain versions to the TPU
probes' Pallas bodies on the CPU (~16 s), and ``python -m pytest
--noconftest -m cuda tests/test_torch_kernels.py`` the kernels to their
plain versions on the card.

    python3 chip_smoke.py

Exits non-zero, without a result line, when no CUDA device is present
or any phase fails.  The line before the last is a JSON object with the
kernels' launch counts, errors, times and bounds; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import contextlib
import copy
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import tracemalloc
import warnings
from io import StringIO

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from uf3_tpu_torch import io, native  # noqa: E402
from uf3_tpu_torch.benchmarks import common, probe_gather  # noqa: E402
from uf3_tpu_torch.benchmarks.common import (  # noqa: E402
    ne_xe, profiled_device_ms, species23_model)
from uf3_tpu_torch.benchmarks import probe_mosaic, step_anatomy  # noqa: E402
from uf3_tpu_torch.benchmarks import (probe_stale,  # noqa: E402
                                      probe_stale_error, validate_final,
                                      validate_respa, validate_respa_mid)
from uf3_tpu_torch.benchmarks import (anatomy_3l,  # noqa: E402
                                      featurize_throughput, fit_wallclock,
                                      md_scaling, melting_run,
                                      probe_rebuild2)
from uf3_tpu_torch.data.atoms import Atoms, bulk  # noqa: E402
from uf3_tpu_torch.data import io as data_io  # noqa: E402
from uf3_tpu_torch.examples import melting_point  # noqa: E402
from uf3_tpu_torch.examples.nexe_pair_fit import \
    write_lammps_run  # noqa: E402
from uf3_tpu_torch.forcefield import batch, lammps, md, units  # noqa: E402
from uf3_tpu_torch.forcefield.calculator import UFCalculator  # noqa: E402
from uf3_tpu_torch.forcefield.properties import elastic, phonon  # noqa: E402
from uf3_tpu_torch.forcefield.md import SCR, MDSystem  # noqa: E402
from uf3_tpu_torch.ops import _build  # noqa: E402
from uf3_tpu_torch.ops import fragments, gather  # noqa: E402
from uf3_tpu_torch.ops import multi  # noqa: E402
from uf3_tpu_torch.ops import neighbors as nb  # noqa: E402
from uf3_tpu_torch.ops import trio  # noqa: E402
from uf3_tpu_torch.ops.factorized import compute_energy_forces  # noqa: E402
from uf3_tpu_torch.ops.pair import (pair_row_forces,  # noqa: E402
                                    pair_short_forces, pair_tail_forces)
from uf3_tpu_torch.ops.potential import (UF3Potential,  # noqa: E402
                                         grid_sparsity)
from uf3_tpu_torch.ops.splines import _leg_interval  # noqa: E402
from uf3_tpu_torch.parallel import halo  # noqa: E402
from uf3_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from uf3_tpu_torch.representation.knots import \
    get_knot_spacer as knot_spacer  # noqa: E402
from uf3_tpu_torch.util import tracing, user_config  # noqa: E402

# the bench engine, and the melting protocol's cell and engine settings
MODEL, BENCH = common.MODEL, common.BENCH
PROTOCOL, PROTOCOL_REPS = common.PROTOCOL, common.PROTOCOL_REPS
STAGE_STEPS = 256  # per stage (the protocol runs 2,000-10,000)
STAGE_FRICTION = 10.0  # 1/ps, the protocol's stage 2, in every stage
STAGE_T_BAND = 0.1   # mean mobile T within 10% of the stage's target
STRESS_TOL = 1e-5  # eV/A^3, f32 vs f64 per Voigt component
VIRIAL_F64_TOL = 1e-9  # relative, kernel partials vs twin partials
F64_TOL = 1e-10   # same arithmetic, another summation order
FORCE_TOL = 2e-4  # eV/A, f32 vs f64 (tests/test_tpu_numerics.py)
WINDOW_STEPS = 720  # per timed window, as bench.py
T_TARGET, T_BAND = 300.0, 30.0
NVE_DRIFT = 2e-4  # eV/atom over 720 steps (the criterion in ROADMAP.md)
# NVIDIA H100 SXM peaks (data sheet, at 700 W): float32 and float64
# outside the tensor cores, HBM3 bandwidth
PEAK_F32_FLOPS, PEAK_BYTES = 67e12, 3.35e12
PEAK_F64_FLOPS = 34e12


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


GATHERS = (gather.gather_rows, gather.gather_lanes, gather.rev_gather)
# the TPU kernel each gather kernel stands for first (csrc/gather.cu
# names every one it replaces; PERF.md section 6 has the table)
GATHER_REPLACES = {"gather_rows": "benchmarks/step_anatomy.py:250",
                   "gather_lanes": "benchmarks/probe_dynamic_gather.py:131",
                   "rev_gather": "benchmarks/probe_dg2.py:131"}


FRAGMENTS = (fragments.relayout, fragments.lane_contract,
             fragments.lane_map)
# the TPU kernels each fragment kernel stands for (csrc/fragments.cu
# names them; PERF.md section 6 has the table)
FRAGMENT_REPLACES = {
    "relayout": "benchmarks/probe_mosaic.py:43 (#1 :70, #2 :78, #3 :86, "
                "#7 :137), benchmarks/probe_gather2.py:124, :142, :161, "
                ":186",
    "lane_contract": "benchmarks/probe_mosaic.py:43 (#6 :126, #8 :146, "
                     "#9 :155)",
    "lane_map": "benchmarks/probe_mosaic.py:43 (#4 :98, #5 :110, #10 :164, "
                "#14 :218, #15 :229), benchmarks/probe_mosaic.py:200"}
# the full-system case at which the kernels line reports each kernel
FRAGMENT_SHAPES = {"relayout": "probe_gather2.p5b_jnp_repeat",
                   "lane_contract": "probe_mosaic.matmul_tiny_k3",
                   "lane_map": "probe_mosaic.cardinal_interval"}


def reset_counts(kernels=None):
    """The launch count of every kernel wrapper (or of ``kernels``) to
    0."""
    if kernels is None:
        trio.trio_partials.launches = 0
        multi.trio_multi_partials_all.launches = 0
        kernels = GATHERS + FRAGMENTS
    for fn in kernels:
        fn.launches = 0
        if hasattr(fn, "launches_by_mode"):
            fn.launches_by_mode.clear()


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
    CUDA graph, replayed ``replays`` times between CUDA events
    (``common.graph_ms``), so that the host's per-call cost does not
    hide a kernel shorter than it."""
    return common.graph_ms(fn, repeats, replays)


def max_err(a, b) -> float:
    return float(torch.max(torch.abs(a.double().cpu() - b.double().cpu())))


def trio_bound(pot: UF3Potential, d, valid, with_energy: bool,
               peak=PEAK_F32_FLOPS, extra_bytes: int = 0,
               triangle: bool = False):
    """The least time the card needs for one trio_partials call on
    these rows: the flop the kernel's algorithm does for this data (an
    FMA is 2) over the ``peak`` rate (float32 by default), against each
    input read once and
    each output written once, plus ``extra_bytes`` moved beside these
    rows, over the memory rate.  ``triangle`` counts the triangle lanes:
    the live unordered lanes m < n, each with its t2 chain, and the
    slots' sums over their live partners.  Returns (ms, "operations" or
    "bytes", flop, bytes)."""
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
    energy = int(with_energy)
    if triangle:
        # per live lane m < n: 55 for the third leg as below, 1 for g3,
        # 3 FMAs per (b, c) term (the value chain always feeds t2), 3
        # (+1) per b; per live ordered pair, 8 for the slot's sums
        upper = torch.triu(torch.ones_like(eye), diagonal=1)
        per_lane = (55 + 1 + energy + 6 * b_lane * c_live
                    + 2 * (3 + energy) * b_lane)
        pairs = ok[:, :, None] & ok[:, None, :] & ~eye
        lane_flop = (float(torch.sum(per_lane * (lane & upper)))
                     + 8.0 * float(pairs.sum()))
    else:
        term = 6 if with_energy else 4    # 2 or 3 FMAs per (b, c) term
        # per live lane: 55 for d[n] - d[m], |.|, the interval and 4
        # values + 4 derivatives by Horner; 9 (+1) for the sums over n;
        # then the (b, c) terms and the b-level FMAs
        per_lane = (55 + 9 + energy
                    + term * b_lane * c_live + term * b_lane)
        lane_flop = float(torch.sum(per_lane * lane))
    n_rows = int(ok.sum())
    flop = (lane_flop
            + n_rows * (52 + 4)                    # row bases, fc
            + 4.0 * ww * cw * float(torch.sum(b_live * ok)))  # H, H1
    size = pot.grid_window.element_size()
    n_atoms, k = d.shape[:2]
    n_bytes = size * (n_atoms * k * 4 + pot.grid_window.numel()
                      + pot.leg_tables.numel() + n_atoms * (4 + 5 * k)) \
        + extra_bytes
    t_flop, t_bytes = flop / peak, n_bytes / PEAK_BYTES
    return (1e3 * max(t_flop, t_bytes),
            "operations" if t_flop >= t_bytes else "bytes", flop, n_bytes)


def compare_trio(device):
    """Kernel vs twin on the engines' 3-body rows: the bench grid and a
    random non-symmetric one, with and without energy, on the bench
    lists (16 slots) of 1,024 (rattled) and 9,826 atoms, on the
    one-tier default list of 9,826 atoms (23 slots: the KMAX = 32
    instance the plain Verlet path runs) and on the melting protocol's
    list of 31,104 atoms (20 slots, KMAX = 32).  On the bench grid the
    3-body virial from the kernel's partials is held against the twin's
    on the bench and protocol lists (the random grid lacks the exchange
    symmetry the virial's identity needs).  Returns the records of the
    9,826- and 31,104-atom shapes by slot count."""
    base = UF3Potential.from_json(MODEL)
    rng = np.random.RandomState(17)
    random_grid = rng.normal(0.0, 0.05, base.trio.grid.shape) \
        * (base.trio.grid != 0.0)
    assert not np.array_equal(random_grid, random_grid.transpose(1, 0, 2))
    grids = {"bench": base, "random": with_grid(base, random_grid)}
    records = {}
    for reps, rattle, engine in (((8, 8, 8), 0.05, BENCH),
                                 ((17, 17, 17), None, BENCH),
                                 ((17, 17, 17), None, {}),
                                 (PROTOCOL_REPS, None, PROTOCOL)):
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
                if name == "bench" and len(geom) >= 9826 \
                        and not with_energy:
                    if engine:  # the bench and protocol lists
                        compare_virial(geom, k, (twin[2], d64, v64),
                                       (k64[2], d64, v64),
                                       (k32[2], d32, v32))
                    bound_ms, bound_by, flop, n_bytes = trio_bound(
                        pot32, d32, v32, with_energy)
                    occ = trio.trio_occupancy(pot32, k, with_energy,
                                              n_atoms=len(geom))
                    print(f"trio bound at N={len(geom)}, K={k}: "
                          f"{flop:.4g} flop, {n_bytes:.4g} bytes -> "
                          f"{bound_ms:.5f} ms ({bound_by}); kernel reaches "
                          f"{100 * bound_ms / kernel_ms:.1f}% of it; "
                          f"{kernel_ms:.4f} ms; card: {card_line()}")
                    print(f"trio launch plan (f32, K={k}): {plan_line(occ)}")
                    records[f"K{k}"] = dict(
                        max_abs_err=err32, ms=kernel_ms, plain_ms=twin_ms,
                        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                        n_atoms=len(geom), registers=occ["registers"],
                        warps_per_sm=occ["warps_per_sm"],
                        grid=occ["grid"], local_bytes=occ["local_bytes"])
    plans = {(dtype, k, tri, energy): trio.trio_occupancy(
        copy.deepcopy(grids["bench"]).to(device=device, dtype=dtype), k,
        energy, tri, n_atoms=9826)
        for dtype in (torch.float32, torch.float64) for k in (16, 32)
        for tri in (False, True) for energy in (False, True)}
    for (dtype, k, tri, energy), occ in plans.items():
        print(f"trio launch plan ({str(dtype)[6:]}, KMAX={k}, "
              f"{'triangle' if tri else 'full'} lanes, "
              f"{'with' if energy else 'no'} energy, 9,826 atoms): "
              f"{plan_line(occ)}")
    gate("trio launch plans", {"no spills in any instance": all(
        occ["local_bytes"] == 0 for occ in plans.values())})
    if sorted(records) != ["K16", "K20", "K23"]:
        raise AssertionError(f"unexpected 3-body slot counts {records}")
    return records


def plan_line(occ) -> str:
    """A launch plan of ``trio.trio_occupancy`` in one line."""
    return (f"grid {occ['grid']} blocks of {occ['atoms_per_block']} atoms "
            f"({occ['blocks_per_sm']} blocks, {occ['warps_per_sm']} warps "
            f"per SM, {occ['sms']} SMs), {occ['smem_bytes']} B shared, "
            f"{occ['registers']} registers, {occ['local_bytes']} B local "
            "(spills)")


def compare_virial(geom, k, twin64, kernel64, kernel32):
    """The 3-body virial (``trio_virial6``) from the kernel's partials
    against the twin's: float64 within 1e-9 relative, each float32
    Voigt stress component within 1e-5 eV/A^3.  Each argument is
    (partials, d, valid)."""
    v_twin = trio.trio_virial6(*twin64).cpu()
    v64 = trio.trio_virial6(*kernel64).cpu()
    v32 = trio.trio_virial6(*kernel32).double().cpu()
    scale = float(torch.max(torch.abs(v_twin)))
    rel64 = max_err(v64, v_twin) / scale
    d_stress = max_err(v32, v_twin) / geom.get_volume()
    ok = rel64 <= VIRIAL_F64_TOL and d_stress <= STRESS_TOL and scale > 1.0
    print(f"virial N={len(geom)} K={k}: 3-body virial (Voigt, eV) "
          f"{[round(float(x), 4) for x in v_twin]}; kernel f64 vs twin "
          f"{rel64:.3e} relative (<= {VIRIAL_F64_TOL:g}), f32 stress "
          f"max |d sigma| {d_stress:.3e} eV/A^3 (<= {STRESS_TOL:g}): "
          f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError("virial from the kernel's partials disagrees "
                             "with the twin's")


def compare_triangle(device):
    """The trio kernel's triangle lanes (``trio_triangle``, the halo
    path) on the engines' 3-body rows at the bench grid: the bench list
    (K = 16) and the one-tier default list (K = 23) at 9,826 atoms, the
    melting protocol's list (K = 20) at 31,104 atoms and the separately
    built list (K = 32) of ``long_trio_model`` at 9,826 rattled atoms.
    Against the plain triangle version with and without energy (f64
    within 1e-10, f32 forces within 2e-4 eV/A) and against the full
    lanes on the same rows (f64: energy and forces within 1e-10, the
    virial from the partials within 1e-9 relative); K = 1 falls back to
    full lanes (finite, zero energy).  Each shape's no-energy launch
    timed in both layouts by graph replay (full, triangle, triangle,
    full; the mean of each pair), the plain version eagerly, each
    layout's bound and launch plan.  Returns the records by slot count."""
    records = {}
    for pot64, d64, v64, rev_flat, mask in common.trio_rows(device).values():
        k, n = d64.shape[1], d64.shape[0]
        assert pot64.trio.symmetric
        pot32 = copy.deepcopy(pot64).to(dtype=torch.float32)
        d32, v32 = d64.float(), v64.float()

        def forces(out, d):
            return trio.assemble_forces(*out, d, rev_flat, mask)[1]

        errs = dict(plain64=0.0, plain32=0.0, full_e=0.0, full_f=0.0,
                    virial=0.0)
        for with_energy in (True, False):
            twin = trio.trio_partials_torch(d64, v64, pot64.grid, pot64.trio,
                                            with_energy, triangle=True)
            k64 = trio.trio_partials(pot64, d64, v64, with_energy,
                                     triangle=True)
            k32 = trio.trio_partials(pot32, d32, v32, with_energy,
                                     triangle=True)
            full = trio.trio_partials(pot64, d64, v64, with_energy)
            torch.cuda.synchronize()
            f_twin = forces(twin, d64)
            errs["plain64"] = max(errs["plain64"], max_err(
                forces(k64, d64), f_twin), *(max_err(a, b) for a, b in
                                             zip(k64, twin)))
            errs["plain32"] = max(errs["plain32"],
                                  max_err(forces(k32, d32), f_twin))
            errs["full_e"] = max(errs["full_e"], max_err(k64[0], full[0]))
            errs["full_f"] = max(errs["full_f"], max_err(
                forces(k64, d64), forces(full, d64)))
            v_tri = trio.trio_virial6(k64[2], d64, v64)
            v_full = trio.trio_virial6(full[2], d64, v64)
            errs["virial"] = max(errs["virial"], max_err(v_tri, v_full)
                                 / float(torch.max(torch.abs(v_full))))
        full_a = graph_ms(lambda: trio.trio_partials(pot32, d32, v32, False))
        tri_a = graph_ms(lambda: trio.trio_partials(pot32, d32, v32, False,
                                                    triangle=True))
        tri_b = graph_ms(lambda: trio.trio_partials(pot32, d32, v32, False,
                                                    triangle=True))
        full_b = graph_ms(lambda: trio.trio_partials(pot32, d32, v32, False))
        tri_ms, full_ms = 0.5 * (tri_a + tri_b), 0.5 * (full_a + full_b)
        plain_ms = cuda_ms(lambda: trio.trio_partials_torch(
            d32, v32, pot32.grid, pot32.trio, False, triangle=True), 3)
        bound = trio_bound(pot32, d32, v32, False, triangle=True)
        bound_full = trio_bound(pot32, d32, v32, False)
        least = min(bound[0], bound_full[0])
        occ = trio.trio_occupancy(pot32, k, False, triangle=True, n_atoms=n)
        occ_full = trio.trio_occupancy(pot32, k, False, n_atoms=n)
        occ64 = trio.trio_occupancy(pot64, k, True, triangle=True,
                                    n_atoms=n)
        print(f"trio triangle N={n} K={k}: vs plain f64 "
              f"{errs['plain64']:.3e} (<= {F64_TOL:g}), f32 max |dF| "
              f"{errs['plain32']:.3e} eV/A (<= {FORCE_TOL:g}); vs full "
              f"lanes f64 |dE| {errs['full_e']:.3e}, |dF| "
              f"{errs['full_f']:.3e} (<= {F64_TOL:g}), virial "
              f"{errs['virial']:.3e} relative (<= {VIRIAL_F64_TOL:g})")
        print(f"trio triangle N={n} K={k}, f32 no energy: triangle "
              f"{tri_ms:.4f} ms ({tri_a:.4f}, {tri_b:.4f}), full lanes "
              f"{full_ms:.4f} ms ({full_a:.4f}, {full_b:.4f}) (graph "
              f"replay, full/triangle/triangle/full); plain triangle "
              f"{plain_ms:.4f} ms (eager); bounds: triangle {bound[0]:.5f} "
              f"ms ({bound[1]}; {bound[2]:.4g} flop, {bound[3]:.4g} bytes), "
              f"full {bound_full[0]:.5f} ms ({bound_full[2]:.4g} flop); "
              f"reached of the smaller: triangle "
              f"{100 * least / tri_ms:.1f}%, full {100 * least / full_ms:.1f}%"
              f"; plans: triangle {plan_line(occ)}; full {plan_line(occ_full)};"
              f" triangle f64 with energy {plan_line(occ64)}; card: "
              f"{card_line()}")
        gate(f"trio triangle K={k}", {
            f"plain version, f64 within {F64_TOL:g}":
                errs["plain64"] <= F64_TOL,
            f"plain version, f32 within {FORCE_TOL:g} eV/A":
                errs["plain32"] <= FORCE_TOL,
            f"full lanes, energy and forces within {F64_TOL:g}":
                max(errs["full_e"], errs["full_f"]) <= F64_TOL,
            f"full lanes, virial within {VIRIAL_F64_TOL:g} relative":
                errs["virial"] <= VIRIAL_F64_TOL,
            "no spills": occ["local_bytes"] == 0
                and occ64["local_bytes"] == 0})
        records[f"K{k}"] = dict(
            max_abs_err=errs["plain32"], max_abs_err_f64=errs["plain64"],
            full_lanes_err_f64=max(errs["full_e"], errs["full_f"]),
            virial_err_f64=errs["virial"], ms=tri_ms, full_ms=full_ms,
            plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
            full_bound_ms=bound_full[0], least_bound_ms=least,
            library_ms=None, n_atoms=n,
            registers=occ["registers"], warps_per_sm=occ["warps_per_sm"],
            local_bytes=occ["local_bytes"],
            full_registers=occ_full["registers"],
            full_warps_per_sm=occ_full["warps_per_sm"],
            f64_registers=occ64["registers"])
        if k == 16:  # K = 1 on the bench rows
            e1, fc1, part1 = trio.trio_partials(
                pot64, d64[:, :1].contiguous(), v64[:, :1].contiguous(),
                True, triangle=True)
            gate("trio triangle K=1", {
                "zero energy": float(torch.abs(e1).max()) == 0.0,
                "finite": bool(torch.isfinite(fc1).all()
                               and torch.isfinite(part1).all())})
    if sorted(records) != ["K16", "K20", "K23", "K32"]:
        raise AssertionError(f"unexpected 3-body slot counts {records}")
    return records


def run_triangle_paths(device, launches, rates, stale):
    """The bench path (3-level r-RESPA 12/6/36, launches of 10 cycles)
    and the engine's default plain Verlet, both under Langevin at 300 K
    with ``trio_triangle=True`` at 9,826 atoms in f32: a 144-step
    warm-up, three timed windows of 720 steps and 720 NVE steps, under
    the gates of the full-lane paths.  Fills ``launches``, ``rates`` and
    ``stale``."""
    for label, engine, run_kw, split in (
            ("3-level r-RESPA 12/6/36", BENCH,
             dict(LANGEVIN, launch_chunks=10), True),
            ("plain Verlet (defaults)", {}, LANGEVIN, False)):
        name = f"{label}, trio_triangle=True"
        system, state, n, rates[name], temps, stale[name] = run_path(
            name, device, dict(engine, trio_triangle=True), run_kw)
        check_path(name, system, state, n, temps, split=split)
        if not system.triangle:
            raise AssertionError(f"{name}: the triangle lanes are off")
        nve, _, rates[f"{name} NVE"] = run_nve(system, state, f"{name} NVE")
        launches[name] = n + nve


def run_tracing(device):
    """One 720-step window of the bench path and one of plain Verlet at
    the engine's defaults (9,826 atoms, f32, Langevin 300 K, after a
    144-step warm-up and one untraced window) under ``tracing.trace``:
    the device's busy share (the union of its operations' intervals over
    the window), the 5 device operations that took the most time and
    the longest idle gaps, beside the untraced window's rate.  Returns
    (launches, busy shares) by path."""
    launches, shares = {}, {}
    for label, engine, run_kw in (
            ("3-level r-RESPA 12/6/36", BENCH,
             dict(LANGEVIN, launch_chunks=10)),
            ("plain Verlet (defaults)", {}, LANGEVIN)):
        geom = bench_geometry((17, 17, 17))
        system = MDSystem(MODEL, geom, dtype=torch.float32, device=device,
                          **engine)
        state = system.init_state(temperature=T_TARGET, seed=0)
        state, _ = drive(system, state, 144, **run_kw)
        state, untraced = drive(system, state, WINDOW_STEPS, **run_kw)
        reset_counts()
        with tracing.trace() as rec:
            state = system.run(state, n_steps=WINDOW_STEPS, **run_kw)
        launches[f"traced window, {label}"] = trio.trio_partials.launches
        t0 = time.perf_counter()
        share, busy = rec.busy_share(), rec.busy_ms()
        top, gaps = rec.top_ops(5), rec.idle_gaps(5)
        lo, hi = rec.window()
        shares[label] = share
        steps = len(geom) * WINDOW_STEPS
        print(f"trace {label}, {WINDOW_STEPS} steps: device busy "
              f"{busy:.3f} ms of the {(hi - lo) / 1e3:.3f} ms window "
              f"({100 * share:.1f}%; over the untraced window's "
              f"{1e3 * untraced:.3f} ms: {0.1 * busy / untraced:.1f}%); "
              f"traced {steps / rec.wall_s:.1f} atom-steps/s beside "
              f"{steps / untraced:.1f} untraced; the trace read in "
              f"{time.perf_counter() - t0:.1f} s; card: {card_line()}")
        for op in top:
            print(f"trace {label}: top op {op['ms']:.3f} ms in "
                  f"{op['calls']} calls: {op['name'][:100]}")
        print(f"trace {label}: longest idle gaps (ms into the window, "
              f"ms) {[(round(g['at_ms'], 3), round(g['ms'], 3)) for g in gaps]}")
        gate(f"trace {label}", {
            "trio kernel launched in the traced window":
                launches[f"traced window, {label}"] > 0,
            "busy share in (0, 1]": 0.0 < share <= 1.0,
            "finite state": bool(torch.isfinite(state.positions).all())})
    return launches, shares


def compare_gather(device, parts):
    """Each gather kernel against its plain version, bit for bit, at the
    step anatomy's shapes, on its system (``parts``, the 9,826-atom
    system after its warm-up): the positions through the 3-body list's
    16 slots, (N, 16, 5) slot partials through the list's indices and
    reverse slots, as the assembly gathers them, and the lane gather at
    the probes' 9,856 x 16; the row gather also through the bench's
    (N, 72) pair list (``probe_gather.engine_state``), from a view of
    an (N, 4) table that is not contiguous (the wrapper copies it) and
    from a table one element past a 16-byte boundary, the lane gather
    also at T = 32 (its other shuffle instance's edge) and T = 128 (one
    thread per output); the reverse-slot gather also at rows of 1, 2, 3,
    8, 16 and 33 elements through the same list (1 to 66 words: every
    rev instance, rev_wide among them), in the column form (rev = the
    column, as the probes' table gathers), from partials one element past
    a 16-byte boundary and from partials that are not contiguous, and at
    2^20 + 16 entries; in float32 and float64 with int64 (the lists' own)
    and int32 indices.  Each kernel is timed on the gather path
    (``run_anatomy``, ``run_probe_gather``).  Returns each kernel's
    largest difference from its plain version."""
    x, nbr3 = parts.positions.double(), parts.nbr3
    n, k3 = nbr3.idx.shape
    rng = np.random.RandomState(5)
    part = torch.as_tensor(rng.randn(n, k3, 5), device=device)
    lanes = torch.as_tensor(rng.randn(9856, 16), device=device)
    li = torch.as_tensor(rng.randint(0, 16, size=(9856, 16)), device=device)
    x72, nbr72 = probe_gather.engine_state("engine.positions_k72", device)
    wider = torch.as_tensor(rng.randn(n, 4), device=device)
    flat = torch.as_tensor(rng.randn(3 * n + 1), device=device)
    flat5 = torch.as_tensor(rng.randn(n * k3 * 5 + 1), device=device)
    part7 = torch.as_tensor(rng.randn(n, k3, 7), device=device)
    columns = torch.arange(16, device=device)
    table = torch.as_tensor(rng.randn(9856, 16, 1), device=device)
    t_idx = torch.as_tensor(rng.randint(0, 9856, size=(9856, 16)),
                            device=device)
    long_idx = torch.as_tensor(rng.randint(0, 9856, size=(2 ** 16 + 1, 16)),
                               device=device)
    shapes = {
        "gather_rows": [("positions, 3-body rows", (x, nbr3.idx)),
                        ("positions, bench pair list",
                         (x72.double(), nbr72.idx)),
                        ("non-contiguous table", (wider[:, :3], nbr3.idx)),
                        ("misaligned table",
                         (flat[1:].view(n, 3), nbr3.idx))],
        "gather_lanes": [("probe_dynamic_gather.kernel1 lanes", (lanes, li))]
        + [(f"{width}-lane table", (
            torch.as_tensor(rng.randn(4099, width), device=device),
            torch.as_tensor(rng.randint(0, width, size=(4099, 24)),
                            device=device))) for width in (32, 128)],
        "rev_gather": [("slot partials, 3-body rows",
                        (part, nbr3.idx, nbr3.rev))]
        + [(f"W = {w}, 3-body rows", (
            torch.as_tensor(rng.randn(n, k3, w), device=device), nbr3.idx,
            nbr3.rev)) for w in (1, 2, 3, 8, 16, 33)]
        + [("column form, probe_dg3 table", (
            table, t_idx, columns.expand(9856, 16))),
           # built in each dtype, so that the view stays off a boundary
           ("partials off a 16-byte boundary", (
               lambda dtype: flat5.to(dtype)[1:].view(n, k3, 5), nbr3.idx,
               nbr3.rev)),
           ("non-contiguous partials", (part7[..., 1:6], nbr3.idx,
                                        nbr3.rev)),
           ("2^20 + 16 entries, column form", (
               table, long_idx, columns.expand(2 ** 16 + 1, 16)))]}
    errors = {}
    for name, cases in shapes.items():
        kind = probe_gather.KIND[name]
        kernel, plain = gather.KERNELS[kind], gather.PLAIN[kind]
        checks, errs = {}, []
        for label, ops64 in cases:
            for dtype in (torch.float32, torch.float64):
                for index_dtype in (torch.int64, torch.int32):
                    values = ops64[0](dtype) if callable(ops64[0]) \
                        else ops64[0].to(dtype)
                    ops = (values,) + tuple(t.to(index_dtype)
                                            for t in ops64[1:])
                    out, ref = kernel(*ops), plain(*ops)
                    torch.cuda.synchronize()
                    checks[f"{label} {str(dtype)[6:]} "
                           f"{str(index_dtype)[6:]}"] = torch.equal(out, ref)
                    errs.append(max_err(out, ref))
        gate(f"{name} kernel vs plain (bit for bit)", checks)
        errors[name] = max(errs)
    print(f"gather kernels vs plain, largest difference: {errors}")
    return errors


def run_anatomy(device):
    """The step anatomy at 9,826 atoms through its entry point
    (``step_anatomy.main``, the artifact into a temporary directory):
    the prefixes by graph replay beside their eager host times.  Gates:
    P3's 3-body forces within 2e-4 eV/A of the float64 engine's 3-body
    force call (``trio.trio_forces`` with a float64 MDSystem's
    potential) on the same positions and lists, P1 + P3 within 2e-4 of
    the float64 engine's inner-step force call (``trio_short_forces``),
    both gather kernels correct, every device figure finite and
    positive.  Returns (trio launches, the artifact, the anatomy's
    parts)."""
    trio.trio_partials.launches = 0
    out_dir = tempfile.mkdtemp()
    with contextlib.redirect_stdout(StringIO()):
        artifact, parts = step_anatomy.main(device, step_anatomy.REPS,
                                            out_dir=out_dir)
    shutil.rmtree(out_dir)
    launches = trio.trio_partials.launches
    geom = bench_geometry(step_anatomy.REPS)
    system64 = MDSystem(MODEL, geom, dtype=torch.float64, device=device,
                        **step_anatomy.SYSTEM)
    nbr3 = parts.nbr3._replace(
        shift=parts.nbr3.shift.double(),
        reference_positions=parts.nbr3.reference_positions.double())
    x64, cell64 = parts.positions.double(), parts.cell.double()
    f3_64 = trio.trio_forces(system64.potential, x64, cell64, nbr3,
                             with_energy=False)[1]
    f_short64 = trio.trio_short_forces(
        system64.potential, x64, cell64, nbr3, system64.n_basis_short,
        with_energy=False, r_lo=parts.r_lo, r_hi=parts.r_hi)[2]
    d, _ = step_anatomy.gather_comps(parts, parts.positions)
    f3 = step_anatomy.force_eval(parts, d)
    f1 = step_anatomy.pair_short(parts, d)
    err3, err_short = max_err(f3, f3_64), max_err(f1 + f3, f_short64)
    ms, host = artifact["ms"], artifact["host_ms"]
    card = card_line()
    for name, value in ms.items():
        if isinstance(value, float) and name in host:
            print(f"anatomy {name}: {value:.5f} ms device (graph replay, "
                  f"{artifact['scan_len']} chained), {host[name]:.5f} ms "
                  f"host (eager); card: {card}")
    for label, what in (("gather", "row gather (N, 16, 3)"),
                        ("rev_gather", "reverse-slot gather (N, 16, 5)")):
        rec = ms[f"kernel_{label}"]
        print(f"anatomy {what}: kernel {rec['ms']:.5f} ms, library "
              f"{ms[f'library_{label}_ms']:.5f} ms, plain "
              f"{ms[f'plain_{label}_ms']:.5f} ms ({artifact['scan_len']} "
              f"calls in one graph); bound {rec['bytes']} bytes -> "
              f"{rec['bound_ms']:.5f} ms, reached "
              f"{100 * rec['bound_ms'] / rec['ms']:.1f}%; card: {card}")
    print(f"anatomy FMA chain: {ms['fma_achieved_gflops']:.1f} GFLOP/s; "
          f"P3 vs f64 {err3:.3e} eV/A, P1 + P3 vs f64 {err_short:.3e} eV/A; "
          f"{launches} trio launches")
    device_ms = [v for v in ms.values() if isinstance(v, float)] + [
        ms[f"kernel_{label}"]["ms"] for label in ("gather", "rev_gather")]
    gate("step anatomy", {
        f"P3 within {FORCE_TOL:g} eV/A of the f64 engine": err3 <= FORCE_TOL,
        f"P1 + P3 within {FORCE_TOL:g} eV/A of the f64 engine":
            err_short <= FORCE_TOL,
        "kernel_gather correct": ms["kernel_gather"]["correct"],
        "kernel_rev_gather correct": ms["kernel_rev_gather"]["correct"],
        "device figures finite and positive": all(
            np.isfinite(v) and v > 0 for v in device_ms),
        "trio kernel launched": launches > 0,
        "9,826 atoms, 16 slots": (artifact["n_atoms"], artifact["k3"])
        == (9826, 16)})
    return launches, artifact, parts


def run_probe_gather(device):
    """The gather probes through their entry point (``probe_gather.main``,
    the artifact into a temporary directory): every case's kernel and
    library call bit-equal to the plain version (the script raises
    otherwise), its device times by graph replay and its bound.  Returns
    the artifact."""
    out_dir = tempfile.mkdtemp()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(StringIO()):
        artifact = probe_gather.main(device, out_dir=out_dir)
    seconds = time.perf_counter() - t0
    shutil.rmtree(out_dir)
    card = card_line()
    floor = artifact["node_floor_ms"]
    print(f"gather probes: {len(artifact['cases'])} cases and the host "
          f"costs in {seconds:.1f} s; graph node floor: {floor} ms; card: "
          f"{card}")
    for name, rec in artifact["cases"].items():
        plan = rec["instance"]
        print(f"probe {name} ({rec['kind']}, {rec['values']} by "
              f"{rec['index']}, {rec['dtype']} / {rec['index_dtype']}"
              + (f", {plan['kernel']}" if plan else "")
              + f"): kernel {rec['kernel_ms']:.5f} ms "
              f"({rec['kernel_ns_per_row']:.3f} ns/row; past the empty "
              f"node's floor {rec['past_floor_ms']:.5f}), library "
              f"{rec['library_ms']:.5f}, plain {rec['plain_ms']:.5f} ms; "
              f"past the L2 ({rec['cold_copies']} operand copies): kernel "
              f"{rec['kernel_cold_ms']:.5f}, library "
              f"{rec['library_cold_ms']:.5f} ms; bound "
              f"{rec['bound_ms']:.5f} ms, reached {100 * rec['reached']:.1f}%"
              f" (past the L2); card: {card}")
    for shape, costs in artifact["host_us"].items():
        print(f"host us per eager call, {shape}: " + ", ".join(
            f"{who} {us:.2f}" for who, us in costs.items())
            + f"; card: {card}")
    engine = {name: rec for name, rec in artifact["cases"].items()
              if name.startswith("engine.") and rec["kind"] == "rows"}
    gate("gather probes", {
        "every case correct": all(r["correct"]
                                  for r in artifact["cases"].values()),
        "every device time finite and positive": all(
            r[f"{key}{cold}_ms"] > 0 for r in artifact["cases"].values()
            for key in ("kernel", "library", "plain")
            for cold in ("", "_cold")),
        "the engine's four position gathers": len(engine) == 4,
        "the step's slot partials (rev)": artifact["cases"][
            "engine.partials_k16"]["kind"] == "rev",
        "graph node floor measured": floor["empty kernel"] > 0,
        "host costs finite and positive": all(
            0 < us < float("inf") for costs in artifact["host_us"].values()
            for us in costs.values())})
    return artifact


def gather_records(anatomy, probes):
    """Each gather kernel's figures for the kernels line, at the one
    shape where the gather path times it for the MD step: the anatomy's
    row gather of the positions (``kernel_gather``) and reverse-slot
    gather of the slot partials (``kernel_rev_gather``), 9,826 atoms by
    16 slots, and the lane gather at probe_dynamic_gather.kernel1's
    9,856 x 16; beside them the graph node's floor of the same run, each
    wrapper's host cost per call and the library call's, and for the
    row gather the engine's four position gathers; for the reverse-slot
    gather the step's slot partials (``engine.partials_k16``) on operand
    copies past the L2 beside ``part[idx, rev]``'s, and each kernel's
    instance at its shape (registers and warps per SM)."""
    ms = anatomy["ms"]
    floor = probes["node_floor_ms"]
    records = {}
    for name, label in (("gather_rows", "gather"),
                        ("rev_gather", "rev_gather")):
        rec = ms[f"kernel_{label}"]
        records[name] = dict(
            ms=rec["ms"], plain_ms=ms[f"plain_{label}_ms"],
            bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
            library_ms=ms[f"library_{label}_ms"],
            shape=f"step anatomy kernel_{label}", bytes=rec["bytes"],
            node_floor_ms=floor["empty kernel"])
    case = "probe_dynamic_gather.kernel1"
    rec = probes["cases"][case]
    records["gather_lanes"] = dict(
        ms=rec["kernel_ms"], plain_ms=rec["plain_ms"],
        bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
        library_ms=rec["library_ms"], shape=case, bytes=rec["bytes"],
        node_floor_ms=floor["empty kernel"], cold_ms=rec["kernel_cold_ms"],
        library_cold_ms=rec["library_cold_ms"])
    records["gather_rows"]["engine_cases"] = {
        name: dict(ms=rec["kernel_ms"], library_ms=rec["library_ms"],
                   plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
                   cold_ms=rec["kernel_cold_ms"],
                   library_cold_ms=rec["library_cold_ms"],
                   reached=rec["reached"],
                   past_floor_ms=rec["past_floor_ms"],
                   instance=rec["instance"])
        for name, rec in probes["cases"].items()
        if name.startswith("engine.") and rec["kind"] == "rows"}
    rec = probes["cases"]["engine.partials_k16"]
    records["rev_gather"].update(
        cold_ms=rec["kernel_cold_ms"], library_cold_ms=rec["library_cold_ms"],
        warm_ms=rec["kernel_ms"], past_floor_ms=rec["past_floor_ms"],
        reached=rec["reached"], cold_shape="engine.partials_k16")
    for name, shape in (("gather_rows", "engine.positions_k16"),
                        ("gather_lanes", case),
                        ("rev_gather", "engine.partials_k16")):
        rec = probes["cases"][shape]
        plan = gather.gather_occupancy(
            gather.GatherPlan(**rec["instance"]), 4,
            4 if rec["index_dtype"] == "int32" else 8)
        records[name].update(instance=plan["kernel"],
                             registers=plan["registers"],
                             warps_per_sm=plan["warps_per_sm"])
        print(f"{name} at {shape}: {plan['kernel']}, {plan['registers']} "
              f"registers, {plan['local_bytes']} B local, "
              f"{plan['warps_per_sm']} warps per SM; card: {card_line()}")
    rec = records["rev_gather"]
    print(f"rev_gather, the step's slot partials (9,826 x 16, W = 5, "
          f"int64): cold {rec['cold_ms']:.5f} ms beside part[idx, rev] "
          f"{rec['library_cold_ms']:.5f}; warm {rec['warm_ms']:.5f}, past "
          f"the empty node's floor {rec['past_floor_ms']:.5f}; bound "
          f"{rec['bound_ms']:.5f} ms, reached {100 * rec['reached']:.1f}% "
          f"cold; card: {card_line()}")
    for name, record in records.items():
        kind = probe_gather.KIND[name]
        record["host_us"] = {
            shape: {who: us for who, us in costs.items()
                    if who.startswith(kind + " ")}
            for shape, costs in probes["host_us"].items()}
    return {fn.__name__: records[fn.__name__] for fn in GATHERS}


def run_probe_mosaic(device):
    """The fragment probes through their entry point
    (``probe_mosaic.main``, the artifact into a temporary directory):
    every case at the probe's shape and at the full 9,856-row system, its
    kernel held to the plain version (``relayout`` and ``lane_map`` bit
    for bit, ``lane_contract`` within 1e-6 of the sum of its terms'
    magnitudes; the script raises otherwise), the library call where one
    exists, the device times by graph replay and the bound.  Returns the
    artifact."""
    out_dir = tempfile.mkdtemp()
    with contextlib.redirect_stdout(StringIO()):
        artifact = probe_mosaic.main(device, out_dir=out_dir)
    shutil.rmtree(out_dir)
    card = card_line()
    for name, sizes in artifact["cases"].items():
        for size, rec in sizes.items():
            library = "none" if rec["library_ms"] is None \
                else f"{rec['library_ms']:.5f}"
            print(f"probe {name} [{size}] ({rec['kernel']} {rec['mode']}, "
                  f"{rec['inputs']} -> {rec['outputs']}): kernel "
                  f"{rec['kernel_ms']:.5f} ms ({rec['copies']} operand "
                  f"copies; {rec['kernel_warm_ms']:.5f} on one), library "
                  f"{library}, plain {rec['plain_ms']:.5f} ms; bound "
                  f"{rec['bytes']} bytes, "
                  f"{rec['flops']} operations -> {rec['bound_ms']:.5f} ms "
                  f"({rec['bound_by']}), reached {100 * rec['reached']:.1f}%;"
                  f" max_abs_err {rec['max_abs_err']:.3e}; card: {card}")
    records = [rec for sizes in artifact["cases"].values()
               for rec in sizes.values()]
    sum_tiles_check(device, artifact, card)
    gate("fragment probes", {
        "17 cases at the probe's and the full system's shape":
            len(artifact["cases"]) == 17 and len(records) == 34,
        "every case correct at both shapes": all(r["correct"]
                                                 for r in records),
        "the full system at 9,856 rows": artifact["full_rows"] == 9856,
        "every device time finite and positive": all(
            np.isfinite(r[f"{key}_ms"]) and r[f"{key}_ms"] > 0
            for r in records for key in ("kernel", "kernel_warm", "plain",
                                         "library")
            if r[f"{key}_ms"] is not None)})
    return artifact


def sum_tiles_check(device, artifact, card):
    """``lane_contract``'s sum over axis 2 (the staged tiles) bit for bit
    against its plain version at the probe's block and the full system,
    in float32 (the probes' own records) and float64 (drawn here); its
    time, bound, share reached and plan beside the library's
    ``.view(A, K, K).sum(2)``.  These comparison launches leave the
    kernel's count as the probes left it."""
    case = next(c for c in probe_mosaic.CASES if c.mode == "sum_axis2")
    launched = fragments.lane_contract.launches
    checks = {}
    for size, rec in artifact["cases"][case.name].items():
        rows = rec["rows"]
        x = torch.as_tensor(np.random.RandomState(rows).randn(
            rows, probe_mosaic.LANES), device=device)
        checks[f"{rows} rows float32 (the probe's record) bit for bit"] = \
            rec["max_abs_err"] == 0.0
        checks[f"{rows} rows float64 bit for bit"] = torch.equal(
            fragments.lane_contract(x, "sum_axis2"),
            fragments.lane_contract_torch(x, "sum_axis2"))
        plan = fragments.lane_contract_occupancy(x.float(), "sum_axis2")
        checks[f"{rows} rows: the staged tiles"] = \
            plan["kernel"] == "sum_tiles" and plan["local_bytes"] == 0
        print(f"lane_contract sum_axis2 [{size}] ({rows} x "
              f"{probe_mosaic.LANES} -> {rows} x {probe_mosaic.K}, "
              f"float32): the {plan['kernel']} kernel "
              f"{rec['kernel_ms']:.5f} ms cold ({rec['kernel_warm_ms']:.5f} "
              f"warm), bound {rec['bound_ms']:.5f} ms, reached "
              f"{100 * rec['reached']:.1f}%; .view(A, K, K).sum(2) "
              f"{rec['library_ms']:.5f} ms; {plan['registers']} registers, "
              f"{plan['warps_per_sm']} warps per SM, {plan['blocks']} "
              f"blocks; card: {card}")
    torch.cuda.synchronize()
    fragments.lane_contract.launches = launched
    gate("lane_contract's sum over axis 2 (staged tiles)", checks)


def compare_fragments(device):
    """Each fragment kernel against its plain version at every case of
    the fragment probes at the full system's shape, in float32 and
    float64 (the probes' draws; ``probe_mosaic.operands``): ``relayout``
    and ``lane_map`` bit for bit, ``lane_contract`` within 1e-6 (float32;
    2e-15 in float64) of the sum of its terms' magnitudes.  Each kernel is
    timed on the fragment path (``run_probe_mosaic``), not here.  Returns
    each kernel's largest difference from its plain version."""
    rng = np.random.RandomState(7)
    errors = {fn.__name__: 0.0 for fn in FRAGMENTS}
    checks = {}
    for case in probe_mosaic.CASES:
        args, kwargs = probe_mosaic.operands(case, probe_mosaic.N_PAD, rng,
                                             device)
        for dtype in (torch.float32, torch.float64):
            args = tuple(a.to(dtype) if isinstance(a, torch.Tensor)
                         and a.is_floating_point() else a for a in args)
            kwargs = {k: v.to(dtype) if isinstance(v, torch.Tensor)
                      and v.is_floating_point() else v
                      for k, v in kwargs.items()}
            if case.mode == "onehot_count":
                kwargs["dtype"] = dtype
            out = fragments.KERNELS[case.kernel](*args, **kwargs)
            ref = fragments.PLAIN[case.kernel](*args, **kwargs)
            torch.cuda.synchronize()
            checks[f"{case.name} {str(dtype)[6:]}"] = probe_mosaic.agrees(
                case, out, ref, args)
            errors[case.kernel] = max(errors[case.kernel],
                                      probe_mosaic.max_abs_err(out, ref))
    # relayout's copy from a source one word past a 16-byte boundary, on
    # counts of 4k + 1 .. 4k + 3
    base = torch.randn(probe_mosaic.N_PAD * 16 + 8, device=device)
    for dtype in (torch.float32, torch.float64):
        for n in (probe_mosaic.N_PAD * 16 + t for t in (1, 2, 3)):
            x = base.to(dtype)[1:1 + n]
            out = fragments.relayout(x, "reshape", shape=(n, 1))
            ref = fragments.relayout_torch(x, "reshape", shape=(n, 1))
            checks[f"relayout copy, offset source, {n} words, "
                   f"{str(dtype)[6:]}"] = probe_mosaic.same(out, ref)
    # the tiled transpose at the probe's shapes and at shapes ragged in
    # both dimensions
    for shape in ((16, 128), (16, 9856), (37, 1001), (1, 4099), (4099, 1)):
        x64 = torch.as_tensor(rng.randn(*shape), device=device)
        for dtype in (torch.float32, torch.float64):
            x = x64.to(dtype)
            out = fragments.relayout(x, "transpose")
            ref = fragments.relayout_torch(x, "transpose")
            torch.cuda.synchronize()
            checks[f"relayout transpose {shape} {str(dtype)[6:]}"] = \
                probe_mosaic.same(out, ref)
            errors["relayout"] = max(errors["relayout"],
                                     probe_mosaic.max_abs_err(out, ref))
    gate("fragment kernels vs plain (full system)", checks)
    print(f"fragment kernels vs plain, largest difference: {errors}")
    return errors


def fragment_records(mosaic, device):
    """Each fragment kernel's figures for the kernels line at its
    full-system case (``FRAGMENT_SHAPES``), with the launch plans of
    ``relayout`` and ``lane_contract`` there."""
    records = {}
    for fn in FRAGMENTS:
        name = fn.__name__
        rec = mosaic["cases"][FRAGMENT_SHAPES[name]]["full"]
        records[name] = dict(
            ms=rec["kernel_ms"], plain_ms=rec["plain_ms"],
            bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
            library_ms=rec["library_ms"],
            shape=f"{FRAGMENT_SHAPES[name]} at {mosaic['full_rows']} rows",
            bytes=rec["bytes"], flops=rec["flops"])
    # relayout's copy (the reshape) at both sizes, and the launch plans of
    # the record's mode and of the copy
    reshape = "probe_gather2.p2_reshape_128x128_to_1024x16"
    mode = mosaic["cases"][FRAGMENT_SHAPES["relayout"]]["full"]["mode"]
    plans = {m: fragments.relayout_occupancy(m) for m in (mode, "reshape")}
    records["relayout"].update(
        registers=plans[mode]["registers"],
        warps_per_sm=plans[mode]["warps_per_sm"],
        copy={size: dict(ms=rec["kernel_ms"], library_ms=rec["library_ms"],
                         plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
                         warm_ms=rec["kernel_warm_ms"],
                         registers=plans["reshape"]["registers"],
                         warps_per_sm=plans["reshape"]["warps_per_sm"])
              for size, rec in mosaic["cases"][reshape].items()})
    for size, rec in records["relayout"]["copy"].items():
        print(f"relayout copy (reshape) [{size}]: {rec['ms']:.5f} ms beside "
              f".reshape().clone() {rec['library_ms']:.5f} ms; "
              f"{rec['registers']} registers, {rec['warps_per_sm']} warps "
              f"per SM; card: {card_line()}")
    # the transpose kernel at both sizes, past a graph node's floor
    transpose = "probe_gather2.p3_transpose_16x128"
    plan = fragments.relayout_occupancy("transpose")
    records["relayout"]["transpose"] = {
        size: dict(ms=rec["kernel_ms"], warm_ms=rec["kernel_warm_ms"],
                   library_ms=rec["library_ms"], plain_ms=rec["plain_ms"],
                   bound_ms=rec["bound_ms"], registers=plan["registers"],
                   warps_per_sm=plan["warps_per_sm"])
        for size, rec in mosaic["cases"][transpose].items()}
    for size, rec in records["relayout"]["transpose"].items():
        print(f"relayout transpose [{size}]: {rec['ms']:.5f} ms on operand "
              f"copies ({rec['warm_ms']:.5f} on one) beside "
              f"x.t().contiguous() {rec['library_ms']:.5f} ms, bound "
              f"{rec['bound_ms']:.5f}; {rec['registers']} registers, "
              f"{rec['warps_per_sm']} warps per SM; card: {card_line()}")
    case = next(c for c in probe_mosaic.CASES
                if c.name == FRAGMENT_SHAPES["lane_contract"])
    args, kwargs = probe_mosaic.operands(case, mosaic["full_rows"],
                                         np.random.RandomState(0), device)
    plan = fragments.lane_contract_occupancy(*args, **kwargs)
    records["lane_contract"].update(
        registers=plan["registers"], warps_per_sm=plan["warps_per_sm"],
        kernel=plan["kernel"])
    print(f"lane_contract launch plan ({case.name}, {mosaic['full_rows']} "
          f"rows): the {plan['kernel']} kernel, {plan['registers']} "
          f"registers, {plan['local_bytes']} B local, "
          f"{plan['warps_per_sm']} warps per SM, {plan['blocks']} blocks; "
          f"card: {card_line()}")
    gate("lane_contract's plan spills nothing",
         {"local bytes 0": plan["local_bytes"] == 0})
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


def run_path(name, device, engine, run_kw, t_init=T_TARGET, samples=None,
             model=MODEL, geom=None, calls=None):
    """One MD path in float32 (``model`` on ``geom``, by default the
    bench model at 9,826 atoms) from Maxwell-Boltzmann velocities at
    ``t_init``: set-up, a 144-step warm-up and three timed windows, with
    the trio launches counted from 0 over them; with a list
    ``samples``, the run's callback appends T after every launch; with a
    list ``calls``, each force call (``energy_forces``) appends to it.
    Returns (system, state, launches, atom-steps/s, temperatures at the
    end of each window, stale)."""
    geom = bench_geometry((17, 17, 17)) if geom is None else geom
    reset_counts()
    t0 = time.perf_counter()
    system = MDSystem(model, geom, dtype=torch.float32, device=device,
                      **engine)
    if calls is not None:
        count_calls(system, "energy_forces", calls)
    if samples is not None:
        run_kw = dict(run_kw, callback=lambda st, done: samples.append(
            system.temperature(st)))
    state = system.init_state(temperature=t_init, seed=0)
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


def gate(name, checks):
    """Print each check and raise if any failed."""
    for check, ok in checks.items():
        print(f"check {name} {check}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise AssertionError(f"{name} checks failed")


def check_path(name, system: MDSystem, state, launches, temps,
               split: bool, model=MODEL, geom=None, t_target=T_TARGET):
    """The gates of one MD path on its final state: no overflow, finite
    state, trio launches (where the model's route runs the kernel), mean
    T (unless ``t_target`` is None), forces (carried split forces against
    a fresh evaluation for r-RESPA) and energy against float64."""
    energy, forces, _ = system.energy_forces(state.positions, state.nbr2,
                                             state.nbr3, cell=state.cell)
    engine = dict(skin=system.skin, skin_2b=system.skin_2b,
                  capacity_2b=system.capacity_2b,
                  capacity_3b=system.capacity_3b,
                  rebuild_every=system.rebuild_every, fused=system.fused)
    system64 = MDSystem(model, bench_geometry((17, 17, 17)) if geom is None
                        else geom, dtype=torch.float64,
                        device=system.device, **engine)
    e64, f64, _ = system64.energy_forces(state.positions.double(),
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
        "f32 forces match f64": f64_err <= FORCE_TOL,
        "energy matches f64": abs(float(energy) - float(e64))
            <= 1e-6 * abs(float(e64)),
    }
    if system.potential.trio is not None:
        checks["trio kernel launched on this path"] = launches > 0
    if t_target is not None:
        checks[f"mean T within {t_target:g} +- {T_BAND:g} K"] = \
            abs(np.mean(temps) - t_target) <= T_BAND
    if split:
        checks["split forces match a fresh evaluation"] = \
            split_err <= FORCE_TOL
    gate(name, checks)


def run_nve(system: MDSystem, state, name="plain Verlet NVE"):
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
        and (launches > 0 or system.potential.trio is None)
    print(f"{name}: E_total {e0:.6f} -> {e1:.6f} eV over "
          f"{WINDOW_STEPS} steps, drift {drift:.3e} eV/atom "
          f"(<= {NVE_DRIFT:g}): {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"{name} check failed")
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


def run_nose_hoover(device):
    """Plain velocity Verlet at the engine's defaults under Nose-Hoover
    at 300 K, tau 100 fs, timed as ``run_path`` times the other paths.
    The velocities start at 600 K: on a perfect lattice half the kinetic
    energy goes into the potential within ~100 fs, and Nose-Hoover would
    not damp the swing that a start at 300 K leaves.  Gates: the mean of
    the T samples of the last window (one per launch) within 300 +- 30 K,
    and ``check_path``'s.  Returns (launches, atom-steps/s, stale)."""
    samples = []
    system, state, launches, rate, temps, stale = run_path(
        "Nose-Hoover", device, {},
        dict(dt_fs=2.0, thermostat="nose_hoover", temperature=T_TARGET,
             tau_fs=100.0), t_init=2 * T_TARGET, samples=samples)
    last = samples[-(WINDOW_STEPS // system.rebuild_every):]
    mean_t = float(np.mean(last))
    ok = abs(mean_t - T_TARGET) <= T_BAND
    print(f"Nose-Hoover: last window, {len(last)} samples, mean T "
          f"{mean_t:.2f} K (min {min(last):.2f}, max {max(last):.2f}), "
          f"xi {float(state.xi):.4e}: {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError("Nose-Hoover misses its temperature")
    check_path("Nose-Hoover", system, state, launches, temps, split=False)
    return launches, rate, stale


def compare_npt_card_cpu(device):
    """SCR NPT at T = 0 on the card against the CPU, float64, 54 atoms
    (the images builder) from the same numpy velocities: P0 = 0.05
    eV/A^3, tau_p 40 fs, beta 0.2, 48 steps.  With no noise the run is
    deterministic, and the barostat reads the kernel-fed virial every
    step: positions and cell within 1e-10."""
    geom = bench_geometry((3, 3, 3), rattle=0.05)
    v0 = np.random.RandomState(3).normal(0.0, 4e-3, (len(geom), 3))
    out = []
    for dev in ("cpu", device):
        system = MDSystem(MODEL, geom, dtype=torch.float64, device=dev)
        out.append(system.npt_run(
            system.init_state(velocities=v0), n_steps=48, dt_fs=2.0,
            temperature=0.0, pressure=0.05, tau_p_fs=40.0,
            compressibility=0.2))
    (cpu, cells_cpu), (card, cells_card) = out
    errs = (max_err(cpu.positions, card.positions),
            max_err(cpu.cell, card.cell))
    moved = float(torch.max(torch.abs(cpu.cell / geom.cell[0, 0]
                                      - torch.eye(3, dtype=torch.float64))))
    ok = max(errs) <= F64_TOL and moved > 1e-3 \
        and len(cells_cpu) == len(cells_card)
    print(f"NPT card vs CPU (54 atoms, SCR, T = 0, f64): max |dx| "
          f"{errs[0]:.3e}, max |d cell| {errs[1]:.3e} (<= {F64_TOL:g}); the "
          f"cell moved {moved:.3e} relative: {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError("SCR NPT on the card differs from the CPU")


def count_calls(system: MDSystem, method: str, calls: list = None) -> list:
    """A list (``calls``, or a new one) that grows by one at each call of
    ``system``'s method."""
    calls = [] if calls is None else calls
    fn = getattr(system, method)

    def counted(*args, **kwargs):
        calls.append(None)
        return fn(*args, **kwargs)
    setattr(system, method, counted)
    return calls


def protocol_stage(name, system: MDSystem, state, target, run, stress64):
    """One stage of the melting protocol's path: ``run(state, callback)``
    runs it; the callback samples the mobile atoms' T and the volume
    after every launch.  Gates: no overflow after regrowth, a finite
    state and cell, trio launches, the mean T of the second half's
    samples within 10% of ``target``, a cell that stays a multiple of
    the entry cell, and the final f32 stress within 1e-5 eV/A^3 of
    float64.  Returns (state, launches, atom-steps/s)."""
    n_atoms = state.positions.shape[0]
    cell0 = state.cell.double().cpu()
    grown = count_calls(system, "_grow_capacity")
    builds = count_calls(system, "build_lists")
    samples = []

    def callback(st, done):
        samples.append((done, system.temperature(st),
                        float(torch.abs(torch.linalg.det(st.cell.double())))))

    launches0 = trio.trio_partials.launches
    t0 = time.perf_counter()
    state = run(state, callback)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = trio.trio_partials.launches - launches0
    cell = state.cell.double().cpu()
    ratio = float(cell[0, 0] / cell0[0, 0])
    iso = float(torch.max(torch.abs(cell - ratio * cell0))
                / torch.max(torch.abs(cell0)))
    second = [t for done, t, _ in samples if done > STAGE_STEPS // 2]
    mean_t = float(np.mean(second))
    s32 = system.stress(state).double().cpu()
    s64 = stress64(state).cpu()
    d_stress = max_err(s32, s64)
    rate = n_atoms * STAGE_STEPS / seconds
    print(f"protocol {name}: {seconds:.2f} s, {rate:.1f} atom-steps/s, "
          f"{launches} trio launches, {len(grown)} regrows "
          f"(capacities {system.capacity_2b}/{system.capacity_3b}), "
          f"{len(builds)} full list builds in "
          f"{STAGE_STEPS // system.rebuild_every} cycles, "
          f"stale={bool(state.stale)}")
    print(f"protocol {name}: volume (A^3) by launch "
          f"{[round(v, 1) for _, _, v in samples]}; mobile T (K) by launch "
          f"{[round(t, 1) for _, t, _ in samples]}; final stress (eV/A^3) "
          f"{[float(f'{x:.4e}') for x in s32]}, |f32 - f64| "
          f"{d_stress:.3e}")
    checks = {
        "no overflow after regrowth": not system.overflowed(state),
        "finite state and cell": bool(
            torch.isfinite(state.positions).all()
            and torch.isfinite(state.velocities).all()
            and torch.isfinite(state.cell).all()),
        "trio kernel launched": launches > 0,
        f"mean mobile T {mean_t:.1f} K within 10% of {target:g} K":
            abs(mean_t - target) <= STAGE_T_BAND * target,
        f"cell a multiple of its entry cell ({iso:.2e})": iso <= 1e-5,
        f"f32 stress within {STRESS_TOL:g} eV/A^3 of f64":
            d_stress <= STRESS_TOL,
    }
    gate(f"protocol {name}", checks)
    return state, launches, rate


def layer_times_protocol(system: MDSystem, state):
    """Per-call host times of the SCR NPT step's layers at the
    protocol's width, and the device time of its force with and without
    the virial by graph replay."""
    cell, x = state.cell, state.positions
    cache2 = nb.list_cache(state.nbr2, cell, system.dtype)
    cache3 = nb.list_cache(state.nbr3, cell, system.dtype)
    dt = 2.0 * units.fs
    langevin = system._thermostat_fn("langevin", dt, 3500.0,
                                     STAGE_FRICTION, 100.0)
    scr = SCR(0.0, 1000.0 * units.fs, 5e-3)
    scale = torch.ones((), dtype=system.dtype, device=system.device)

    def force(with_virial):
        return lambda: system.energy_forces(
            x, state.nbr2, state.nbr3, cell=cell, with_energy=False,
            with_virial=with_virial, cache2=cache2, cache3=cache3)

    layers = {
        "SCR NPT step (force + virial, Langevin, barostat)": lambda:
            system._verlet_step(state, dt, langevin, False, cache2, cache3,
                                scr, 3500.0, scale),
        "Langevin step (force, no virial)": lambda: system._verlet_step(
            state, dt, langevin, False, cache2, cache3),
        "force + virial (energy_forces)": force(True),
        "force alone (energy_forces)": force(False),
        "staleness triggers (needs_rebuild x2)": lambda: system._stale(
            state.stale, state.nbr2, state.nbr3, x),
        "full rebuild (wrap, cell list, filter)": lambda:
            system.build_lists(system._wrap(x, cell), cell),
    }
    for name, fn in layers.items():
        print(f"layer protocol {name}: {host_ms(fn, 10):.4f} ms per call "
              "(host)")
    for with_virial in (False, True):
        print(f"layer protocol force{' + virial' if with_virial else ''} "
              f"on the device (graph replay): "
              f"{graph_ms(force(with_virial), repeats=10):.4f} ms per call")


def run_protocol(device):
    """The two-phase melting protocol's path (benchmarks/melting_run.py:
    99-252) at its full width, 31,104 atoms of bcc W, float32, with its
    engine settings and each stage cut to 256 steps, friction 10/ps
    throughout: (1) Langevin at 3,500 K with capacity regrowth, (2) SCR
    NPT at 3,500 K, P = 0, (3) the half at fractional x < 0.5 pinned
    (masses 1e12, zero velocity) and SCR NPT at 8,000 K, (4) everything
    released, SCR NPT at 3,500 K.  Stages 3 and 4 build their system
    from the current cell and positions, with the capacities grown so
    far.  Returns (trio launches of the four stages' runs, {stage:
    atom-steps/s})."""
    geom = bench_geometry(PROTOCOL_REPS)
    system = MDSystem(MODEL, geom, dtype=torch.float32, device=device,
                      **PROTOCOL)
    system64 = MDSystem(MODEL, geom, dtype=torch.float64, device=device,
                        **PROTOCOL)

    def stress64(st):
        return system64.stress(st._replace(positions=st.positions.double(),
                                           cell=st.cell.double()))

    npt = dict(n_steps=STAGE_STEPS, dt_fs=2.0, pressure=0.0,
               friction_ps=STAGE_FRICTION, launch_chunks=8)
    trio.trio_partials.launches = 0
    state = system.init_state(temperature=3500.0, seed=0)
    rates, launches = {}, []
    state, n, rates["1 Langevin 3500 K"] = protocol_stage(
        "1 Langevin 3500 K", system, state, 3500.0,
        lambda st, cb: system.run(
            st, n_steps=STAGE_STEPS, dt_fs=2.0, thermostat="langevin",
            temperature=3500.0, friction_ps=STAGE_FRICTION,
            on_overflow="regrow", launch_chunks=8, callback=cb), stress64)
    launches.append(n)
    state, n, rates["2 SCR NPT 3500 K"] = protocol_stage(
        "2 SCR NPT 3500 K", system, state, 3500.0,
        lambda st, cb: system.npt_run(st, temperature=3500.0, callback=cb,
                                      **npt)[0], stress64)
    launches.append(n)
    layer_times_protocol(system, state)

    def rebuilt(masses=None):
        atoms = Atoms(geom.get_atomic_numbers(),
                      state.positions.double().cpu().numpy(),
                      state.cell.double().cpu().numpy(), pbc=True)
        return MDSystem(MODEL, atoms, dtype=torch.float32, device=device,
                        masses=masses, **dict(
                            PROTOCOL, capacity_2b=system.capacity_2b,
                            capacity_3b=system.capacity_3b))

    frac_x = (state.positions.double()
              @ torch.linalg.inv(state.cell.double()))[:, 0] % 1.0
    frozen = (frac_x < 0.5).cpu().numpy()
    masses = system.masses.double().cpu().numpy().copy()
    masses[frozen] = 1e12
    system = rebuilt(masses)
    print(f"protocol: {int(frozen.sum())} of {len(frozen)} atoms pinned")
    velocities = state.velocities.clone()
    velocities[torch.as_tensor(frozen, device=device)] = 0.0
    state = system.init_state(velocities=velocities, seed=1)
    state, n, rates["3 SCR NPT 8000 K, half pinned"] = protocol_stage(
        "3 SCR NPT 8000 K, half pinned", system, state, 8000.0,
        lambda st, cb: system.npt_run(st, temperature=8000.0, callback=cb,
                                      **npt)[0], stress64)
    launches.append(n)
    system = rebuilt()
    state = system.init_state(velocities=state.velocities, seed=2)
    state, n, rates["4 SCR NPT 3500 K, released"] = protocol_stage(
        "4 SCR NPT 3500 K, released", system, state, 3500.0,
        lambda st, cb: system.npt_run(st, temperature=3500.0, callback=cb,
                                      **npt)[0], stress64)
    launches.append(n)
    return sum(launches), rates


# the melting-point example's trial (uf3_tpu_torch/examples/
# melting_point.py) at its full width, 9,216 atoms of bcc W, float32, its
# preparation and release cut, through the bracket script's main
# (uf3_tpu_torch/benchmarks/melting_run.py; the full trials at 31,104
# atoms run through its command line)
MELT_T = 4000.0
MELT_REPS = (32, 12, 12)
MELT_PREP_SCALE = 0.25   # 500 + 750 + (2,500 + 2,000 per melt) steps
MELT_OBS = 2000
# the keys of the reference's log (benchmarks/melting_run.py:99-252):
# those of the preparation, then those of the release
MELT_PREP_KEYS = ("T", "n_atoms", "cell_x_after_equil", "profile_hot",
                  "melt_t", "t_mobile_hot", "profile_after_melt",
                  "solid_fraction_start", "verdict")
MELT_RELEASE_KEYS = ("obs_steps", "obs_atom_steps_per_s",
                     "solid_fraction_series")
MELT_VERDICTS = ("grew", "shrank", "flat", "prep_failed")


def run_melting_trial(device, reps=MELT_REPS):
    """``melting_run.main`` on one trial of the melting-point example at
    ``MELT_T`` with the preparation scaled by ``MELT_PREP_SCALE`` and
    ``MELT_OBS`` release steps, its artifact in a temporary directory,
    the trio kernel's count from 0.  Gates: one trial in the artifact, a
    finite last state with no overflow after regrowth, trio launches,
    every pinned bin of the hot profile above the solid threshold and the
    mobile half's mean under the pinned half's, the reference's log keys,
    a verdict.  Returns (the trio launches, the log)."""
    print(f"melting trial: T {MELT_T:g} K, reps {reps}, prep_scale "
          f"{MELT_PREP_SCALE:g}, n_obs {MELT_OBS}, float32")
    keep = {}
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        results = melting_run.main(
            [f"{MELT_T:g}", "--reps", *(str(r) for r in reps), "--obs",
             str(MELT_OBS), "--prep-scale", f"{MELT_PREP_SCALE:g}", "--out",
             os.path.join(tmp, "melting_point.json"), "--device",
             str(device)], keep=keep)
    log = results["trials"][-1]
    torch.cuda.synchronize()
    launches = trio.trio_partials.launches
    system, state = keep["system"], keep["state"]
    hot = np.asarray(log["profile_hot"])
    pinned, mobile = hot[:len(hot) // 2], hot[len(hot) // 2:]
    keys = MELT_PREP_KEYS + (() if log["verdict"] == "prep_failed"
                             else MELT_RELEASE_KEYS)
    print(f"melting trial: verdict {log['verdict']}, solid fraction series "
          f"{log.get('solid_fraction_series')}, start "
          f"{log['solid_fraction_start']}, melt_t {log['melt_t']:g} K, mobile "
          f"T hot {log['t_mobile_hot']} K, {log['n_pinned']} of "
          f"{log['n_atoms']} atoms pinned, obs_atom_steps_per_s "
          f"{log.get('obs_atom_steps_per_s')}, wall {log['wall_s']:.2f} s, "
          f"{launches} trio launches; card: {card_line()}")
    print(f"melting trial: hot profile {log['profile_hot']}; after the "
          f"melt {log['profile_after_melt']}")
    gate("melting trial", {
        "one trial in the artifact": len(results["trials"]) == 1,
        "finite state and cell": bool(
            torch.isfinite(state.positions).all()
            and torch.isfinite(state.velocities).all()
            and torch.isfinite(state.cell).all()),
        "no overflow after regrowth": not system.overflowed(state),
        "trio kernel launched": launches > 0,
        "the pinned half's bins of profile_hot above "
        f"{melting_point.SOLID_THRESHOLD}": bool(
            np.all(pinned > melting_point.SOLID_THRESHOLD)),
        "the mobile half's mean under the pinned half's":
            mobile.mean() < pinned.mean(),
        "every reference log key": all(k in log for k in keys),
        f"a verdict in {MELT_VERDICTS}": log["verdict"] in MELT_VERDICTS})
    return launches, log


# the main path's physics checks (uf3_tpu_torch/benchmarks/): the
# long-horizon NVE on the bench path, the stale-list force error in f32
# and f64, the staleness probe and each r-RESPA sweep's first
# configuration (the full sweeps run through their own commands)
VALIDATION_FINAL = (BENCH["n_respa"], BENCH["respa_mid"],
                    BENCH["rebuild_every"], BENCH["respa_switch"][0])
VALIDATION_DRIFT = 2e-4  # eV/atom, the reference's criterion
STALE_ERROR_F32 = FORCE_TOL  # eV/A, the f32 device-force tolerance
STALE_ERROR_F64 = probe_stale_error.GATE_BOUND  # eV/A, the stale-window gate


def validation_run(name, fn, launches, **kw):
    """``fn(device=..., keep=..., **kw)`` with the trio kernel's count
    from 0; records its launches under ``name``.  Returns (result,
    system, state, seconds)."""
    keep = {}
    reset_counts()
    t0 = time.perf_counter()
    result = fn(keep=keep, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches[name] = trio.trio_partials.launches
    print(f"{name}: {seconds:.2f} s, {launches[name]} trio launches")
    return result, keep.get("system"), keep.get("state"), seconds


def sound(system: MDSystem, state) -> dict:
    """The gates every validation run shares: a finite last state with no
    overflow."""
    return {"finite state": bool(torch.isfinite(state.positions).all()
                                 and torch.isfinite(state.velocities).all()
                                 and torch.isfinite(state.energy)),
            "no overflow": not system.overflowed(state)}


def run_validation(device):
    """The five physics checks of the main path at 9,826 atoms, float32
    unless said: ``validate_final`` at the bench path's cadence and
    switch, ``probe_stale_error`` in float32 and float64, ``probe_stale``,
    and the first configuration of ``validate_respa`` and
    ``validate_respa_mid``, each with the trio kernel's count from 0.
    Returns (trio launches by run, results by run)."""
    launches, results = {}, {}
    card = card_line()
    name = "validate_final {}/{}/{} ({:g}, 3.5)".format(*VALIDATION_FINAL)
    final, system, state, _ = validation_run(
        name, validate_final.run, launches, n_respa=VALIDATION_FINAL[0],
        respa_mid=VALIDATION_FINAL[1], rebuild=VALIDATION_FINAL[2],
        r_lo=VALIDATION_FINAL[3], device=device)
    results[name] = final
    print(f"{name}: drift trace {final['drift_trace_ev_per_atom']} eV/atom "
          f"over {final['n_steps']} NVE steps; final "
          f"{final['final_drift_ev_per_atom']:.3e}, secular "
          f"{final['secular_heating_ev_per_atom_over_run']:.3e}, shadow "
          f"amplitude {final['shadow_amplitude_ev_per_atom']:.3e} eV/atom; "
          f"card: {card}")
    gate(name, dict(sound(system, state), **{
        f"|final drift| <= {VALIDATION_DRIFT:g} eV/atom":
            final["final_drift_ev_per_atom"] <= VALIDATION_DRIFT,
        f"secular heating <= {VALIDATION_DRIFT:g} eV/atom":
            final["secular_heating_ev_per_atom_over_run"]
            <= VALIDATION_DRIFT,
        "trio kernel launched": launches[name] > 0}))
    for dtype, bound in ((torch.float32, STALE_ERROR_F32),
                         (torch.float64, STALE_ERROR_F64)):
        tag = str(dtype).replace("torch.", "")
        name = f"probe_stale_error, {tag}"
        probe, system, state, _ = validation_run(
            name, probe_stale_error.run, launches, device=device,
            dtype=dtype)
        results[name] = probe
        past = [s for s in probe["samples"] if s["past_stale_line"]]
        worst = probe["max_force_error_past_stale_line_eV_A"]
        print(f"{name}: {len(probe['samples'])} samples, {len(past)} past "
              f"the stale line ({probe['stale_threshold_A']:g} A), drift "
              f"up to {max(s['max_drift_A'] for s in probe['samples']):.4f} "
              f"A; worst force error past the line {worst} eV/A; rebuild "
              f"branches {probe['rebuild_branches']}; card: {card}")
        gate(name, dict(sound(system, state), **{
            "a sample past the stale line": bool(past),
            f"worst error past the line <= {bound:g} eV/A":
                worst is not None and worst <= bound,
            "trio kernel launched": launches[name] > 0}))
    name = "probe_stale"
    rows, system, state, _ = validation_run(name, probe_stale.run, launches,
                                            device=device)
    results[name] = rows
    for i, row in enumerate(rows["per_launch"]):
        print(f"probe_stale launch {i}: {row}")
    gate(name, dict(sound(system, state),
                    **{"trio kernel launched": launches[name] > 0}))
    for module, config in ((validate_respa, validate_respa.CONFIGS[0]),
                           (validate_respa_mid,
                            validate_respa_mid.CONFIGS[0])):
        name = f"{module.__name__.rsplit('.', 1)[1]} {config}"
        sweep, _, _, _ = validation_run(name, module.run, launches,
                                        configs=(config,), device=device)
        results[name] = sweep
        (key, entry), = [(k, v) for k, v in sweep.items()
                         if k.startswith("respa")]
        rate = {k: v for k, v in entry.items() if k.startswith("atom_steps")}
        print(f"{name}: {key} {entry}; rate {rate} (no throughput claim); "
              f"card: {card}")
        gate(name, {
            f"NVE drift <= {VALIDATION_DRIFT:g} eV/atom":
                entry["nve_drift_eV_per_atom"] <= VALIDATION_DRIFT,
            "no overflow": not entry["overflow"],
            "trio kernel launched": launches[name] > 0})
    return launches, results


# the measurement scripts of uf3_tpu_torch/benchmarks/ at cut shapes:
# the 3-level step's anatomy at the bench cadence, the full rebuild at
# 9,826 atoms, the MD rate at 31,250 atoms, the featurizer's throughput
# on 64 cells and the fit on 200 (the full sizes run through each
# script's own command)
MEASURE_CADENCE = (BENCH["n_respa"], BENCH["respa_mid"],
                   BENCH["rebuild_every"])
MEASURE_REBUILD_REPS = (17, 17, 17)
MEASURE_SCALING_REPS = 25
MEASURE_FEATURIZE_CONFIGS = 64
MEASURE_FIT_CONFIGS = 200
MEASURE_FEATURE_TOL = 1e-10  # one configuration's rows, card vs CPU, f64


def positive(x) -> bool:
    return x is not None and bool(np.isfinite(x)) and x > 0


def run_measurement_scripts(device):
    """``anatomy_3l`` at 12/6/36, ``probe_rebuild2`` at 9,826 atoms,
    ``md_scaling`` at 25^3 = 31,250 atoms, ``featurize_throughput`` on
    64 configurations and ``fit_wallclock`` on 200, each script's
    ``run`` with the trio kernel's count from 0.  Gates: every phase's
    device and host ms and every time finite and positive, the rebuild's
    lists equal to the native host list's as sets with the same overflow
    flags, no MD row overflowed, and the features of one configuration
    on the card within 1e-10 of the CPU's.  Returns (trio launches by
    script, results by script)."""
    t0 = time.perf_counter()
    card = card_line()
    launches, results = {}, {}

    def counted(name, fn, *args, **kw):
        reset_counts()
        t = time.perf_counter()
        out = fn(*args, device=device, **kw)
        torch.cuda.synchronize()
        launches[f"measurement: {name}"] = trio.trio_partials.launches
        print(f"{name}: {time.perf_counter() - t:.2f} s, "
              f"{trio.trio_partials.launches} trio launches")
        results[name] = out
        return out

    name = "anatomy_3l {}/{}/{}".format(*MEASURE_CADENCE)
    anatomy = counted(name, anatomy_3l.run, MEASURE_CADENCE)
    for phase, dev in anatomy["scan_chained_ms"].items():
        print(f"{name}: {phase} device {dev:.5f} ms "
              f"({anatomy['device_ms_from'][phase]}), host "
              f"{anatomy['host_ms'][phase]:.5f} ms; card: {card}")
    print(f"{name}: e2e {anatomy['e2e_ms_per_step']:.5f} ms/step (windows "
          f"{[round(t, 5) for t in anatomy['e2e_windows_ms_per_step']]}); "
          f"cycle model device {anatomy['cycle_model_device_ms_per_step']:.5f}"
          f", host {anatomy['cycle_model_ms_per_step']:.5f}; unmodeled "
          f"{anatomy['unmodeled_ms_per_step']:.5f} (host), "
          f"{anatomy['unmodeled_device_ms_per_step']:.5f} (device); "
          f"branches {anatomy['rebuild_branches']}; node floor "
          f"{anatomy['node_floor_ms']}; card: {card}")
    gate(name, dict({
        f"{phase} device and host ms finite and positive":
            positive(anatomy["scan_chained_ms"][phase])
            and positive(anatomy["host_ms"][phase])
        for phase in anatomy["scan_chained_ms"]}, **{
        "e2e and both models finite and positive": all(positive(anatomy[k])
            for k in ("e2e_ms_per_step", "cycle_model_ms_per_step",
                      "cycle_model_device_ms_per_step")),
        "a rebuild branch a cycle in the windows":
            sum(anatomy["rebuild_branches"].values())
            == anatomy["window_steps"]
            * len(anatomy["e2e_windows_ms_per_step"]) // MEASURE_CADENCE[2],
        "trio kernel launched": launches[f"measurement: {name}"] > 0}))
    name = "probe_rebuild2 {} atoms".format(
        2 * int(np.prod(MEASURE_REBUILD_REPS)))
    (entry,) = counted(name, probe_rebuild2.run,
                       (MEASURE_REBUILD_REPS,))["sizes"]
    print(f"{name}: grid {entry['grid']}, bin capacity "
          f"{entry['bin_capacity']}, host {entry['host_ms']:.4f} ms, card "
          f"busy {entry['device_busy_ms']:.4f} ms a build, "
          f"{entry['host_syncs']} host syncs {entry['host_syncs_by_site']}, "
          f"native {entry['native']}; card: {card}")
    gate(name, {
        "host and device ms finite and positive":
            positive(entry["host_ms"]) and positive(entry["device_busy_ms"]),
        "a host sync counted": positive(entry["host_syncs"]),
        "both lists equal the native host list's (sets, overflow flags)":
            entry["lists_equal_native"],
        "no overflow": not any(c["overflow"]
                               for c in entry["native"].values())})
    name = f"md_scaling {MEASURE_SCALING_REPS}^3"
    (row,) = counted(name, md_scaling.run, (MEASURE_SCALING_REPS,))["sizes"]
    print(f"{name}: {row}; card: {card}")
    gate(name, {
        "no overflow": not row["overflow"],
        "rates finite and positive": all(positive(r) for r in
                                         row["window_atom_steps_per_s"]),
        "busy share in (0, 1]": 0.0 < row["busy_share"] <= 1.0,
        "trio kernel launched": launches[f"measurement: {name}"] > 0})
    name = f"featurize_throughput {MEASURE_FEATURIZE_CONFIGS}"
    feat = counted(name, featurize_throughput.run, MEASURE_FEATURIZE_CONFIGS)
    print(f"{name}: {feat['featurize_ms_per_config']:.4f} ms a "
          f"configuration ({feat['featurize_s']:.4f} s); card: {card}")
    gate(name, {"time finite and positive": positive(feat["featurize_s"])})
    name = f"fit_wallclock {MEASURE_FIT_CONFIGS}"
    keep = {}
    fit = counted(name, fit_wallclock.run, MEASURE_FIT_CONFIGS, keep=keep)
    geoms, energies, forces = fit_wallclock.build_dataset(1)
    from uf3_tpu_torch.ops import featurize as feat_ops
    x_e, _, x_f, _ = feat_ops.featurize_dataset_device(
        featurize_throughput.demo_basis(), geoms, energies, forces,
        device="cpu")
    card_e, _, card_f, _ = keep["rows"]
    err = max(float(np.abs(card_e[:1] - x_e).max()),
              float(np.abs(card_f[:len(x_f)] - x_f).max()))
    print(f"{name}: featurize {fit['featurize_s']:.4f} s, solve "
          f"{fit['solve_s']:.4f} s; configuration 0's rows card vs CPU "
          f"{err:.3e}; card: {card}")
    gate(name, {
        "times finite and positive": positive(fit["featurize_s"])
        and positive(fit["solve_s"]),
        "finite coefficients": bool(np.isfinite(
            keep["model"].coefficients).all()),
        f"configuration 0's rows, card vs CPU, within "
        f"{MEASURE_FEATURE_TOL:g}": err <= MEASURE_FEATURE_TOL})
    print(f"measurement scripts: {time.perf_counter() - t0:.2f} s")
    return launches, results


def run_md_command(model="model_2and3.json", *flags):
    """``python -m uf3_tpu_torch md`` at its defaults (and ``flags``),
    as a user runs it: exit 0 and a finite T and E on its result
    line.  Returns (atom-steps/s, E in eV)."""
    cmd = [sys.executable, "-m", "uf3_tpu_torch", "md",
           os.path.join("benchmarks_data", model), *flags]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    seconds = time.perf_counter() - t0
    lines = out.stdout.strip().splitlines()
    for line in lines:
        print(f"md command ({model}): {line}")
    found = re.search(r"\(([-+.\deE]+) atom-steps/s\); T = (\S+) K, "
                      r"E = (\S+) eV", lines[-1] if lines else "")
    ok = out.returncode == 0 and found is not None \
        and all(np.isfinite(float(x)) for x in found.groups())
    print(f"md command ({model}): exit {out.returncode} after "
          f"{seconds:.2f} s: {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"md command failed:\n{out.stderr[-4000:]}")
    return float(found.group(1)), float(found.group(3))


# -- the reference's general force path (2-body-only, multi-species and
# separately built 3-body lists), the separate route and the queued
# overflow check
MODEL_2 = os.path.join(REPO, "benchmarks_data", "model_2.json")
MODEL_PAIR = os.path.join(REPO, "benchmarks_data", "model_pair.json")
LANGEVIN = dict(dt_fs=2.0, thermostat="langevin", temperature=T_TARGET)
# f64, the fused routes against the factorized path: since the kernels'
# tables hold the model's own knots (5e-9 and 1e-9 when they rebuilt
# them from the first knot gap), what is left is the summation order:
# on the card 2.2e-14 eV/A (separate route, 9,826 atoms) and |dE|, |dF|,
# |dW| at most 3.2e-12 (multi-species route, 4,000 atoms; PERF.md)
FUSED_FORCE_TOL = 1e-12
FUSED_ROUTE_TOL = 5e-11
BINARY_NVE_DRIFT = 1e-3  # eV/atom, as tests/test_device_potential.py:787


def card_vs_cpu(name, model, geom, device, n_steps, dt_fs):
    """The engine on the card against its own CPU run, float64, from the
    same inputs: entry energy, forces and virial, then ``n_steps`` NVE
    steps, within 1e-10."""
    v0 = np.random.RandomState(len(geom)).normal(0.0, 2e-3, (len(geom), 3))
    out = []
    for dev in ("cpu", device):
        system = MDSystem(model, geom, dtype=torch.float64, device=dev)
        entry = system.init_state(velocities=v0)
        virial = system.energy_forces(entry.positions, entry.nbr2,
                                      entry.nbr3, with_virial=True)[2]
        out.append((entry, virial,
                    system.run(entry, n_steps=n_steps, dt_fs=dt_fs)))
    (c0, cv, cn), (g0, gv, gn) = out
    errs = [max(max_err(c0.energy, g0.energy), max_err(c0.forces, g0.forces),
                max_err(cv, gv)),
            max(max_err(cn.positions, gn.positions),
                max_err(cn.forces, gn.forces))]
    ok = max(errs) <= F64_TOL
    print(f"{name}: card vs CPU f64, {len(geom)} atoms: entry |dE|, |dF|, "
          f"|dW| {errs[0]:.3e}, after {n_steps} steps |dx|, |dF| "
          f"{errs[1]:.3e} (<= {F64_TOL:g}): {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"{name}: card and CPU differ")


def run_two_body_w(device):
    """``model_2.json`` (2-body W) at the bench width, 9,826 atoms, the
    engine's defaults, float32, by the factorized path: Langevin at 300 K
    (144-step warm-up, 3 x 720 steps), then 720 NVE steps.  Returns
    (atom-steps/s, NVE atom-steps/s, stale)."""
    name = "2-body W (model_2.json)"
    system, state, launches, rate, temps, stale = run_path(
        name, device, {}, LANGEVIN, model=MODEL_2)
    assert system.degree == 2 and state.nbr3 is None
    check_path(name, system, state, launches, temps, split=False,
               model=MODEL_2)
    _, _, nve_rate = run_nve(system, state, f"{name} NVE")
    return rate, nve_rate, stale


def run_binary_pair(device):
    """``model_pair.json`` (Ne/Xe, 2-body) on fcc at a = 5.4 A, 13^3 x 4
    = 8,788 atoms, half Xe, Langevin at 50 K with 1 fs steps (3 x 720
    after 144), float32; then the card against the CPU on a 500-atom
    cut.  Returns (atom-steps/s, stale)."""
    name = "binary Ne/Xe 2-body (model_pair.json)"
    geom = ne_xe((13, 13, 13))
    run_kw = dict(dt_fs=1.0, thermostat="langevin", temperature=50.0)
    system, state, launches, rate, temps, stale = run_path(
        name, device, {}, run_kw, t_init=50.0, model=MODEL_PAIR, geom=geom)
    check_path(name, system, state, launches, temps, split=False,
               model=MODEL_PAIR, geom=geom, t_target=None)
    card_vs_cpu(name, MODEL_PAIR, ne_xe((5, 5, 5)), device, 12, 1.0)
    return rate, stale


def run_binary_trio(device):
    """The random binary 2+3-body model (``species23_model``), fcc Ne/Xe
    at a = 5.4 A, 10^3 x 4 = 4,000 atoms, by the fused
    multi-species route (the engine's) and by the factorized path: the
    fused route's forces and virial in float32 against float64, the
    fused route against the factorized path in float64 (5e-11), the
    device and host time of one force call on each route, the card
    against the CPU on a 500-atom cut, and 200 NVE steps of 1 fs from
    10 K.  Returns (atom-steps/s of the NVE run, {route: (device ms,
    host ms)})."""
    name = "binary Ne/Xe 2+3-body, 4,000 atoms"
    model = species23_model()
    geom = ne_xe((10, 10, 10), seed=5)
    system = MDSystem(model, geom, dtype=torch.float32, device=device)
    system64 = MDSystem(model, geom, dtype=torch.float64, device=device)
    assert system.potential.trio is None and system.degree == 3
    assert system._multi_route()
    state = system.init_state(temperature=10.0, seed=0)
    x, cell = state.positions, state.cell
    _, f32, v32 = system.energy_forces(x, state.nbr2, state.nbr3,
                                       with_virial=True)
    _, f64, v64 = system64.energy_forces(x.double(), state.nbr2, state.nbr3,
                                         cell=cell.double(), with_virial=True)
    d_force = max_err(f32, f64)
    d_stress = max_err(v32, v64) / geom.get_volume()
    print(f"{name}: {len(geom)} atoms, K2={state.nbr2.idx.shape[1]}, "
          f"K3={state.nbr3.idx.shape[1]}, "
          f"{len(system.potential.factorized.trio_specs)} ordered trio "
          f"types; f32 vs f64 max |dF| {d_force:.3e} eV/A, max |d sigma| "
          f"{d_stress:.3e} eV/A^3")
    x64, cell64 = x.double(), cell.double()
    e_m, f_m, v_m = system64.energy_forces(x64, state.nbr2, state.nbr3,
                                           cell=cell64, with_virial=True)
    e_f, f_f, v_f = system64.energy_forces_virial(x64, state.nbr2,
                                                  state.nbr3, cell=cell64)
    d_route = max(abs(float(e_m - e_f)), max_err(f_m, f_f),
                  max_err(v_m, v_f))
    print(f"{name}: fused multi-species route vs factorized path, f64: "
          f"|dE|, |dF|, |dW| {abs(float(e_m - e_f)):.3e}, "
          f"{max_err(f_m, f_f):.3e}, {max_err(v_m, v_f):.3e}")
    fp, species = system.potential.factorized, system.species
    cache2, cache3 = system.list_caches(state.nbr2, state.nbr3, cell)

    def factorized():
        return compute_energy_forces(fp, species, x, cell, state.nbr2,
                                     state.nbr3)

    def fused():
        return system.energy_forces(x, state.nbr2, state.nbr3, cell=cell,
                                    with_energy=False, cache2=cache2,
                                    cache3=cache3)
    times = {}
    for route, fn, repeats in (("fused multi-species energy_forces", fused,
                                20),
                               ("factorized compute_energy_forces",
                                factorized, 5)):
        times[route] = (graph_ms(fn, repeats=repeats, replays=4),
                        host_ms(fn, 10))
        print(f"layer {name} {route}: device {times[route][0]:.4f} ms "
              f"(graph replay), host {times[route][1]:.4f} ms per call")
    card_vs_cpu(name, model, ne_xe((5, 5, 5), seed=5), device, 6, 1.0)
    e0 = float(state.energy) + system.kinetic_energy(state)
    calls = count_calls(system, "energy_forces")
    reset_counts()
    state, seconds = drive(system, state, 200, dt_fs=1.0)
    launches = multi.trio_multi_partials_all.launches
    e1 = float(state.energy) + system.kinetic_energy(state)
    drift = abs(e1 - e0) / len(geom)
    print(f"{name}: 200 NVE steps from 10 K in {seconds:.2f} s, E_total "
          f"{e0:.6f} -> {e1:.6f} eV, drift {drift:.3e} eV/atom, T "
          f"{system.temperature(state):.2f} K, {launches} multi-species "
          f"trio launches for {len(calls)} force calls")
    gate(name, {
        "f32 forces match f64": d_force <= FORCE_TOL,
        "f32 stress matches f64": d_stress <= STRESS_TOL,
        f"fused route within {FUSED_ROUTE_TOL:g} of the factorized path "
        "(f64)": d_route <= FUSED_ROUTE_TOL,
        "no overflow": not system.overflowed(state),
        "finite state": bool(torch.isfinite(state.positions).all()
                             and torch.isfinite(state.forces).all()),
        f"NVE drift <= {BINARY_NVE_DRIFT:g} eV/atom":
            drift <= BINARY_NVE_DRIFT,
        "one multi-species trio launch per force call": launches > 0
            and launches == len(calls)})
    return len(geom) * 200 / seconds, times, launches


def run_separate_3body(device):
    """``long_trio_model`` at 9,826 atoms, skin 0.5 A, 32 3-body slots:
    its 3-body list is built on its own, with reverse slots, and the
    separate route runs the trio kernel (KMAX = 32) on it.  The kernel
    against its twin on that list (rattled 0.05 A, f64 and f32), the
    separate route against the factorized path on the same lists (f64),
    both lists' neighbor sets against the O(N^2) builder, then Langevin
    at 300 K (3 x 720 steps after 144).  Returns (kernel record,
    launches, atom-steps/s, stale)."""
    name = "3-body cutoff beyond the 2-body cutoff (separate route)"
    model = common.long_trio_model()
    engine = dict(skin=0.5, capacity_3b=32)
    geom = bench_geometry((17, 17, 17), rattle=0.05)
    system64 = MDSystem(model, geom, dtype=torch.float64, device=device,
                        **engine)
    assert system64.separate_3b and system64.fused == "shared"
    state = system64.init_state()
    x, cell, nbr = state.positions, state.cell, state.nbr3
    cache = nb.list_cache(nbr, cell, torch.float64)
    d64 = nb.cached_displacements(x, nbr, cache)
    v64 = cache.valid
    pot64 = system64.potential
    pot32 = copy.deepcopy(pot64).to(dtype=torch.float32)
    d32, v32 = d64.float(), v64.float()
    twin = trio.trio_partials_torch(d64, v64, pot64.grid, pot64.trio, False)
    f_twin = trio.assemble_forces(*twin, d64, cache.rev_flat, nbr.mask)[1]
    k64 = trio.trio_partials(pot64, d64, v64, False)
    k32 = trio.trio_partials(pot32, d32, v32, False)
    torch.cuda.synchronize()
    err64 = max(max(max_err(a, b) for a, b in zip(k64, twin)), max_err(
        trio.assemble_forces(*k64, d64, cache.rev_flat, nbr.mask)[1],
        f_twin))
    err32 = max_err(trio.assemble_forces(*k32, d32, cache.rev_flat,
                                         nbr.mask)[1], f_twin)
    kernel_ms = graph_ms(lambda: trio.trio_partials(pot32, d32, v32, False))
    twin_ms = cuda_ms(lambda: trio.trio_partials_torch(
        d32, v32, pot32.grid, pot32.trio, False), 5)
    bound_ms, bound_by, flop, n_bytes = trio_bound(pot32, d32, v32, False)
    occ = trio.trio_occupancy(pot32, 32, False, n_atoms=len(geom))
    k = d64.shape[1]
    print(f"trio separate list N={len(geom)} K={k} (valid slots "
          f"{int(v64.sum(1).min())}-{int(v64.sum(1).max())}): f64 max err "
          f"{err64:.3e} (<= {F64_TOL:g}), f32 max |dF| {err32:.3e} eV/A "
          f"(<= {FORCE_TOL:g}); f32 kernel {kernel_ms:.4f} ms (graph "
          f"replay), twin {twin_ms:.4f} ms "
          f"(eager); bound {flop:.4g} flop, {n_bytes:.4g} bytes -> "
          f"{bound_ms:.5f} ms ({bound_by}), {100 * bound_ms / kernel_ms:.1f}%"
          f" of it; launch plan {plan_line(occ)}; card: {card_line()}")
    record = dict(max_abs_err=err32, ms=kernel_ms, plain_ms=twin_ms,
                  bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                  n_atoms=len(geom), registers=occ["registers"],
                  warps_per_sm=occ["warps_per_sm"],
                  list="built on its own (separate route)")
    e_s, f_s, v_s = system64.energy_forces(x, state.nbr2, nbr,
                                           with_virial=True)
    e_f, f_f, v_f = system64.energy_forces_virial(x, state.nbr2, nbr)
    d_route = max_err(f_s, f_f)
    print(f"{name}: separate route vs factorized path, f64: |dE| "
          f"{abs(float(e_s - e_f)):.3e} eV, max |dF| {d_route:.3e} eV/A, "
          f"max |dW| {max_err(v_s, v_f):.3e} eV")
    same_sets = {}
    for tag, nbr_l, r_cut, capacity in (
            ("2-body", state.nbr2, system64.r_cut_2b + system64.skin_2b,
             system64.capacity_2b),
            ("3-body", nbr, system64.r_cut_3b + system64.skin,
             system64.capacity_3b)):
        ref = nb.build_neighbor_list(x, cell, system64.pbc, r_cut, capacity)
        same_sets[tag] = np.array_equal(list_keys(ref), list_keys(nbr_l)) \
            and bool(ref.overflow) == bool(nbr_l.overflow) is False
    print(f"{name}: neighbor sets equal to the O(N^2) builder's {same_sets} "
          f"(K2={state.nbr2.idx.shape[1]}, K3={k})")
    gate(name, {
        "trio kernel matches its twin": err64 <= F64_TOL
            and err32 <= FORCE_TOL,
        f"separate route within {FUSED_FORCE_TOL:g} eV/A of the "
        "factorized path": d_route <= FUSED_FORCE_TOL,
        "neighbor sets equal the O(N^2) builder's": all(same_sets.values()),
        "32 slots, reverse slots from the builder": k == 32
            and nbr.sel is None})
    system, state, launches, rate, temps, stale = run_path(
        name, device, engine, LANGEVIN, model=model)
    check_path(name, system, state, launches, temps, split=False,
               model=model, t_target=None)
    return record, launches, rate, stale


def run_fused_separate(device):
    """The bench model at the engine's defaults with
    ``fused="separate"``: the pair force and the trio kernel on their
    own gathers, 9,826 atoms, Langevin at 300 K, timed as the shared
    route's run; its forces against the shared route's on the final
    state's lists, f64, within 1e-10.  Returns (launches, atom-steps/s,
    stale)."""
    name = "plain Verlet, fused=\"separate\""
    system, state, launches, rate, temps, stale = run_path(
        name, device, dict(fused="separate"), LANGEVIN)
    check_path(name, system, state, launches, temps, split=False)
    out = []
    for fused in ("shared", "separate"):
        system64 = MDSystem(MODEL, bench_geometry((17, 17, 17)),
                            dtype=torch.float64, device=device, fused=fused)
        out.append(system64.energy_forces(
            state.positions.double(), state.nbr2, state.nbr3,
            cell=state.cell.double(), with_virial=True))
    (e_a, f_a, v_a), (e_b, f_b, v_b) = out
    errs = (abs(float(e_a - e_b)), max_err(f_a, f_b), max_err(v_a, v_b))
    print(f"{name}: vs the shared route, f64: |dE| {errs[0]:.3e}, max |dF| "
          f"{errs[1]:.3e}, max |dW| {errs[2]:.3e}")
    gate(name, {"forces equal the shared route's (1e-10)":
                max(errs) <= F64_TOL})
    return launches, rate, stale

# -- the fused multi-species route at full width, and the rebuild schedules


def type_flops(pot, t, d, valid, s_slot, species, with_energy: bool):
    """The flop ordered type ``t``'s lanes take in one multi-species pass
    on these rows, counted as ``trio_bound`` counts the unary kernel's:
    rows m valid, of species s_m and under a center of species s_c; lanes
    (m, n) with n valid and of species s_n."""
    desc = pot.trio_multi.descs[t]
    l_lo, l_hi, b_lo, b_hi, c_lo, c_hi = desc.window
    bw, cw = b_hi - b_lo, c_hi - c_lo
    d = d.double()
    center = (species == desc.s_c)[:, None]
    ok_m = (valid != 0) & (s_slot == desc.s_m) & center       # (N, K)
    ok_n = (valid != 0) & (s_slot == desc.s_n)
    r = torch.sqrt(torch.sum(d * d, -1).clamp_min(1e-300))
    taps = torch.arange(4, device=d.device)

    def live(idx, lo, hi):
        return (((idx[..., None] + taps) >= lo)
                & ((idx[..., None] + taps) < hi)).sum(-1)
    l_live = live(_leg_interval(desc.spec_l1, r), l_lo, l_hi)
    b_live = live(_leg_interval(desc.spec_l2, r), b_lo, b_hi)
    diff = d[:, None, :, :] - d[:, :, None, :]                 # [a, m, n]
    r_mn2 = torch.sum(diff * diff, -1)
    r_mn = torch.sqrt(r_mn2.clamp_min(1e-300))
    eye = torch.eye(d.shape[1], dtype=torch.bool, device=d.device)
    lane = (ok_m[:, :, None] & ok_n[:, None, :] & ~eye & (r_mn2 > 1e-10)
            & (r_mn >= desc.spec_n.t_min) & (r_mn <= desc.spec_n.t_max))
    c_live = live(_leg_interval(desc.spec_n, r_mn), c_lo, c_hi)
    b_lane = b_live[:, None, :].expand_as(c_live)
    term = 6 if with_energy else 4
    per_lane = (55 + 9 + int(with_energy)
                + term * b_lane * c_live + term * b_lane)
    return (float(torch.sum(per_lane * lane))
            + int(ok_m.sum()) * (52 + 4) + int(ok_n.sum()) * 26
            + 4.0 * bw * cw * float(torch.sum(l_live * ok_m)))


def multi_bound(pot, d, valid, s_slot, species, with_energy: bool,
                peak=PEAK_F32_FLOPS):
    """The least time the card needs for one multi-species pass on these
    rows: the flop of every ordered type's lanes (``type_flops``) over
    the ``peak`` rate (float32 by default), against the bytes over the
    memory rate: the rows,
    mask and species ids read once, the packed metadata, the outputs
    written once.  Returns (ms, "operations" or "bytes", flop, bytes)."""
    flop = sum(type_flops(pot, t, d, valid, s_slot, species, with_energy)
               for t in range(len(pot.trio_multi.descs)))
    size = d.element_size()
    n_atoms, k = d.shape[:2]
    n_bytes = (size * (n_atoms * k * 4 + n_atoms * (4 + 5 * k))
               + 8 * (n_atoms * k + n_atoms)
               + sum(b.numel() * b.element_size()
                     for b in pot.trio_packed.buffers()))
    t_flop, t_bytes = flop / peak, n_bytes / PEAK_BYTES
    return (1e3 * max(t_flop, t_bytes),
            "operations" if t_flop >= t_bytes else "bytes", flop, n_bytes)


def compare_multi(name, system64: MDSystem, state, geom):
    """The multi-species trio kernel against its plain version
    (``trio_multi_partials_all_torch``) on the engine's 3-body rows of
    ``state``, through the route's wrapper ``trio_multi_partials_all``:
    every output and the assembled forces, float64 within 1e-10 and
    float32 within 2e-4 eV/A of the float64 version, with and without
    energy; the virial from the partials (f64 1e-9 relative, f32 stress
    1e-5 eV/A^3); one launch per call.  Then float32 times without
    energy, as the MD steps run it: the launch by graph replay, the
    wrapper's host time, the plain version by CUDA events; the bound;
    the launch plans.  Returns the kernel record."""
    pot64 = system64.potential
    pot32 = copy.deepcopy(pot64).to(dtype=torch.float32)
    _, cache = system64.list_caches(state.nbr2, state.nbr3, state.cell)
    nbr = state.nbr3
    d64 = nb.cached_displacements(state.positions, nbr, cache)
    v64, s_slot, species = cache.valid, cache.s_slot, system64.species
    d32, v32 = d64.float(), v64.float()
    k = d64.shape[1]
    n_types = len(pot64.trio_multi.descs)
    err64 = err32 = 0.0
    counted = True
    for with_energy in (True, False):
        plain = multi.trio_multi_partials_all_torch(pot64, d64, v64, s_slot,
                                                    species, with_energy)
        f_plain = trio.assemble_forces(*plain, d64, cache.rev_flat,
                                       nbr.mask)[1]
        launches = multi.trio_multi_partials_all.launches
        k64 = multi.trio_multi_partials_all(pot64, d64, v64, s_slot, species,
                                            with_energy)
        k32 = multi.trio_multi_partials_all(pot32, d32, v32, s_slot, species,
                                            with_energy)
        torch.cuda.synchronize()
        counted = counted and (multi.trio_multi_partials_all.launches
                               == launches + 2)
        err64 = max(err64, max(max_err(a, b) for a, b in zip(k64, plain)))
        err32 = max(err32, max(max_err(a, b) for a, b in zip(k32, plain)))
        for out, dd, tol in ((k64, d64, "64"), (k32, d32, "32")):
            f = trio.assemble_forces(*out, dd, cache.rev_flat, nbr.mask)[1]
            if tol == "64":
                err64 = max(err64, max_err(f, f_plain))
            else:
                err32 = max(err32, max_err(f, f_plain))
        if not with_energy:
            compare_virial(geom, k, (plain[2], d64, v64),
                           (k64[2], d64, v64), (k32[2], d32, v32))
    print(f"multi trio {name}: N={len(species)} K={k}, {n_types} ordered "
          f"types: f64 max err {err64:.3e} (<= {F64_TOL:g}), f32 max err "
          f"{err32:.3e} (<= {FORCE_TOL:g}), one launch per call: {counted}")
    if not (err64 <= F64_TOL and err32 <= FORCE_TOL and counted):
        raise AssertionError("multi-species trio kernel disagrees with its "
                             "plain version")
    args = (pot32, d32, v32, s_slot, species, False)
    ms = graph_ms(lambda: multi.trio_multi_partials_all(*args))
    wrapper_ms = host_ms(lambda: multi.trio_multi_partials_all(*args))
    plain_ms = cuda_ms(lambda: multi.trio_multi_partials_all_torch(*args), 3)
    bound_ms, bound_by, flop, n_bytes = multi_bound(pot32, d32, v32, s_slot,
                                                    species, False)
    plans = {f"{'f64' if f64 else 'f32'} KMAX={kmax}":
             multi.trio_multi_occupancy(pot64, kmax, f64, n_atoms=len(species))
             for f64 in (False, True) for kmax in (16, 32)}
    used = multi.trio_multi_occupancy(pot32, k, False, n_atoms=len(species))
    share = 100 * bound_ms / ms
    card = card_line()
    print(f"multi trio {name}: f32 pass {ms:.4f} ms (graph replay); "
          f"wrapper {wrapper_ms:.4f} ms per call on the host; plain version "
          f"{plain_ms:.4f} ms (eager); bound {flop:.4g} flop, {n_bytes:.4g} "
          f"bytes -> {bound_ms:.5f} ms ({bound_by}), {share:.1f}% of it; "
          f"card: {card}")
    brief = {key: (f"{p['registers']} regs, {p['atoms_per_block']} warps x "
                   f"{p['blocks_per_sm']} blocks/SM, {p['smem_bytes']} B "
                   f"shared, {p['local_bytes']} B local")
             for key, p in plans.items()}
    print(f"multi trio {name} launch plans (no energy, S = "
          f"{pot64.trio_multi_plan[0]}): {brief}; this call's (f32, K={k}): "
          f"{used}")
    if any(plan["local_bytes"] for plan in plans.values()):
        raise AssertionError(f"multi-species trio kernel spills: {plans}")
    return dict(max_abs_err=err32, max_abs_err_f64=err64, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, n_atoms=len(species), k=k,
                n_types=n_types, launches_per_call=1,
                wrapper_host_ms=wrapper_ms, flop=flop, bytes=n_bytes,
                registers=used["registers"],
                warps_per_sm=used["warps_per_sm"],
                smem_bytes=used["smem_bytes"], plans=plans)


def compare_ternary(device):
    """The multi-species trio kernel on a ternary cut: ``species23_model``
    over Ne/Ar/Xe (27 ordered trio types) on fcc at a = 5.4 A, 10^3 x 4
    = 4,000 atoms, species by a seeded draw, rattled 0.08 A, float64
    lists (``compare_multi``).  Returns the kernel record."""
    geom = common.ne_ar_xe()
    system64 = MDSystem(species23_model(("Ne", "Ar", "Xe")), geom,
                        dtype=torch.float64, device=device)
    assert system64._multi_route()
    assert len(system64.potential.trio_multi.descs) == 27
    state = system64.init_state()
    return compare_multi("ternary Ne/Ar/Xe, 4,000 atoms", system64, state,
                         geom)


MULTI_T = 10.0  # K, the fused multi-species path's Langevin target


def run_multi_route(device):
    """The fused multi-species route at full width: the random Ne/Xe
    2+3-body model on fcc at a = 5.4 A, 13^3 x 4 = 8,788 atoms, half Xe
    by a seeded draw, float32, 1 fs, Langevin at 10 K (144-step warm-up,
    3 x 720 steps), then 720 NVE steps (drift <= 1e-3 eV/atom).  Gates:
    f32 forces (2e-4 eV/A), energy and stress (1e-5 eV/A^3) against
    f64, one launch of the multi-species trio kernel per force call in
    both runs, the kernel against its plain version on the path's rows
    (``compare_multi``), the card against the CPU in f64 on a 500-atom
    cut.  Returns (kernel record, launches by run, atom-steps/s of the
    Langevin and NVE runs, stale)."""
    name = "binary Ne/Xe 2+3-body, fused multi-species route"
    model = species23_model()
    geom = ne_xe((13, 13, 13))
    run_kw = dict(dt_fs=1.0, thermostat="langevin", temperature=MULTI_T)
    calls = []
    system, state, launches, rate, temps, stale = run_path(
        name, device, {}, run_kw, t_init=MULTI_T, model=model, geom=geom,
        calls=calls)
    multi_launches = multi.trio_multi_partials_all.launches
    n_calls = len(calls)
    assert system._multi_route() and launches == 0
    check_path(name, system, state, launches, temps, split=False,
               model=model, geom=geom, t_target=None)
    system64 = MDSystem(model, geom, dtype=torch.float64, device=device,
                        capacity_2b=system.capacity_2b,
                        capacity_3b=system.capacity_3b)
    state64 = state._replace(positions=state.positions.double(),
                             cell=state.cell.double())
    d_stress = max_err(system.stress(state).double(),
                       system64.stress(state64))
    record = compare_multi("binary Ne/Xe, 8,788 atoms", system64, state64,
                           geom)
    e0 = float(state.energy) + system.kinetic_energy(state)
    del calls[:]
    reset_counts()
    state, seconds = drive(system, state, WINDOW_STEPS, dt_fs=1.0)
    nve_launches, nve_calls = multi.trio_multi_partials_all.launches, \
        len(calls)
    e1 = float(state.energy) + system.kinetic_energy(state)
    drift = abs(e1 - e0) / len(geom)
    nve_rate = len(geom) * WINDOW_STEPS / seconds
    print(f"{name}: {len(geom)} atoms, K2={state.nbr2.idx.shape[1]}, "
          f"K3={state.nbr3.idx.shape[1]}; Langevin {MULTI_T:g} K, T by "
          f"window {[round(t, 2) for t in temps]}; multi-species trio "
          f"launches {multi_launches} for {n_calls} force calls "
          f"(Langevin), {nve_launches} for {nve_calls} (NVE); f32 stress "
          f"max |d "
          f"sigma| {d_stress:.3e} eV/A^3; NVE {WINDOW_STEPS} steps, E_total "
          f"{e0:.6f} -> {e1:.6f} eV, drift {drift:.3e} eV/atom")
    gate(name, {
        f"f32 stress within {STRESS_TOL:g} eV/A^3 of f64":
            d_stress <= STRESS_TOL,
        "one multi-species trio launch per force call": multi_launches > 0
            and multi_launches == n_calls and nve_launches == nve_calls,
        f"NVE drift <= {BINARY_NVE_DRIFT:g} eV/atom":
            drift <= BINARY_NVE_DRIFT,
        "no overflow": not system.overflowed(state)})
    card_vs_cpu(name, model, ne_xe((5, 5, 5)), device, 6, 1.0)
    return record, dict(langevin=multi_launches, nve=nve_launches), rate, \
        nve_rate, stale


def count_syncs(system: MDSystem, state, n_steps, **run_kw):
    """Run ``n_steps`` with ``sync=False`` under
    ``torch.cuda.set_sync_debug_mode("warn")``; returns (state, host
    syncs by site, as ``common.sync_sites``)."""
    state, sites = common.count_syncs(lambda: system.run(
        state, n_steps=n_steps, sync=False, **run_kw))
    system.overflowed(state)  # reads what is still queued
    return state, sites


def run_static_rebuild(device):
    """Plain velocity Verlet at the engine's defaults (9,826 atoms,
    Langevin at 300 K) with ``static_rebuild=True``: a full rebuild
    every cycle, no decision.  Timed as ``run_path`` times the other
    paths, with ``check_path``'s gates; then the host syncs of 10 cycles
    (200 steps, ``run(sync=False)``), by function, against the adaptive
    schedule's on the same state.  Returns (launches, atom-steps/s,
    stale, {schedule: syncs per cycle})."""
    name = "plain Verlet, static_rebuild"
    system, state, launches, rate, temps, stale = run_path(
        name, device, dict(static_rebuild=True), LANGEVIN)
    branches = dict(system.rebuild_branches)
    check_path(name, system, state, launches, temps, split=False)
    per_cycle, by_function = {}, {}
    adaptive = MDSystem(MODEL, bench_geometry((17, 17, 17)),
                        dtype=torch.float32, device=device)
    for label, sys_ in (("static_rebuild", system), ("adaptive", adaptive)):
        _, sites = count_syncs(sys_, state, 200, **LANGEVIN)
        per_cycle[label] = sum(sites.values()) / 10
        by_function[label] = sites
        print(f"{name}: host syncs over 10 cycles, {label} schedule: "
              f"{sum(sites.values())} ({per_cycle[label]:g} per cycle), by "
              f"function {sites}")
    print(f"{name}: cycles by branch {branches}")
    gate(name, {"a full rebuild in every cycle": branches["keep"] == 0
                and branches["refilter"] == 0 and branches["full"] > 0,
                "no host sync from the rebuild decision":
                    "_rebuild_switch" not in by_function["static_rebuild"]
                    and "_rebuild_switch" in by_function["adaptive"]})
    return launches, rate, stale, per_cycle


def run_legacy_refilter(device):
    """The bench configuration (3-level r-RESPA 12/6/36, skins 1.2/0.5
    A, 9,826 atoms, Langevin at 300 K, launches of 10 cycles) with
    ``eager_refilter=False``: the 3-body list refiltered only once 0.4
    of its skin is used.  Rate, ``stale`` and the cycles by branch
    (keep / refilter / full).  Returns (launches, atom-steps/s, stale,
    branches)."""
    name = "3-level r-RESPA 12/6/36, eager_refilter=False"
    system, state, launches, rate, temps, stale = run_path(
        name, device, dict(BENCH, eager_refilter=False),
        dict(LANGEVIN, launch_chunks=10))
    check_path(name, system, state, launches, temps, split=True)
    branches = dict(system.rebuild_branches)
    print(f"{name}: cycles by branch {branches}, stale={stale}")
    return launches, rate, stale, branches


def run_async_overflow(device):
    """The queued overflow check on the card.  200 steps (10 launches of
    20) at the engine's defaults, 9,826 atoms, with sync=False and then
    sync=True: how many flags were read without a wait, and the host
    syncs that ``torch.cuda.set_sync_debug_mode("warn")`` reports, by
    function; none may come from the overflow check.  Then the 54-atom
    cell squeezed 0.78x after init, in one launch with a spin kernel at
    its end standing in for a launch the card is still running: a
    sync=False run leaves its flag in flight and the next call raises,
    and ``overflowed`` reads a flag an asynchronous run left queued."""
    name = "queued overflow check"
    overflow_fns = {"run", "_poll_overflow", "_drain_pending", "_queue_flag",
                    "_flag_ready", "_flag_value", "overflowed"}
    reads = dict(waited=0, arrived=0)
    flag_value = md._flag_value

    def counted(entry):
        reads["arrived" if md._flag_ready(entry) else "waited"] += 1
        return flag_value(entry)

    system = MDSystem(MODEL, bench_geometry((17, 17, 17)),
                      dtype=torch.float32, device=device)
    state = system.init_state(temperature=T_TARGET, seed=0)
    results = {}
    md._flag_value = counted
    try:
        for sync in (False, True):
            reads.update(waited=0, arrived=0)
            state, sites = common.count_syncs(lambda: system.run(
                state, n_steps=200, sync=sync, **LANGEVIN))
            in_flight = len(system._pending_overflow)
            run_reads = dict(reads)
            system.overflowed(state)  # reads what is still queued
            results[sync] = (run_reads, in_flight, sites)
            print(f"{name}: run(sync={sync}) over 10 launches: flags read "
                  f"on arrival {run_reads['arrived']}, waited for "
                  f"{run_reads['waited']}, left in flight {in_flight}; host "
                  f"syncs by function {sites}")
    finally:
        md._flag_value = flag_value

    def squeezed():
        small = MDSystem(MODEL, bench_geometry((3, 3, 3)),
                         dtype=torch.float64, device=device,
                         rebuild_every=1, skin=0.4)
        st = small.init_state(temperature=10.0, seed=3)
        center = torch.mean(st.positions, dim=0)
        launch = small._run_chunk

        def busy_launch(*args, **kwargs):
            out = launch(*args, **kwargs)
            torch.cuda._sleep(50_000_000)
            return out
        small._run_chunk = busy_launch
        return small, st._replace(
            positions=center + 0.78 * (st.positions - center))

    small, st = squeezed()
    raised_in = None
    try:
        out = small.run(st, n_steps=1, dt_fs=0.1, sync=False)
        queued = len(small._pending_overflow)
        try:
            small.run(out, n_steps=2, dt_fs=0.1)
        except RuntimeError as err:
            raised_in = "the next call" if "capacity exceeded" in str(err) \
                else None
    except RuntimeError as err:
        queued = 0
        raised_in = "the same call" if "capacity exceeded" in str(err) \
            else None
    small, st = squeezed()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = small.run(st, n_steps=1, dt_fs=0.1, sync=False,
                        on_overflow="warn", check_every=10**6)
    warned = any("capacity exceeded" in str(w.message) for w in caught)
    left = len(small._pending_overflow)
    seen = small.overflowed(out)
    print(f"{name}: squeezed cell, sync=False left {queued} flags in flight "
          f"and raised in {raised_in}; with 'warn', {left} flags left in "
          f"flight, warned during the run {warned}, overflowed() {seen}")
    no_waits, _, sites = results[False]
    gate(name, {
        "sync=False waits for no flag": no_waits["waited"] == 0
            and no_waits["arrived"] + results[False][1] == 10,
        "the overflow check makes no host sync": not any(
            fn in overflow_fns for fn in list(sites)
            + list(results[True][2])),
        "the squeezed cell raises at the next call": raised_in
            == "the next call",
        "overflowed reads a queued flag": seen and left > 0 and not warned})


# -- the calculator on the card (ROADMAP.md item 4): single points,
# FIRE, batch relaxation, elastic constants, phonons, checkpoints,
# trajectories and the LAMMPS export
CALC_CUT = (6, 6, 6)    # 432 atoms: the card against the CPU in f64
FIRE_FMAX, FIRE_STEPS = 0.05, 500
CALL_REPEATS = 20       # timed get_forces calls per calculator
ELASTIC_TOL, PHONON_TOL = 1e-6, 1e-6   # GPa, THz: card vs CPU, f64
MULTI_CPU_TOL = 1e-9    # the multi-species route, card vs CPU, f64


def shifted(geom, dx=0.01):
    """A rigid translation of ``geom``: the same forces, another
    structure for the calculator's cache."""
    out = geom.copy()
    out.set_positions(geom.positions + dx)
    return out


def calc_call_times(calc, geom, kernel_counter):
    """Host ms per ``get_forces`` call on the card (alternating ``geom``
    and a translated copy, so that no call reuses the last result; each
    call ends with its result on the host), the kernel launches per call
    over those calls, and the device busy ms per call."""
    pair = (geom, shifted(geom))
    calc.get_forces(pair[1])
    torch.cuda.synchronize()
    before = kernel_counter.launches
    t0 = time.perf_counter()
    for i in range(CALL_REPEATS):
        calc.get_forces(pair[i % 2])
    host = 1e3 * (time.perf_counter() - t0) / CALL_REPEATS
    per_call = (kernel_counter.launches - before) / CALL_REPEATS
    turn = itertools.count()
    device = profiled_device_ms(
        lambda: calc.get_forces(pair[next(turn) % 2]))
    return host, per_call, device


def calculator_kernel_f64(calc, geom):
    """The trio kernel's float64 instance on the calculator's 3-body
    rows of ``geom`` (with energy, as the calculator calls it): error
    against its plain version, time by graph replay, the plain version's
    time, the float64 bound and the launch plan."""
    system, pot = calc.system, calc.potential
    cell = torch.as_tensor(geom.get_cell(), dtype=torch.float64,
                           device=calc.device)
    x = system._wrap(torch.as_tensor(geom.get_positions(),
                                     dtype=torch.float64,
                                     device=calc.device), cell)
    _, nbr3 = system.build_lists(x, cell)
    cache3 = nb.list_cache(nbr3, cell, torch.float64)
    d, valid = nb.cached_displacements(x, nbr3, cache3), cache3.valid
    kernel = trio.trio_partials(pot, d, valid, True)
    plain = trio.trio_partials_torch(d, valid, pot.grid, pot.trio, True)
    torch.cuda.synchronize()
    err = max(max_err(a, b) for a, b in zip(kernel, plain))
    ms = graph_ms(lambda: trio.trio_partials(pot, d, valid, True))
    plain_ms = cuda_ms(lambda: trio.trio_partials_torch(
        d, valid, pot.grid, pot.trio, True), 3)
    bound_ms, bound_by, flop, n_bytes = trio_bound(pot, d, valid, True,
                                                   peak=PEAK_F64_FLOPS)
    occ = trio.trio_occupancy(pot, d.shape[1], True, n_atoms=len(geom))
    print(f"trio f64 with energy, calculator rows (N={len(geom)}, K="
          f"{d.shape[1]}): {ms:.4f} ms; plan "
          f"{plan_line(occ)}; card: {card_line()}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, flop=flop,
                bytes=n_bytes, n_atoms=len(geom), k=d.shape[1],
                with_energy=True, registers=occ["registers"],
                warps_per_sm=occ["warps_per_sm"])


def run_calculator(device):
    """``UFCalculator`` at the bench model's full width: bcc W 17^3 =
    9,826 atoms rattled 0.05 A, in float64 (the default) and float32 on
    the card.  Gates: f32 against f64 (forces 2e-4 eV/A, energy 1e-6
    relative, stress 1e-5 eV/A^3), one trio launch per force call, the
    card against the CPU's plain versions in f64 on a 432-atom cut
    (1e-10).  Prints host and device ms per ``get_forces`` call (a full
    list build at the call's positions and the force).  Returns
    (the f64 calculator, the geometry, launches by path, the f64
    kernel record, times)."""
    geom = bench_geometry((17, 17, 17), rattle=0.05)
    results, launches, times = {}, {}, {}
    for dtype in (torch.float64, torch.float32):
        tag = "f64" if dtype == torch.float64 else "f32"
        reset_counts()
        t0 = time.perf_counter()
        calc = UFCalculator(MODEL, dtype=dtype, device=device)
        energy = calc.get_potential_energy(geom)
        forces = calc.get_forces(geom)
        stress = calc.get_stress(geom)
        first_s = time.perf_counter() - t0
        host, per_call, dev = calc_call_times(calc, geom, trio.trio_partials)
        launches[f"calculator {tag}, 9,826 atoms"] = \
            trio.trio_partials.launches
        results[tag] = (calc, energy, forces, stress, per_call)
        times[tag] = (host, dev)
        print(f"calculator {tag}: {len(geom)} atoms, E = {energy:.9f} eV, "
              f"capacities {calc.system.capacity_2b}/"
              f"{calc.system.capacity_3b}; first call (set-up, energy, "
              f"forces, stress) {first_s:.2f} s; get_forces "
              f"{host:.4f} ms per call on the host, device busy "
              f"{dev:.4f} ms, {per_call:g} trio launches per call; card: "
              f"{card_line()}")
    calc64, e64, f64, s64, calls64 = results["f64"]
    _, e32, f32, s32, calls32 = results["f32"]
    cut = bench_geometry(CALC_CUT, rattle=0.05)
    cpu = UFCalculator(MODEL, device="cpu")
    card_cut = UFCalculator(MODEL, device=device)
    cut_err = max(abs(cpu.get_potential_energy(cut)
                      - card_cut.get_potential_energy(cut)),
                  np.abs(cpu.get_forces(cut) - card_cut.get_forces(cut)).max(),
                  np.abs(cpu.get_stress(cut) - card_cut.get_stress(cut)).max())
    d_f, d_s = np.abs(f32 - f64).max(), np.abs(s32 - s64).max()
    d_e = abs(e32 - e64) / abs(e64)
    print(f"calculator: f32 vs f64 max |dF| {d_f:.3e} eV/A, |dE|/|E| "
          f"{d_e:.3e}, max |d sigma| {d_s:.3e} eV/A^3; card vs CPU f64 on "
          f"{len(cut)} atoms {cut_err:.3e}; stress f64 "
          f"{[round(float(x), 8) for x in s64]} eV/A^3")
    gate("calculator", {
        f"f32 forces within {FORCE_TOL:g} eV/A of f64": d_f <= FORCE_TOL,
        "f32 energy within 1e-6 of f64": d_e <= 1e-6,
        f"f32 stress within {STRESS_TOL:g} eV/A^3 of f64": d_s <= STRESS_TOL,
        "one trio launch per force call": calls64 == calls32 == 1,
        f"card vs CPU f64 within {F64_TOL:g}": cut_err <= F64_TOL,
        "finite": bool(np.isfinite(f64).all() and np.isfinite(s64).all())})
    kernel = calculator_kernel_f64(calc64, geom)
    print(f"trio f64 at the calculator's rows (N={kernel['n_atoms']}, "
          f"K={kernel['k']}, with energy): {kernel['ms']:.4f} ms (graph "
          f"replay), plain {kernel['plain_ms']:.4f} ms; bound "
          f"{kernel['flop']:.4g} flop / {PEAK_F64_FLOPS:.3g} flop/s, "
          f"{kernel['bytes']:.4g} bytes -> {kernel['bound_ms']:.5f} ms "
          f"({kernel['bound_by']}), "
          f"{100 * kernel['bound_ms'] / kernel['ms']:.1f}% of it; max err "
          f"{kernel['max_abs_err']:.3e}; {kernel['registers']} registers, "
          f"{kernel['warps_per_sm']} warps/SM; card: {card_line()}")
    if not kernel["max_abs_err"] <= F64_TOL:
        raise AssertionError("trio f64 kernel disagrees with its plain "
                             "version at the calculator's rows")
    return calc64, geom, launches, kernel, times


def run_fire(calc, geom):
    """FIRE relaxation of the rattled 9,826-atom cell in float64 on the
    card to fmax 0.05 eV/A.  Gates: converged within its step limit, the
    energy fell.  Returns (force calls = trio launches, seconds)."""
    e0 = calc.get_potential_energy(geom)
    reset_counts()
    t0 = time.perf_counter()
    relaxed = calc.relax_fmax(geom, fmax=FIRE_FMAX, steps=FIRE_STEPS)
    seconds = time.perf_counter() - t0
    calls = trio.trio_partials.launches
    fmax = float(np.linalg.norm(calc.get_forces(relaxed), axis=1).max())
    e1 = calc.get_potential_energy(relaxed)
    print(f"FIRE, {len(geom)} atoms, f64: {calls} force calls in "
          f"{seconds:.3f} s ({1e3 * seconds / calls:.3f} ms per call), "
          f"fmax {fmax:.4f} eV/A, E {e0:.6f} -> {e1:.6f} eV; card: "
          f"{card_line()}")
    gate("FIRE", {f"fmax < {FIRE_FMAX:g} within {FIRE_STEPS} steps":
                  fmax < FIRE_FMAX and calls < FIRE_STEPS,
                  "energy fell": e1 < e0})
    return calls, seconds


def run_batch_relax(device):
    """``batch_relax`` on the random Ne/Xe 2+3-body model over
    structures of other sizes and species counts, rattled 0.05 A: Ne/Xe
    fcc 3^3 x 4 (108 atoms), Xe fcc 3^3 x 4 (108), Ne/Xe 4^3 x 4 (256);
    the cached system is replaced at each entry.  Gates: every entry
    relaxed below fmax, energies fell, one system per entry, the
    multi-species kernel launched.  Returns its launches."""
    calc = UFCalculator(species23_model(), device=device)
    entries = [ne_xe((3, 3, 3)), bulk("Xe", "fcc", a=5.4) * 3,
               ne_xe((4, 4, 4))]
    for geom in entries:
        geom.rattle(0.05, seed=2)
    e0 = [calc.get_potential_energy(g) for g in entries]
    systems = []
    inner = calc._system_for

    def tracked(atoms):
        system = inner(atoms)
        if not systems or systems[-1] is not system:
            systems.append(system)
        return system
    calc._system_for = tracked
    reset_counts()
    t0 = time.perf_counter()
    relaxed, energies, forces = batch.batch_relax(entries, calc,
                                                  fmax=FIRE_FMAX)
    seconds = time.perf_counter() - t0
    launches = multi.trio_multi_partials_all.launches
    fmax = [float(np.linalg.norm(f, axis=1).max()) for f in forces]
    print(f"batch_relax, {[len(g) for g in entries]} atoms: {seconds:.2f} "
          f"s, {launches} multi-species trio launches, fmax {fmax}, E "
          f"{[round(e, 4) for e in e0]} -> {[round(e, 4) for e in energies]}"
          f" eV, {len(systems)} systems; card: {card_line()}")
    gate("batch_relax", {
        "every entry relaxed": len(relaxed) == len(entries)
            and max(fmax) < FIRE_FMAX,
        "energies fell": all(b < a for a, b in zip(e0, energies)),
        "the cached system replaced at each entry":
            len(systems) == len(entries),
        "multi-species trio kernel launched": launches > 0})
    return launches


def run_properties(device):
    """Elastic constants of bcc W 3^3 and phonons of bcc W (n_super=3,
    n_points=8) in float64 on the card, against the physical windows of
    ``tests/test_properties.py`` and the CPU (1e-6 GPa, 1e-6 THz).
    Returns launches by path."""
    launches = {}
    out = []
    for dev in (device, "cpu"):
        calc = UFCalculator(MODEL, device=dev)
        reset_counts()
        t0 = time.perf_counter()
        res = elastic.get_elastic_constants(bench_geometry((3, 3, 3)), calc)
        t1 = time.perf_counter()
        n_elastic = trio.trio_partials.launches
        ph = phonon.compute_phonon_data(bench_geometry((1, 1, 1)), calc,
                                        n_super=3, n_points=8)
        t2 = time.perf_counter()
        out.append((res, np.asarray(ph["frequencies"]), t1 - t0, t2 - t1))
        if len(out) == 1:
            launches["elastic constants, 54 atoms"] = n_elastic
            launches["phonons, 54-atom supercell"] = \
                trio.trio_partials.launches - n_elastic
    (res, freq, t_el, t_ph), (res_cpu, freq_cpu, _, _) = out
    d_c = float(np.abs(res["elastic_tensor"]
                       - res_cpu["elastic_tensor"]).max())
    d_nu = float(np.abs(freq - freq_cpu).max())
    tensor = np.asarray(res["elastic_tensor"])
    print(f"elastic constants (card, f64): C11 {res['C11']:.4f}, C12 "
          f"{res['C12']:.4f}, C44 {res['C44']:.4f}, B "
          f"{res['bulk_modulus']:.4f} GPa in {t_el:.2f} s; card vs CPU "
          f"{d_c:.3e} GPa; phonons: max {freq.max():.4f} THz, min "
          f"{freq.min():.4f} in {t_ph:.2f} s, card vs CPU {d_nu:.3e} THz; "
          f"launches {launches}")
    gate("elastic constants and phonons", {
        "C11, C12, C44, B in the windows of tests/test_properties.py":
            450 < res["C11"] < 620 and 120 < res["C12"] < 260
            and 80 < res["C44"] < 220 and 250 < res["bulk_modulus"] < 360,
        "cubic symmetry": bool(np.allclose(tensor, tensor.T, atol=5.0)),
        f"elastic card vs CPU within {ELASTIC_TOL:g} GPa":
            d_c <= ELASTIC_TOL,
        "phonon max in 5-7.5 THz, none below -0.05, acoustic at Gamma":
            5.0 < freq.max() < 7.5 and freq.min() > -0.05
            and bool(np.all(np.sort(np.abs(freq[0]))[:3] < 0.05)),
        f"phonons card vs CPU within {PHONON_TOL:g} THz": d_nu <= PHONON_TOL,
        "trio kernel launched": min(launches.values()) > 0})
    return launches


def calculator_multi_f64(calc, geom):
    """The multi-species kernel's float64 instance on the calculator's
    3-body rows of ``geom`` (with energy): error against its plain
    version, time by graph replay, the float64 bound."""
    pot = calc.potential
    d, valid, s_slot, species = common.calculator_rows(calc, geom)[:4]
    args = (pot, d, valid, s_slot, species, True)
    kernel = multi.trio_multi_partials_all(*args)
    plain = multi.trio_multi_partials_all_torch(*args)
    torch.cuda.synchronize()
    err = max(max_err(a, b) for a, b in zip(kernel, plain))
    ms = graph_ms(lambda: multi.trio_multi_partials_all(*args))
    plain_ms = cuda_ms(lambda: multi.trio_multi_partials_all_torch(*args), 3)
    bound_ms, bound_by, flop, n_bytes = multi_bound(
        pot, d, valid, s_slot, species, True, peak=PEAK_F64_FLOPS)
    plan = multi.trio_multi_occupancy(pot, d.shape[1], True, True,
                                      n_atoms=len(geom))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, flop=flop,
                bytes=n_bytes, n_atoms=len(geom), k=d.shape[1],
                with_energy=True, registers=plan["registers"],
                warps_per_sm=plan["warps_per_sm"])


def run_calculator_multi(device):
    """``UFCalculator`` on the fused multi-species route: the random
    Ne/Xe 2+3-body model on 8,788 atoms, f64.  Gates: one multi-species
    trio launch per force call, the card against the CPU on a 500-atom
    cut within 1e-9.  Returns (launches, the f64 kernel record, host and
    device ms per call)."""
    model = species23_model()
    geom = ne_xe((13, 13, 13))
    geom.rattle(0.05, seed=5)
    reset_counts()
    calc = UFCalculator(model, device=device)
    energy = calc.get_potential_energy(geom)
    stress = calc.get_stress(geom)
    host, per_call, dev = calc_call_times(calc, geom,
                                          multi.trio_multi_partials_all)
    launches = multi.trio_multi_partials_all.launches
    cut = ne_xe((5, 5, 5))
    cut.rattle(0.05, seed=5)
    cpu = UFCalculator(model, device="cpu")
    card_cut = UFCalculator(model, device=device)
    cut_err = max(abs(cpu.get_potential_energy(cut)
                      - card_cut.get_potential_energy(cut)),
                  np.abs(cpu.get_forces(cut) - card_cut.get_forces(cut)).max(),
                  np.abs(cpu.get_stress(cut) - card_cut.get_stress(cut)).max())
    print(f"calculator, multi-species route: {len(geom)} atoms f64, E = "
          f"{energy:.9f} eV, stress {[round(float(x), 8) for x in stress]}; "
          f"get_forces {host:.4f} ms per call on the host, device busy "
          f"{dev:.4f} ms, {per_call:g} multi-species trio launches per call; "
          f"card vs "
          f"CPU f64 on {len(cut)} atoms {cut_err:.3e}; card: {card_line()}")
    gate("calculator, multi-species route", {
        "one multi-species trio launch per force call": per_call == 1,
        f"card vs CPU f64 within {MULTI_CPU_TOL:g}": cut_err <= MULTI_CPU_TOL,
        "the fused multi-species route": calc.system._multi_route()})
    kernel = calculator_multi_f64(calc, geom)
    print(f"trio_multi f64 at the calculator's rows (N={kernel['n_atoms']}, "
          f"K={kernel['k']}, with energy): {kernel['ms']:.4f} ms (graph "
          f"replay), plain {kernel['plain_ms']:.4f} ms; bound "
          f"{kernel['flop']:.4g} flop / {PEAK_F64_FLOPS:.3g} flop/s, "
          f"{kernel['bytes']:.4g} bytes -> {kernel['bound_ms']:.5f} ms "
          f"({kernel['bound_by']}), "
          f"{100 * kernel['bound_ms'] / kernel['ms']:.1f}% of it; max err "
          f"{kernel['max_abs_err']:.3e}; card: {card_line()}")
    if not kernel["max_abs_err"] <= F64_TOL:
        raise AssertionError("trio_multi f64 kernel disagrees with its plain "
                             "version at the calculator's rows")
    return launches, kernel, (host, dev)


def run_checkpoint(device):
    """A checkpoint round trip on the card: plain Verlet under Langevin
    at 300 K on 9,826 atoms (f32, ``static_rebuild``: each cycle starts
    from a full build, as after a load), 40 steps, saved; 40 more
    steps uninterrupted, and 40 from the loaded checkpoint.  Gate: the
    two continuations agree bitwise (no atomics on this path), noise
    generator included.  Returns the trio launches."""
    system = MDSystem(MODEL, bench_geometry((17, 17, 17)),
                      dtype=torch.float32, static_rebuild=True,
                      device=device)
    reset_counts()
    state = system.init_state(temperature=T_TARGET, seed=0)
    state = system.run(state, n_steps=40, **LANGEVIN)
    path = os.path.join(tempfile.mkdtemp(), "checkpoint.npz")
    batch.save_md_checkpoint(path, state)
    straight = system.run(state, n_steps=40, **LANGEVIN)
    resumed = system.run(batch.load_md_checkpoint(path, system),
                         n_steps=40, **LANGEVIN)
    torch.cuda.synchronize()
    launches = trio.trio_partials.launches
    shutil.rmtree(os.path.dirname(path))
    diffs = {name: max_err(getattr(straight, name), getattr(resumed, name))
             for name in ("positions", "velocities", "forces", "energy")}
    same = all(torch.equal(getattr(straight, name), getattr(resumed, name))
               for name in diffs) and torch.equal(
        straight.generator.get_state(), resumed.generator.get_state())
    print(f"checkpoint on the card: continuation vs uninterrupted, max "
          f"|d| {diffs}, bitwise {same}; {launches} trio launches")
    gate("checkpoint", {"bitwise continuation": same,
                        "trio kernel launched": launches > 0})
    return launches


def run_md_traj():
    """``python -m uf3_tpu_torch md --traj`` at its defaults (2,000
    atoms, 1,000 steps, a launch every 20): one frame per launch, each
    parsed back with 2,000 atoms, the last at the printed energy."""
    tmp = tempfile.mkdtemp()
    path = os.path.join(tmp, "md.xyz")
    rate, energy = run_md_command("model_2and3.json", "--traj", path)
    frames = data_io.read_xyz(path)
    size = os.path.getsize(path)
    shutil.rmtree(tmp)
    launches = 1000 // 20
    print(f"md --traj: {len(frames)} frames ({size} bytes) for {launches} "
          f"launches, last frame E {frames[-1].info['energy']:.6f} eV "
          f"(printed {energy:.3f})")
    gate("md --traj", {
        "one frame per launch": len(frames) == launches,
        "2,000 atoms per frame, forces": all(
            len(f) == 2000 and "fx" in f.arrays for f in frames),
        "last frame at the printed energy":
            abs(frames[-1].info["energy"] - energy) <= 1e-3})
    return rate


def run_export(calc, geom):
    """``python -m uf3_tpu_torch export`` of the bench model, read back
    (``model_from_uf3_pot_file``) into a calculator on the card: forces
    within 1e-10 eV/A of the original's in f64, energies without the
    1-body terms (the file format carries none) within 1e-10 relative.
    Returns the trio launches."""
    tmp = tempfile.mkdtemp()
    out = subprocess.run([sys.executable, "-m", "uf3_tpu_torch", "export",
                          MODEL, "--out", tmp], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        raise AssertionError(f"export failed:\n{out.stderr[-4000:]}")
    for line in out.stdout.strip().splitlines():
        print(f"export command: {line}")
    path = os.path.join(tmp, "W.uf3")
    model2 = lammps.model_from_uf3_pot_file(path)
    shutil.rmtree(tmp)
    reset_counts()
    calc2 = UFCalculator(model2, device=calc.device)
    f2, e2 = calc2.get_forces(geom), calc2.get_potential_energy(geom)
    launches = trio.trio_partials.launches
    d_f = float(np.abs(calc.get_forces(geom) - f2).max())
    e1 = calc.get_potential_energy(geom, force_consistent=True)
    d_e = abs(e1 - e2) / abs(e1)
    print(f"export round trip on the card, {len(geom)} atoms f64: max |dF| "
          f"{d_f:.3e} eV/A, |dE|/|E| {d_e:.3e} (no 1-body terms)")
    gate("export", {"forces within 1e-10 eV/A": d_f <= 1e-10,
                    "energy within 1e-10": d_e <= 1e-10,
                    "trio kernel launched": launches > 0})
    return launches


# -- the fit on the card (ROADMAP.md item 5): a training set of the
# tungsten set's size, labeled by the repo's W potential, featurized on
# the card, the Gram on the card, the solve on the host, the fitted
# model checked on a hold-out set and run
# (count, bcc W repetitions, one vacancy): 1,939 configurations, 150,924
# atoms, the size of the tungsten set behind examples/tungsten_fit.py
FIT_SET = ((339, 2, False), (800, 3, False), (700, 4, False),
           (100, 4, True))
FIT_STRAIN = 0.02               # isotropic, uniform in +-2%
FIT_RATTLE = (0.03, 0.15)       # A, rattle stdev uniform in this range
FIT_HOLDOUT = 0.2
# curvature 1e-12 on both (the ridge at its defaults): the 1e-8 of
# examples/tungsten_fit.py holds this teacher's curved pair core and
# 3-body grid 2.7e-2 eV/A away from it (PERF.md, CPU rehearsal)
FIT_REG = dict(c2=1e-12, c3=1e-12)
FIT_FEATURE_TOL = 1e-10         # card vs CPU, f64
# hold-out RMSE against the teacher's labels: the teacher lies in the
# fitted span, so the error is the regularizer's bias (CPU rehearsal at
# 56 configurations: 8.5e-5 eV/A, 9.1e-7 eV/atom; PERF.md)
FIT_FORCE_RMSE, FIT_ENERGY_RMSE = 5e-4, 1e-5    # eV/A, eV/atom
FIT_MD_STEPS = 720
FIT_CMD_CONFIGS = 50


def fit_training_set(seed, counts=FIT_SET):
    """bcc W cells (a = 3.1652 A), each isotropically strained within
    +-2% and rattled by a stdev in 0.03-0.15 A, drawn from ``seed``."""
    rng = np.random.RandomState(seed)
    geoms = []
    for count, reps, vacancy in counts:
        for _ in range(count):
            geom = bulk("W", "bcc", a=3.1652) * reps
            if vacancy:
                geom.delete([rng.randint(len(geom))])
            geom.set_cell(geom.get_cell() * (1.0 + rng.uniform(
                -FIT_STRAIN, FIT_STRAIN)), scale_atoms=True)
            geom.rattle(rng.uniform(*FIT_RATTLE),
                        seed=int(rng.randint(2 ** 31 - 1)))
            geoms.append(geom)
    return geoms


def label(calc, geoms):
    """The teacher's energies and forces of ``geoms``: one force call
    each (the forces come from the energy's call)."""
    energies, forces = [], []
    for geom in geoms:
        energies.append(calc.get_potential_energy(geom))
        forces.append(calc.get_forces(geom))
    return energies, forces


def busy_share(fn):
    """(wall ms, device busy ms) of one call of fn() under
    ``tracing.trace``: busy is the union of the device's operation
    intervals."""
    with tracing.trace() as rec:
        fn()
    return 1e3 * rec.wall_s, rec.busy_ms()


def labeled_frames(geoms, energies, forces):
    """Copies of ``geoms`` carrying their labels as extended-xyz writes
    them: the energy, and the forces where they are not None."""
    frames = []
    for geom, energy, force in zip(geoms, energies, forces):
        frame = geom.copy()
        frame.info["energy"] = energy
        if force is not None:
            for c, name in enumerate(("fx", "fy", "fz")):
                frame.arrays[name] = force[:, c]
        frames.append(frame)
    return frames


PARSE_REPEATS = 3


def compare_readers(path, name):
    """The native extended-xyz tokenizer against the Python reader on
    ``path``: every configuration's numbers, positions, cell, energy and
    forces bit-equal; both parse times, each the least of
    ``PARSE_REPEATS`` calls (the library built before)."""
    t0 = time.perf_counter()
    native.load()
    load_s = time.perf_counter() - t0
    times = {}
    for tag, reader in (("native", native.parse_extxyz_fast),
                        ("python", data_io.read_xyz_python)):
        best = float("inf")
        for _ in range(PARSE_REPEATS):
            t0 = time.perf_counter()
            frames = reader(path)
            best = min(best, time.perf_counter() - t0)
        times[tag] = (1e3 * best, frames)
    (native_ms, ours), (python_ms, ref) = times["native"], times["python"]
    fields = ("fx", "fy", "fz")
    same = len(ours) == len(ref) and all(
        np.array_equal(a.numbers, b.numbers)
        and np.array_equal(a.positions, b.positions)
        and np.array_equal(a.cell, b.cell)
        and a.info.get("energy") == b.info.get("energy")
        and all((c in a.arrays) == (c in b.arrays) for c in fields)
        and all(np.array_equal(a.arrays[c], b.arrays[c])
                for c in fields if c in b.arrays)
        for a, b in zip(ours, ref))
    atoms = sum(len(g) for g in ref)
    print(f"{name} extended-xyz parse of {os.path.basename(path)} "
          f"({len(ref)} configurations, {atoms} atoms, "
          f"{os.path.getsize(path)} bytes): native tokenizer "
          f"{native_ms:.3f} ms, Python reader {python_ms:.3f} ms "
          f"({python_ms / native_ms:.1f}x; library loaded or built in "
          f"{load_s:.3f} s); card: {card_line()}")
    gate(f"{name} native tokenizer", {
        "numbers, positions, cells, energies and forces bit-equal to the "
        "Python reader": same})


def run_example(name, *args, device="cuda"):
    """``python -m uf3_tpu_torch.examples.<name> args`` as a user runs it
    (``--cpu`` added when ``device`` is the CPU): exit 0; returns its
    standard output."""
    cmd = [sys.executable, "-m", f"uf3_tpu_torch.examples.{name}", *args]
    if torch.device(device).type == "cpu":
        cmd.append("--cpu")
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    for line in out.stdout.strip().splitlines():
        print(f"example {name}: {line}")
    print(f"example {name}: exit {out.returncode} after "
          f"{time.perf_counter() - t0:.2f} s")
    if out.returncode != 0:
        raise AssertionError(f"example {name} failed:\n{out.stderr[-4000:]}")
    return out.stdout


def run_commands(name, frames, settings, tmp, device, commands=(
        "featurize", "fit", "predict")):
    """``python -m uf3_tpu_torch featurize`` / ``fit`` / ``predict`` as
    a user runs them (on the card by default; with ``--device cpu`` when
    ``device`` is the CPU), on an extended-xyz file of ``frames`` in
    ``tmp``/data and the JSON ``settings`` (sources, features and model
    paths filled in here).  Returns (the model's path, the route the
    featurizer took, predict's energy and force RMSE or None)."""
    data_dir = os.path.join(tmp, "data")
    os.makedirs(data_dir)
    data_io.write_xyz(os.path.join(data_dir, "train.xyz"), frames)
    compare_readers(os.path.join(data_dir, "train.xyz"), name)
    path, model_path = command_settings(
        settings, tmp, {"sources": {"path": data_dir, "pattern": "*.xyz"}})
    route, rmse = run_cli(name, path, device, commands)
    return model_path, route, rmse


def command_settings(settings, tmp, data, features="features.npz"):
    """``settings`` with the ``data`` section ``data`` and the features
    (file name ``features``) and model paths in ``tmp``, written to
    ``tmp``/settings.json.  Returns (that path, the model's path)."""
    model_path = os.path.join(tmp, "fitted_cmd.json")
    features = os.path.join(tmp, features)
    settings = dict(settings, data=data,
                    features=dict(settings.get("features", {}),
                                  features_path=features),
                    model={"model_path": model_path},
                    learning=dict(settings.get("learning", {}),
                                  features_path=features))
    path = os.path.join(tmp, "settings.json")
    with open(path, "w") as f:
        json.dump(settings, f)
    return path, model_path


def run_cli(name, path, device, commands):
    """The fit ``commands`` of ``python -m uf3_tpu_torch`` on the
    settings file ``path``, one process each, as a user runs them.
    Returns (the route the featurizer took, predict's energy and force
    RMSE), None where not printed."""
    flags = [] if torch.device(device).type == "cuda" \
        else ["--device", "cpu"]
    route, rmse = None, None
    for command in commands:
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "uf3_tpu_torch",
                              command, path, *flags], cwd=REPO,
                             capture_output=True, text=True, timeout=600)
        for line in out.stdout.strip().splitlines():
            print(f"{name} {command} command: {line}")
            found = re.match(r"route: (.+?) \(", line)
            route = found.group(1) if found else route
            found = re.search(r"RMSE \(energy, eV/atom\): (\S+); RMSE "
                              r"\(forces, eV/A\): (\S+);", line)
            rmse = tuple(float(x) for x in found.groups()) if found \
                else rmse
        print(f"{name} {command} command: exit {out.returncode} after "
              f"{time.perf_counter() - t0:.2f} s")
        if out.returncode != 0:
            raise AssertionError(f"{name} {command} command failed:\n"
                                 f"{out.stderr[-4000:]}")
    return route, rmse


def run_tungsten_example(geoms, energies, forces, tmp, device):
    """The ``tungsten_fit`` example on an extended-xyz file of ``geoms``
    written with ``write_xyz``."""
    data = os.path.join(tmp, "example_data")
    os.makedirs(data)
    path = os.path.join(data, "train.xyz")
    data_io.write_xyz(path, labeled_frames(geoms, energies, forces))
    example = os.path.join(tmp, "tungsten_fit")
    out = run_example("tungsten_fit", path,
                      os.path.join(example, "features.h5"), "--out-dir",
                      example, device=device)
    found = re.search(r"force RMSE: (\S+) eV/A", out)
    gate("tungsten_fit example", {
        "force RMSE printed and finite":
            found is not None and np.isfinite(float(found.group(1))),
        "model written": os.path.isfile(
            os.path.join(example, "model_2and3_refit.json"))})


def run_fit(device, counts=FIT_SET, seed=0):
    """The fit on the card: a training set of ``counts`` (by default the
    tungsten set's size, 1,939 configurations), labeled with energies and
    forces by ``UFCalculator`` on the bench model in f64, split 80/20;
    ``featurize_batches`` on the card in the bench model's own basis, the
    Gram on the card (``gram_from_batches``), the solve on the host, the
    model written with ``to_json``, its hold-out RMSE against the labels
    through ``UFCalculator``, 720 steps of Langevin MD with it at 9,826
    atoms, and the ``tungsten_fit`` example on 50 configurations.  Gates:
    features card vs CPU within 1e-10 on one configuration per size,
    every configuration featurized once (redos counted), the hold-out
    RMSEs, the MD, the example.  Returns (the trio launches by step, the
    labeled set for ``run_data_pipeline``: geometries, energies, forces,
    the training and hold-out indices, the basis and the fitted
    coefficients)."""
    from uf3_tpu_torch.ops import featurize as feat
    from uf3_tpu_torch.regression import least_squares as ls
    card = card_line()
    geoms = fit_training_set(seed, counts)
    n_atoms_all = sum(len(g) for g in geoms)
    launches = {}
    teacher = UFCalculator(MODEL, device=device)
    reset_counts()
    t0 = time.perf_counter()
    energies, forces = label(teacher, geoms)
    torch.cuda.synchronize()
    launches["fit: labeling"] = trio.trio_partials.launches
    print(f"fit: {len(geoms)} configurations, {n_atoms_all} atoms, labeled "
          f"by UFCalculator (f64) in {time.perf_counter() - t0:.2f} s, "
          f"{launches['fit: labeling']} trio launches; card: {card}")
    order = np.random.RandomState(seed).permutation(len(geoms))
    n_test = int(round(FIT_HOLDOUT * len(geoms)))
    test, train = order[:n_test], np.sort(order[n_test:])
    basis = io.load_model(MODEL).bspline_config
    # the card against the CPU, one configuration per size
    firsts = np.cumsum([0] + [c for c, _, _ in counts])[:-1]
    feat_err = 0.0
    for i in firsts:
        card_e, card_f = feat.featurize_configuration_device(
            basis, geoms[i], device=device)
        cpu_e, cpu_f = feat.featurize_configuration_device(
            basis, geoms[i], device="cpu")
        feat_err = max(feat_err, np.abs(card_e - cpu_e).max(),
                       np.abs(card_f - cpu_f).max())
    print(f"fit: features card vs CPU on {len(firsts)} configurations "
          f"({[len(geoms[i]) for i in firsts]} atoms): max |d| "
          f"{feat_err:.3e}")
    tr_geoms = [geoms[i] for i in train]
    tr_e, tr_f = [energies[i] for i in train], [forces[i] for i in train]
    tr_atoms = sum(len(g) for g in tr_geoms)
    stats = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    batches = list(feat.featurize_batches(basis, tr_geoms, tr_e, tr_f,
                                          device=device, stats=stats))
    torch.cuda.synchronize()
    feat_s = time.perf_counter() - t0
    seen = sorted(i for b in batches for i in b.index)
    print(f"fit: featurized {len(tr_geoms)} configurations ({tr_atoms} "
          f"atoms) on the card in {feat_s:.3f} s: "
          f"{1e3 * feat_s / len(tr_geoms):.4f} ms per configuration, "
          f"{len(tr_geoms) / feat_s:.1f} configurations/s, "
          f"{tr_atoms / feat_s:.1f} atoms/s; {stats['calls']} calls, batch "
          f"sizes by atom count {stats['batch_sizes']}, redos "
          f"{stats['redos']}, peak memory "
          f"{stats['peak_bytes'] / 2 ** 30:.3f} GiB; card: {card}")
    # the device's busy share over one bucket: a batch of 128-atom cells
    big = [g for g in tr_geoms if len(g) == 128]
    size = stats["batch_sizes"].get(128, 1)
    chunk = big[:size]
    wall_ms, busy_ms = busy_share(lambda: list(feat.featurize_batches(
        basis, chunk, [0.0] * len(chunk), [np.zeros((128, 3))] * len(chunk),
        device=device, batch_size=size)))
    print(f"fit: one bucket call, {len(chunk)} configurations of 128 atoms: "
          f"{wall_ms:.3f} ms wall, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%); card: {card}")
    model = ls.WeightedLinearModel(basis, device=device, **FIT_REG)
    e_var, f_var = ls.VarianceRecorder(), ls.VarianceRecorder()
    rows = [(b.x_e, b.y_e, b.x_f, b.y_f) for b in batches]
    t0 = time.perf_counter()
    grams = model.gram_from_batches(rows, e_var, f_var)
    torch.cuda.synchronize()
    gram_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    model.gram_from_batches(rows)   # again, without the targets' copies
    torch.cuda.synchronize()
    gram_again_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    weights = ls.calc_E_F_weights(e_var.n, f_var.n, e_var.std, f_var.std)
    model.fit_with_gram(*model.combine_weighted_gram(*grams, *weights, 0.5))
    solve_ms = 1e3 * (time.perf_counter() - t0)
    print(f"fit: Gram on the card over {f_var.n + e_var.n} rows x "
          f"{model.n_feats} features in {len(rows)} batches "
          f"{gram_ms:.3f} ms (with the targets' variances; again "
          f"without them {gram_again_ms:.3f} ms), solve on the host "
          f"{solve_ms:.3f} ms; card: {card}")
    del batches, rows, grams
    tmp = tempfile.mkdtemp()
    fitted = os.path.join(tmp, "fitted.json")
    model.to_json(fitted)
    reset_counts()
    check = UFCalculator(fitted, device=device)
    te_e, te_f = label(check, [geoms[i] for i in test])
    launches["fit: hold-out check"] = trio.trio_partials.launches
    rmse_e = ls.rmse_metric(
        [e / len(geoms[i]) for e, i in zip(te_e, test)],
        [energies[i] / len(geoms[i]) for i in test])
    rmse_f = ls.rmse_metric(np.concatenate(te_f),
                            np.concatenate([forces[i] for i in test]))
    print(f"fit: hold-out {len(test)} configurations: RMSE energy "
          f"{rmse_e:.4e} eV/atom, forces {rmse_f:.4e} eV/A against the "
          f"teacher; {launches['fit: hold-out check']} trio launches")
    reset_counts()
    system = MDSystem(fitted, bench_geometry((17, 17, 17)),
                      dtype=torch.float32, device=device)
    state = system.init_state(temperature=T_TARGET)
    state = system.run(state, n_steps=FIT_MD_STEPS, dt_fs=2.0,
                       thermostat="langevin", temperature=T_TARGET)
    torch.cuda.synchronize()
    launches["fit: MD with the fitted model"] = trio.trio_partials.launches
    md_ok = not system.overflowed(state) and bool(
        torch.isfinite(state.positions).all()) and np.isfinite(
        float(state.energy))
    print(f"fit: MD with the fitted model, {17 ** 3 * 2} atoms, "
          f"{FIT_MD_STEPS} steps: T {system.temperature(state):.1f} K, E "
          f"{float(state.energy):.4f} eV; "
          f"{launches['fit: MD with the fitted model']} trio launches")
    cmd = train[:FIT_CMD_CONFIGS]
    run_tungsten_example([geoms[i] for i in cmd], [energies[i] for i in cmd],
                         [forces[i] for i in cmd], tmp, device)
    shutil.rmtree(tmp)
    gate("fit", {
        f"features card vs CPU within {FIT_FEATURE_TOL:g}":
            feat_err <= FIT_FEATURE_TOL,
        "every training configuration featurized once":
            seen == list(range(len(tr_geoms))),
        f"hold-out force RMSE <= {FIT_FORCE_RMSE:g} eV/A":
            rmse_f <= FIT_FORCE_RMSE,
        f"hold-out energy RMSE <= {FIT_ENERGY_RMSE:g} eV/atom":
            rmse_e <= FIT_ENERGY_RMSE,
        "fitted model's MD: no overflow, finite": md_ok,
        "trio kernel launched in the labeling and the check":
            launches["fit: labeling"] > 0
            and launches["fit: hold-out check"] > 0})
    return launches, dict(geoms=geoms, energies=energies, forces=forces,
                          train=train, test=test, basis=basis,
                          coefficients=model.coefficients.copy())


# -- the fit's data pipeline on the card (ROADMAP.md section 1 item 7):
# run_fit's labeled set written as extended-xyz under four source
# directories, read by the DataCoordinator, cached to an ase.db file and
# read back, filtered by force, featurized on the card into the .npz,
# fitted from the file on run_fit's training keys and predicted on its
# hold-out keys; then the commands on 50 configurations with a
# non-default energy key and a source directory whose INCAR holds PSTRESS
PIPE_SOURCES = 4
PIPE_FIT_TOL = 1e-8      # fitted energies and forces vs run_fit's, relative
PIPE_SHIFT_TOL = 1e-12   # each -P V shift, relative to the energy
PIPE_PSTRESS = -5.0      # kbar (its sign is what the reference's parse loses)
PIPE_DECOY = 3.0         # eV: the frames' "energy", beside their free_energy
PIPE_MD_STEPS = 100


def free_energy_source(path, frames):
    """``frames`` as extended-xyz at ``path`` with each energy E written
    as ``free_energy=E`` and a decoy ``energy=E + PIPE_DECOY``."""
    data_io.write_xyz(path, frames)
    with open(path) as f:
        lines = f.read().splitlines()
    with open(path, "w") as f:
        for line in lines:
            found = re.search(r"\benergy=(\S+)", line)
            if found:
                line = (line[:found.start()] + "free_energy="
                        + found.group(1) + line[found.end():]
                        + f" energy={float(found.group(1)) + PIPE_DECOY:.10f}")
            f.write(line + "\n")


def same_rows(geoms, dataset):
    """Whether ``geoms`` (read from the ase.db file) hold the dataset's
    configurations bit for bit: numbers, positions, cells, pbc, energies,
    forces and keys."""
    fields = ("fx", "fy", "fz")
    return len(geoms) == len(dataset) and all(
        np.array_equal(a.numbers, b.numbers)
        and np.array_equal(a.positions, b.positions)
        and np.array_equal(a.cell, b.cell) and np.array_equal(a.pbc, b.pbc)
        and a.info["energy"] == b.info["energy"]
        and a.info["row_name"] == key
        and all(np.array_equal(a.arrays[c], b.arrays[c]) for c in fields)
        for a, b, key in zip(geoms, dataset["geometry"], dataset.keys))


def run_data_pipeline(device, fit, keep=None):
    """The fit's data side on ``run_fit``'s labeled set (``fit``, as
    ``run_fit`` returns it; labeled once there): the configurations
    written as extended-xyz under four source directories, read through
    ``parse_with_subsampling`` into a ``DataCoordinator``,
    ``cache_data`` -> ``read_database`` (and the file read again as a
    source), ``filter_max_forces``, ``Featurizer.write_features`` on the
    card, ``fit_from_file`` on ``run_fit``'s training keys and
    ``batched_predict`` on its hold-out keys; then ``python -m
    uf3_tpu_torch featurize`` / ``fit`` / ``predict`` on 50 of them with
    ``data.keys.energy_key`` "free_energy" and ``data.vasp_pressure``,
    one of their two source directories holding an INCAR with PSTRESS,
    and ``md`` on their model (in this process, its trio launches
    counted).  ``keep``, a directory, receives the ``.npz``.  Returns
    (the ``md`` command's trio launches, for ``run_feature_store``: the
    dataset, its training and hold-out keys, the kept ``.npz`` and the
    seconds its ``write_features`` took)."""
    from uf3_tpu_torch import __main__ as cli
    from uf3_tpu_torch.ops import featurize as feat
    from uf3_tpu_torch.regression import least_squares as ls
    card = card_line()
    t_phase = time.perf_counter()
    seconds = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return out

    geoms, energies, forces = fit["geoms"], fit["energies"], fit["forces"]
    frames = labeled_frames(geoms, energies, forces)
    tmp = tempfile.mkdtemp()
    chunks = np.array_split(np.arange(len(frames)), PIPE_SOURCES)
    paths, key_of = [], {}
    for d, chunk in enumerate(chunks):
        os.makedirs(os.path.join(tmp, "data", f"src{d}"))
        paths.append(os.path.join(tmp, "data", f"src{d}", "train.xyz"))
        key_of.update({int(i): f"src{d}-train.xyz_{j}"
                       for j, i in enumerate(chunk)})
    timed("write", lambda: [data_io.write_xyz(path, [frames[i] for i in c])
                            for path, c in zip(paths, chunks)])
    compare_readers(paths[0], "data pipeline")
    coordinator = data_io.DataCoordinator()
    timed("parse", lambda: data_io.parse_with_subsampling(
        paths, coordinator, max_samples=-1))
    dataset = coordinator.consolidate()
    in_order = dataset.keys == [key_of[i] for i in range(len(frames))]
    db = os.path.join(tmp, "cache.db")
    timed("cache_data", lambda: data_io.cache_data(dataset, db))
    back = timed("read_database", lambda: data_io.read_database(db))
    db_keys, _ = data_io.read_sources([db])
    # the median of the largest per-atom forces, taken between two
    # configurations so the text's rounding cannot cross it
    largest = np.sort([np.linalg.norm(f, axis=1).max() for f in forces])
    cutoff = 0.5 * (largest[len(largest) // 2 - 1]
                    + largest[len(largest) // 2])
    host_kept = int(np.sum(largest <= cutoff))
    kept = timed("filter_max_forces", lambda: data_io.filter_max_forces(
        dataset, cutoff=cutoff))
    featurizer = feat.Featurizer(fit["basis"], device=device)
    npz = os.path.join(tmp, "features.npz")
    stats = {}
    timed("featurize", lambda: featurizer.write_features(npz, dataset,
                                                         stats=stats))
    train_keys = [key_of[int(i)] for i in fit["train"]]
    test_keys = [key_of[int(i)] for i in fit["test"]]
    model = ls.WeightedLinearModel(fit["basis"], device=device, **FIT_REG)
    timed("fit_from_file", lambda: model.fit_from_file(
        npz, subset=train_keys, weight=0.5))
    _, _, _, _, rmse_e, rmse_f = timed(
        "batched_predict", lambda: model.batched_predict(npz,
                                                         keys=test_keys))
    x_e, _, x_f, _ = ls.feature_rows(npz, subset=test_keys)
    fit_err = {}
    for name, x in (("energies", x_e), ("forces", x_f)):
        want = x @ fit["coefficients"]
        fit_err[name] = float(np.abs(x @ model.coefficients - want).max()
                              / np.abs(want).max())
    n_atoms = sum(len(g) for g in geoms)
    print(f"data pipeline: {len(frames)} configurations ({n_atoms} atoms) "
          f"in {PIPE_SOURCES} extended-xyz sources; seconds "
          + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items())
          + f" (featurize: {stats['calls']} calls, {stats['redos']} "
          f"redos); card: {card}")
    print(f"data pipeline: ase.db {os.path.getsize(db)} bytes, "
          f"{len(back)} rows; filter at {cutoff:.6f} eV/A kept "
          f"{len(kept)} (host count {host_kept}); fit_from_file on "
          f"{len(train_keys)} training keys vs run_fit's fit, relative: "
          f"energies {fit_err['energies']:.3e}, forces "
          f"{fit_err['forces']:.3e}; batched_predict on {len(test_keys)} "
          f"hold-out keys: RMSE energy {rmse_e:.4e} eV/atom, forces "
          f"{rmse_f:.4e} eV/A")
    # the commands, on 50 training configurations in two sources
    cmd_dir = os.path.join(tmp, "commands")
    cmd = [int(i) for i in fit["train"][:FIT_CMD_CONFIGS]]
    half = len(cmd) // 2
    sources = {"plain": cmd[:half], "pressured": cmd[half:]}
    for name, idx in sources.items():
        os.makedirs(os.path.join(cmd_dir, "data", name))
        free_energy_source(os.path.join(cmd_dir, "data", name, "train.xyz"),
                           [frames[i] for i in idx])
    with open(os.path.join(cmd_dir, "data", "pressured", "INCAR"), "w") as f:
        f.write(f"PREC = Accurate\nPSTRESS = {PIPE_PSTRESS} ! kbar\n")
    settings = {
        "elements": ["W"], "degree": 3,
        # the bench model's basis
        "basis": {"r_min": {"W-W": 0.001, "W-W-W": [1.5, 1.5, 1.5]},
                  "r_max": {"W-W": 5.5, "W-W-W": [3.5, 3.5, 7.0]},
                  "resolution": {"W-W": 15, "W-W-W": [6, 6, 12]}},
        "learning": {"regularizer": {"curvature_2b": FIT_REG["c2"],
                                     "curvature_3b": FIT_REG["c3"]}}}
    settings_path, model_path = command_settings(settings, cmd_dir, {
        "sources": {"path": os.path.join(cmd_dir, "data"),
                    "pattern": "*.xyz"},
        "keys": {"energy_key": "free_energy"}, "vasp_pressure": True})
    t0 = time.perf_counter()
    _, rmse = run_cli("data pipeline", settings_path, device,
                      ("featurize", "fit", "predict"))
    seconds["commands"] = time.perf_counter() - t0
    pressure = PIPE_PSTRESS * 1e-22 / 1.602176634e-19
    with np.load(os.path.join(cmd_dir, "features.npz")) as data:
        rows = dict(zip(data["keys"].tolist(), data["y_e"] * data["sizes"]))
    # the energies the command read, and each shift, against a parse of
    # the same sources
    row_err, shift_err = 0.0, 0.0
    check = data_io.DataCoordinator.from_config({"energy_key":
                                                 "free_energy"})
    data_io.parse_with_subsampling(
        [os.path.join(cmd_dir, "data", name, "train.xyz")
         for name in sources], check, max_samples=-1, vasp_pressure=True)
    parsed = check.consolidate()
    for key, geom, corrected in zip(parsed.keys, parsed["geometry"],
                                    parsed["free_energy"]):
        free = geom.info["free_energy"]
        want = -pressure * geom.get_volume() \
            if key.startswith("pressured") else 0.0
        shift_err = max(shift_err,
                        abs((corrected - free) - want) / abs(free))
        row_err = max(row_err, abs(rows[key] - corrected) / abs(free))
    reset_counts()
    out = StringIO()
    with contextlib.redirect_stdout(out):
        t0 = time.perf_counter()
        cli.main(["md", model_path, "--steps", str(PIPE_MD_STEPS)]
                 + ([] if torch.device(device).type == "cuda"
                    else ["--device", "cpu"]))
        torch.cuda.synchronize()
    seconds["md command"] = time.perf_counter() - t0
    md_launches = trio.trio_partials.launches
    lines = out.getvalue().strip().splitlines()
    for line in lines:
        print(f"data pipeline md command: {line}")
    found = re.search(r"\(([-+.\deE]+) atom-steps/s\); T = (\S+) K, "
                      r"E = (\S+) eV", lines[-1] if lines else "")
    kept_npz = None
    if keep is not None:
        kept_npz = shutil.copy(npz, keep)
    shutil.rmtree(tmp)
    wall = time.perf_counter() - t_phase
    print(f"data pipeline: commands {seconds['commands']:.3f} s, md "
          f"command ({PIPE_MD_STEPS} steps, in process) "
          f"{seconds['md command']:.3f} s, {md_launches} trio launches; "
          f"energy rows vs E - P V {row_err:.3e}, shifts vs -P V "
          f"{shift_err:.3e} (relative to E; PSTRESS {PIPE_PSTRESS} kbar); "
          f"phase wall {wall:.3f} s; card: {card}")
    gate("data pipeline", {
        "keys in the sources' order": in_order,
        "ase.db round trip bit-equal": same_rows(back, dataset),
        "the .db read back as a source": len(db_keys) == len(dataset),
        "filter keeps the host's count": len(kept) == host_kept,
        f"fit_from_file vs run_fit's fit within {PIPE_FIT_TOL:g} relative":
            max(fit_err.values()) <= PIPE_FIT_TOL,
        f"hold-out force RMSE <= {FIT_FORCE_RMSE:g} eV/A":
            rmse_f <= FIT_FORCE_RMSE,
        f"hold-out energy RMSE <= {FIT_ENERGY_RMSE:g} eV/atom":
            rmse_e <= FIT_ENERGY_RMSE,
        f"each shift -P V within {PIPE_SHIFT_TOL:g}":
            shift_err <= PIPE_SHIFT_TOL,
        f"the featurize command's energy rows E - P V within "
        f"{PIPE_SHIFT_TOL:g}": row_err <= PIPE_SHIFT_TOL,
        "predict printed finite RMSEs":
            rmse is not None and all(np.isfinite(rmse)),
        "md on the fitted model: finite, trio kernel launched":
            found is not None and md_launches > 0
            and all(np.isfinite(float(x)) for x in found.groups())})
    return md_launches, dict(dataset=dataset, train=train_keys,
                             test=test_keys, npz=kept_npz,
                             npz_s=seconds["featurize"])


# -- the HDF5 feature store on the card (ROADMAP.md section 1 item 7):
# run_data_pipeline's dataset featurized into the reference's tables of
# 50 configurations, written by util/hdf5.py; the committed fixture that
# h5py wrote, read here where h5py is absent; the fits streamed table by
# table against the fit of run_data_pipeline's .npz of the same rows
STORE_BATCH = 50         # configurations per table, the reference's default
STORE_FIT_TOL = 1e-10    # the .h5 fit's predictions vs the .npz fit's
STORE_PEAK_SHARE = 0.25  # the .h5 fit's host peak vs the .npz fit's
STORE_FIXTURE = os.path.join(REPO, "tests", "data", "features_ref")


def traced_peak(fn):
    """(fn's result, its tracemalloc peak in bytes)."""
    tracemalloc.start()
    try:
        out = fn()
        return out, tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()


def fixture_bit_equal() -> bool:
    """Whether the port reads every table of the committed fixture (h5py
    wrote it) equal to its ``.npz`` twin: values, names, kinds, columns."""
    from uf3_tpu_torch.representation import process
    names = process.analyze_hdf_tables(STORE_FIXTURE + ".h5")[2]
    with np.load(STORE_FIXTURE + ".npz") as twin:
        if sorted({k.rsplit(".", 1)[0] for k in twin.files}) != names:
            return False
        for name in names:
            table = process.load_feature_db(STORE_FIXTURE + ".h5", name)
            if not (np.array_equal(table.values, twin[f"{name}.values"])
                    and table.names == twin[f"{name}.row_names"].tolist()
                    and table.kinds == twin[f"{name}.row_kinds"].tolist()
                    and table.columns == twin[f"{name}.columns"].tolist()):
                return False
    return len(names) > 0


def run_feature_store(device, fit, pipeline, keep=None):
    """The HDF5 feature store on ``run_fit``'s labeled set (``fit``) as
    ``run_data_pipeline`` read it (``pipeline``, as it returns it):
    ``Featurizer.write_features("features.h5", ...)`` on the card (39
    tables of 50 configurations), a second call that must add no table
    and featurize nothing; the committed fixture read bit-equal to its
    ``.npz`` twin; ``fit_from_file`` and ``batched_predict`` on
    ``run_fit``'s training and hold-out keys from the ``.h5`` and from
    ``run_data_pipeline``'s ``.npz`` of the same rows, the ``.h5`` fit
    within 1e-10 of the ``.npz`` fit and its ``tracemalloc`` peak at
    most a quarter of the ``.npz`` fit's; then
    ``featurize`` / ``fit`` / ``predict`` on 50 configurations through
    a settings file naming ``features.h5`` and ``md`` on their model,
    all in this process, the trio launches counted.  ``keep``, a
    directory, receives the commands' settings and features.  Returns
    the ``md`` command's trio launches."""
    from uf3_tpu_torch import __main__ as cli
    from uf3_tpu_torch.ops import featurize as feat
    from uf3_tpu_torch.regression import least_squares as ls
    from uf3_tpu_torch.representation import process
    card = card_line()
    t_phase = time.perf_counter()
    seconds = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return out

    geoms, energies, forces = fit["geoms"], fit["energies"], fit["forces"]
    dataset, npz = pipeline["dataset"], pipeline["npz"]
    seconds["write .npz (run_data_pipeline)"] = pipeline["npz_s"]
    tmp = tempfile.mkdtemp()
    h5 = os.path.join(tmp, "features.h5")
    featurizer = feat.Featurizer(fit["basis"], device=device)
    stats = {}
    written = timed("write .h5", lambda: featurizer.write_features(
        h5, dataset, stats=stats, batch_size=STORE_BATCH))
    calls = []
    batches = feat.featurize_batches

    def counted(*args, **kwargs):
        calls.append(1)
        return batches(*args, **kwargs)

    feat.featurize_batches = counted
    try:
        rerun = {}
        with warnings.catch_warnings(record=True) as warned:
            warnings.simplefilter("always")
            again = featurizer.write_features(h5, dataset, stats=rerun,
                                              batch_size=STORE_BATCH)
    finally:
        feat.featurize_batches = batches
    sizes = {ext: os.path.getsize(path) for ext, path in (("h5", h5),
                                                          ("npz", npz))}
    tables = timed("read .h5", lambda: [
        process.load_feature_db(h5, name)
        for name in process.analyze_hdf_tables(h5)[2]])
    n_rows = sum(len(t) for t in tables)
    del tables

    def read_npz():
        with np.load(npz) as data:
            return [data[k] for k in data.files]

    timed("read .npz", read_npz)
    fixture_ok = timed("read fixture", fixture_bit_equal)
    train_keys, test_keys = pipeline["train"], pipeline["test"]
    models, peaks, rmse = {}, {}, {}
    for ext, path in (("h5", h5), ("npz", npz)):
        models[ext] = ls.WeightedLinearModel(fit["basis"], device=device,
                                             **FIT_REG)
        _, peaks[ext] = timed(f"fit_from_file .{ext}", lambda: traced_peak(
            lambda: models[ext].fit_from_file(path, subset=train_keys,
                                              weight=0.5)))
        with contextlib.redirect_stdout(StringIO()):
            rmse[ext] = timed(f"batched_predict .{ext}", lambda: models[
                ext].batched_predict(path, keys=test_keys)[4:])
    x_e, _, x_f, _ = ls.feature_rows(npz)
    fit_err = 0.0
    for x in (x_e, x_f):
        want = x @ models["npz"].coefficients
        fit_err = max(fit_err, float(np.abs(x @ models["h5"].coefficients
                                            - want).max()
                                     / np.abs(want).max()))
    del x_e, x_f
    print(f"feature store: {len(dataset)} configurations, {len(written)} "
          f"tables written ({stats['calls']} featurize calls, "
          f"{stats['redos']} redos, {stats['energy_rows']} energy and "
          f"{stats['force_rows']} force rows); rerun: {len(again)} tables, "
          f"{len(calls)} featurize calls, {rerun['skipped']} skipped; "
          f"sizes .h5 {sizes['h5']} bytes, .npz {sizes['npz']} bytes; "
          f"{n_rows} rows read back; card: {card}")
    print(f"feature store: seconds " + ", ".join(
        f"{k} {v:.3f}" for k, v in seconds.items())
        + f"; tracemalloc peaks fit_from_file .h5 {peaks['h5']} bytes, "
        f".npz {peaks['npz']} bytes ({peaks['h5'] / peaks['npz']:.3f}); "
        f".h5 fit vs .npz fit, relative {fit_err:.3e}; hold-out RMSE .h5 "
        f"{rmse['h5'][0]:.4e} eV/atom, {rmse['h5'][1]:.4e} eV/A (.npz "
        f"{rmse['npz'][0]:.4e}, {rmse['npz'][1]:.4e}); committed fixture "
        f"bit-equal: {fixture_ok}; card: {card}")
    # the commands on a settings file naming features.h5, in this process
    cmd_dir = os.path.join(tmp, "commands")
    cmd = [int(i) for i in fit["train"][:FIT_CMD_CONFIGS]]
    os.makedirs(os.path.join(cmd_dir, "data"))
    data_io.write_xyz(os.path.join(cmd_dir, "data", "train.xyz"),
                      labeled_frames([geoms[i] for i in cmd],
                                     [energies[i] for i in cmd],
                                     [forces[i] for i in cmd]))
    settings = {
        "elements": ["W"], "degree": 3,
        # the bench model's basis
        "basis": {"r_min": {"W-W": 0.001, "W-W-W": [1.5, 1.5, 1.5]},
                  "r_max": {"W-W": 5.5, "W-W-W": [3.5, 3.5, 7.0]},
                  "resolution": {"W-W": 15, "W-W-W": [6, 6, 12]}},
        "learning": {"regularizer": {"curvature_2b": FIT_REG["c2"],
                                     "curvature_3b": FIT_REG["c3"]}}}
    settings_path, model_path = command_settings(settings, cmd_dir, {
        "sources": {"path": os.path.join(cmd_dir, "data"),
                    "pattern": "*.xyz"}}, features="features.h5")
    flags = [] if torch.device(device).type == "cuda" \
        else ["--device", "cpu"]
    out = StringIO()
    with contextlib.redirect_stdout(out):
        for command in ("featurize", "fit", "predict"):
            timed(f"{command} command", lambda: cli.main(
                [command, settings_path] + flags))
    lines = out.getvalue().strip().splitlines()
    found = [re.search(r"RMSE \(energy, eV/atom\): (\S+); RMSE "
                       r"\(forces, eV/A\): (\S+);", line) for line in lines]
    cmd_rmse = [tuple(float(x) for x in m.groups()) for m in found if m]
    cmd_tables = process.analyze_hdf_tables(
        os.path.join(cmd_dir, "features.h5"))
    reset_counts()
    out = StringIO()
    with contextlib.redirect_stdout(out):
        timed("md command", lambda: cli.main(
            ["md", model_path, "--steps", str(PIPE_MD_STEPS)] + flags))
    md_launches = trio.trio_partials.launches
    lines += out.getvalue().strip().splitlines()
    for line in lines:
        print(f"feature store commands: {line}")
    md_found = re.search(r"\(([-+.\deE]+) atom-steps/s\); T = (\S+) K, "
                         r"E = (\S+) eV", lines[-1] if lines else "")
    if keep is not None:   # the commands' settings and features
        for name in ("settings.json", "features.h5"):
            shutil.copy(os.path.join(cmd_dir, name), keep)
    shutil.rmtree(tmp)
    wall = time.perf_counter() - t_phase
    print(f"feature store: commands on features.h5 ({cmd_tables[0]} table, "
          f"{cmd_tables[1]} rows) {seconds['featurize command']:.3f} + "
          f"{seconds['fit command']:.3f} + {seconds['predict command']:.3f}"
          f" s, md command ({PIPE_MD_STEPS} steps) "
          f"{seconds['md command']:.3f} s, {md_launches} trio launches; "
          f"phase wall {wall:.3f} s; card: {card}")
    gate("feature store", {
        f"{len(written)} tables written, 39 expected": len(written) == 39,
        "the rerun adds no table and featurizes nothing":
            again == [] and not calls and rerun["calls"] == 0
            and rerun["skipped"] == len(written),
        "the rerun warns as the reference does": any(
            issubclass(w.category, RuntimeWarning) for w in warned),
        "every row read back": n_rows == stats["energy_rows"]
            + stats["force_rows"],
        "the committed fixture read bit-equal to its .npz": fixture_ok,
        f".h5 fit within {STORE_FIT_TOL:g} of the .npz fit":
            fit_err <= STORE_FIT_TOL,
        f".h5 fit's host peak <= {STORE_PEAK_SHARE:g} of the .npz fit's":
            peaks["h5"] <= STORE_PEAK_SHARE * peaks["npz"],
        "hold-out RMSEs finite": all(np.isfinite(rmse["h5"])),
        "predict on features.h5 printed finite RMSEs":
            len(cmd_rmse) == 1 and all(np.isfinite(cmd_rmse[0])),
        "md on the fitted model: finite, trio kernel launched":
            md_found is not None and md_launches > 0
            and all(np.isfinite(float(x)) for x in md_found.groups())})
    return md_launches


# -- the last of the reference's surface: the host featurizer over a
# spawned process pool, the lammps backend's guard on a host without
# lammps, and the native backend and the LAMMPS data file on a general
# triclinic cell
LAST_CONFIGS = 6         # labeled cells of each of the first three sizes
LAST_WORKERS = 2
LAST_REPS = (6, 6, 6)    # bcc W, 432 atoms
LAST_STRAIN = np.array([[0.01, 0.03, -0.02], [0.02, -0.01, 0.04],
                        [-0.03, 0.02, 0.015]])
LAST_ANGLE = 0.35         # rad, the cell's rotation about [111]
LAST_POSITION_TOL = 1e-10  # the data file's 10 decimals, rotated back


def rotation_111(angle):
    """The rotation by ``angle`` about [111] (Rodrigues)."""
    axis = np.ones(3) / np.sqrt(3.0)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k


def read_lammps_box(path):
    """(cell, positions) of an atomic-style LAMMPS data file as
    ``write_lammps_data`` writes it."""
    lines = [ln.strip() for ln in open(path)]
    cell = np.zeros((3, 3))
    for axis, tag in enumerate(("xlo xhi", "ylo yhi", "zlo zhi")):
        lo, hi = (float(v) for v in next(
            ln for ln in lines if ln.endswith(tag)).split()[:2])
        cell[axis, axis] = hi - lo
    for ln in lines:
        if ln.endswith("xy xz yz"):
            cell[1, 0], cell[2, 0], cell[2, 1] = (float(v) for v in
                                                  ln.split()[:3])
    start = lines.index("Atoms") + 2
    rows = np.array([ln.split() for ln in lines[start:]
                     if ln], dtype=float)
    return cell, rows[np.argsort(rows[:, 0]), 2:5]


def run_last_surface(device, fit):
    """``BasisFeaturizer.evaluate_parallel`` on ``run_fit``'s labeled
    cells (``fit``; ``LAST_CONFIGS`` of each of 16, 54 and 128 atoms)
    over ``util.parallel.get_executor(2)`` (spawned workers), twice in
    one pool, against ``evaluate`` (bit-equal, all three timed);
    ``UFLammps(backend="lammps")`` raising ``ImportError`` at its first
    ``evaluate`` on this host, which has no ``lammps`` module; the
    native backend on the card on a general triclinic bcc W cell (432
    atoms, f64) within 1e-10 of ``UFCalculator`` on the card and on the
    CPU; and ``write_lammps_data`` of that cell: positive box lengths,
    its rotation taking the written cell and positions back to the
    input within 1e-10.  Returns the trio launches of the native
    backend's call."""
    from uf3_tpu_torch.representation.process import BasisFeaturizer
    from uf3_tpu_torch.util import parallel
    card = card_line()
    t_phase = time.perf_counter()
    starts = np.cumsum([0] + [c for c, _, _ in FIT_SET])[:3]
    picked = [int(i) for start in starts
              for i in range(start, start + LAST_CONFIGS)]
    dataset = data_io.prepare_dataframe_from_lists(
        [fit["geoms"][i] for i in picked],
        energies=[fit["energies"][i] for i in picked],
        forces=[fit["forces"][i] for i in picked])
    featurizer = BasisFeaturizer(fit["basis"])
    seconds = {}
    t0 = time.perf_counter()
    serial = featurizer.evaluate(dataset)
    seconds["evaluate"] = time.perf_counter() - t0
    pooled = []
    with parallel.get_executor(LAST_WORKERS) as pool:
        for name in ("evaluate_parallel (workers starting)",
                     "evaluate_parallel (workers warm)"):
            t0 = time.perf_counter()
            pooled.append(featurizer.evaluate_parallel(
                dataset, client=pool, n_jobs=LAST_WORKERS))
            seconds[name] = time.perf_counter() - t0
    bit_equal = all(t.index == serial.index and t.columns == serial.columns
                    and np.array_equal(t.values, serial.values)
                    for t in pooled)
    print(f"last surface: {len(dataset)} configurations "
          f"({sum(len(g) for g in dataset['geometry'])} atoms, "
          f"{len(serial)} rows) on the host featurizer: "
          + ", ".join(f"{k} {v:.3f} s" for k, v in seconds.items())
          + f" ({LAST_WORKERS} spawned workers); tables bit-equal: "
          f"{bit_equal}; card's host: {card}")
    # the lammps backend on a host without lammps
    model = io.load_model(MODEL)
    geom = bench_geometry(LAST_REPS, rattle=0.05)
    deformed = geom.get_cell() @ (np.eye(3) + LAST_STRAIN)
    geom.set_cell(deformed @ rotation_111(LAST_ANGLE).T,
                  scale_atoms=True)
    tmp = tempfile.mkdtemp()
    guard = lammps.UFLammps(model, backend="lammps", device=device,
                            pot_dir=tmp)
    try:
        guard.evaluate(geom)
        raised = None
    except ImportError as exc:
        raised = str(exc)
    # the native backend on the card on the general cell
    reset_counts()
    native_results = lammps.UFLammps(model, backend="native",
                                     device=device).evaluate(geom)
    launches = trio.trio_partials.launches
    errors = {}
    for tag, where in (("card", device), ("CPU", "cpu")):
        calc = UFCalculator(MODEL, device=where)
        errors[tag] = max(
            abs(native_results["energy"] - calc.get_potential_energy(geom)),
            np.abs(native_results["forces"] - calc.get_forces(geom)).max(),
            np.abs(np.asarray(native_results["stress"])
                   - calc.get_stress(geom)).max())
    data_path = os.path.join(tmp, "cell.data")
    q = lammps.write_lammps_data(data_path, geom, model.bspline_config
                                 .element_list)
    cell, positions = read_lammps_box(data_path)
    cell_err = np.abs(cell @ q.T - geom.get_cell()).max()
    position_err = np.abs(positions @ q.T - geom.get_positions()).max()
    shutil.rmtree(tmp)
    wall = time.perf_counter() - t_phase
    print(f"last surface: UFLammps(backend='lammps') on this host: "
          f"{'ImportError: ' + raised[:60] if raised else 'no error'}; "
          f"native backend on a general triclinic cell ({len(geom)} atoms, "
          f"f64, {launches} trio launches): max |d| against UFCalculator "
          f"on the card {errors['card']:.3e}, on the CPU "
          f"{errors['CPU']:.3e}; data file box lengths "
          f"{np.round(np.diag(cell), 6).tolist()}, rotated back: cell "
          f"{cell_err:.3e}, positions {position_err:.3e} A; phase wall "
          f"{wall:.3f} s; card: {card}")
    gate("last surface", {
        "evaluate_parallel bit-equal to evaluate": bit_equal,
        "lammps backend raises ImportError naming backend='native'":
            raised is not None and "backend='native'" in raised,
        f"native backend within {F64_TOL:g} of UFCalculator, card and CPU":
            max(errors.values()) <= F64_TOL,
        "trio kernel launched by the native backend": launches > 0,
        "data file box lengths positive": bool(np.all(np.diag(cell) > 0)),
        f"data file rotated back within {LAST_POSITION_TOL:g}":
            max(cell_err, position_err) <= LAST_POSITION_TOL})
    return launches


# -- the multi-species fit on the card (ROADMAP.md section 1 item 1):
# the random Ne/Xe 2+3-body model as the teacher of a training set of
# (count, fcc repetitions) at a = 5.4 A: 1,000 configurations, 129,600
# atoms (the size of the tungsten set; the reference's Ne/Xe LAMMPS set
# is not in the repository)
FIT_MULTI_SET = ((300, 2), (400, 3), (300, 4))
FIT_MULTI_XE = (0.2, 0.8)       # Xe fraction, uniform in this range
FIT_MULTI_ENERGY_ONLY = 10      # one configuration in ten: energy alone
FIT_MULTI_CHECK = 20            # configurations featurized on card and CPU
# hold-out RMSE against the teacher, which lies in the fitted span:
# twice the CPU rehearsal of this phase on the same data, 3.3535e-8
# eV/A and 8.8522e-10 eV/atom (PERF.md), well within the unary
# phase's 5e-4 eV/A and 1e-5 eV/atom
FIT_MULTI_FORCE_RMSE, FIT_MULTI_ENERGY_RMSE = 6.7e-8, 1.77e-9
FIT_PAIR_CONFIGS, FIT_HOST_CONFIGS = 50, 20
# the host route's fit of the bench model's labels in a basis of moved
# knots, which does not span the teacher: twice the CPU rehearsal's
# 2.93e-2 eV/A on the same 20 configurations (PERF.md)
HOST_FORCE_RMSE = 0.06


def fit_multi_teacher():
    """``species23_model()`` with its frozen columns (the basis's edge
    trims) at their frozen values, as a fit holds them: the teacher then
    lies in the span of its basis's features."""
    model = species23_model()
    basis = model.bspline_config
    coefficients = np.array(model.coefficients, dtype=np.float64)
    coefficients[basis.col_idx] = basis.frozen_c
    return io.FittedModel(basis, coefficients)


def fit_multi_training_set(seed, counts=FIT_MULTI_SET):
    """Binary fcc Ne/Xe cells (a = 5.4 A), each with a Xe fraction drawn
    in 0.2-0.8, isotropically strained within +-2% and rattled by a stdev
    in 0.03-0.15 A, drawn from ``seed``."""
    rng = np.random.RandomState(seed)
    geoms = []
    for count, reps in counts:
        for _ in range(count):
            base = bulk("Ne", "fcc", a=5.4) * reps
            numbers = base.get_atomic_numbers()
            share = rng.uniform(*FIT_MULTI_XE)
            numbers[rng.rand(len(numbers)) < share] = 54
            geom = Atoms(numbers, base.get_positions(), base.get_cell(),
                         pbc=True)
            geom.set_cell(geom.get_cell() * (1.0 + rng.uniform(
                -FIT_STRAIN, FIT_STRAIN)), scale_atoms=True)
            geom.rattle(rng.uniform(*FIT_RATTLE),
                        seed=int(rng.randint(2 ** 31 - 1)))
            geoms.append(geom)
    return geoms


def moved_knots_settings(seed=0):
    """A unary W 2+3-body basis whose interior knots are moved by up to
    15% of their gap (seeded): no closed form, so the featurize command
    takes the host route.  Its settings, keyed as in the model files."""
    rng = np.random.RandomState(seed)

    def moved(lo, hi, n_int):
        seq = np.array(knot_spacer("linear")(lo, hi, n_int))
        gap = seq[4] - seq[3]
        seq[4:-4] += rng.uniform(-0.15, 0.15, len(seq) - 8) * gap
        return seq.tolist()
    center = moved(1.5, 3.5, 6)
    return {"elements": ["W"], "degree": 3,
            "basis": {"knots_map": {"W-W": moved(1.5, 5.5, 15),
                                    "W-W-W": [center, center,
                                              moved(1.5, 7.0, 12)]}},
            "learning": {"regularizer": {"curvature_2b": FIT_REG["c2"],
                                         "curvature_3b": FIT_REG["c3"]}}}


def run_fit_multi_commands(geoms, tmp, device):
    """The commands on the bases the device fast path does not take:
    ``featurize`` / ``fit`` / ``predict`` on ``FIT_PAIR_CONFIGS`` of
    ``geoms`` labeled by ``model_pair.json`` in that file's own 2-body
    Ne/Xe basis (the multi-species device route), ``md`` on the model
    they wrote; then on ``FIT_HOST_CONFIGS`` bcc W 2^3 cells labeled by
    the bench model in a basis of moved knots (the host route).
    Returns {route: (energy RMSE, force RMSE)}."""
    pair_basis = io.load_model(MODEL_PAIR).bspline_config
    teacher = UFCalculator(MODEL_PAIR, device=device)
    pair_geoms = geoms[:FIT_PAIR_CONFIGS]
    energies, forces = label(teacher, pair_geoms)
    settings = {
        "elements": list(pair_basis.element_list), "degree": 2,
        "basis": {"knots_map": {"-".join(p): pair_basis.knots_map[p].tolist()
                                for p in pair_basis.interactions_map[2]}},
        "learning": {"regularizer": {"curvature_2b": FIT_REG["c2"]}}}
    model_path, route, rmse = run_commands(
        "fit multi (model_pair.json's basis)",
        labeled_frames(pair_geoms, energies, forces), settings,
        os.path.join(tmp, "pair"), device)
    fitted = io.load_model(model_path).bspline_config
    same_basis = all(np.array_equal(fitted.knots_map[p],
                                    pair_basis.knots_map[p])
                     for p in pair_basis.interactions_map[2])
    _, md_energy = run_md_command(model_path, "--steps", "100",
                                  "--lattice", "4.5", "--dt", "1",
                                  "--temperature", "10",
                                  *([] if torch.device(device).type
                                    == "cuda" else ["--device", "cpu"]))
    routes = {route: rmse}
    # the Ne-Xe example on a LAMMPS run of the same labeled frames
    run_dir, example = (os.path.join(tmp, name) for name in (
        "lammps_run", "nexe_pair_fit"))
    write_lammps_run(run_dir, labeled_frames(pair_geoms, energies, forces))
    run_example("nexe_pair_fit", run_dir, "--out-dir", example,
                device=device)
    tables = [os.path.join(example, f"table_{pair}.dat")
              for pair in ("Ne_Ne", "Ne_Xe", "Xe_Xe")]
    tables_ok = all(os.path.isfile(t) and "\nN 200\n" in open(t).read()
                    for t in tables)
    host_geoms = fit_training_set(1, ((FIT_HOST_CONFIGS, 2, False),))
    energies, forces = label(UFCalculator(MODEL, device=device), host_geoms)
    _, host_route, host_rmse = run_commands(
        "fit multi (moved knots)",
        labeled_frames(host_geoms, energies, forces),
        moved_knots_settings(), os.path.join(tmp, "host"), device)
    routes[host_route] = host_rmse
    print(f"fit multi commands: routes and (energy, force) RMSE against "
          f"the teachers {routes}")
    gate("fit multi commands", {
        "model_pair.json's basis: the multi-species device route, its "
        "own knots": route == "device multi" and same_basis,
        f"model_pair.json's basis: RMSE <= {FIT_MULTI_ENERGY_RMSE:g} "
        f"eV/atom, {FIT_MULTI_FORCE_RMSE:g} eV/A": rmse is not None
            and rmse[0] <= FIT_MULTI_ENERGY_RMSE
            and rmse[1] <= FIT_MULTI_FORCE_RMSE,
        "md ran the fitted pair model": np.isfinite(md_energy),
        "nexe_pair_fit example: model and three 200-point tables written":
            tables_ok and os.path.isfile(os.path.join(example,
                                                      "model_nexe.json")),
        "moved knots: the host route": host_route == "host",
        f"moved knots: force RMSE <= {HOST_FORCE_RMSE:g} eV/A":
            host_rmse is not None and host_rmse[1] <= HOST_FORCE_RMSE})
    return routes


def run_fit_multi(device, counts=FIT_MULTI_SET, seed=0):
    """The multi-species fit on the card: a training set of ``counts``
    (by default 1,000 binary Ne/Xe configurations, 129,600 atoms)
    labeled with energies and forces by ``UFCalculator`` on the teacher
    (``fit_multi_teacher``) in f64 on the fused multi-species route,
    one configuration in ten keeping its energy alone, split 80/20;
    ``featurize_batches`` on the multi-species device path in the
    teacher's basis, the Gram on the card, the solve on the host; the
    fitted model's hold-out RMSE against the teacher through
    ``UFCalculator``; 720 Langevin steps at 10 K with it at 8,788 atoms on
    the fused multi-species route; the commands on the other routes
    (``run_fit_multi_commands``).  Gates: features card vs CPU within
    1e-10 on 20 configurations, one energy row and no force row for each
    configuration without forces, every configuration featurized once,
    the hold-out RMSEs, the MD (multi-species kernel launches, no
    overflow), the commands.  Returns the multi-species kernel's
    launches by step."""
    from uf3_tpu_torch.ops import featurize as feat
    from uf3_tpu_torch.regression import least_squares as ls
    card = card_line()
    geoms = fit_multi_training_set(seed, counts)
    n_atoms_all = sum(len(g) for g in geoms)
    model = fit_multi_teacher()
    basis = model.bspline_config
    launches = {}
    teacher = UFCalculator(model, device=device)
    reset_counts()
    t0 = time.perf_counter()
    energies, forces_all = label(teacher, geoms)
    torch.cuda.synchronize()
    label_s = time.perf_counter() - t0
    launches["fit multi: labeling"] = multi.trio_multi_partials_all.launches
    print(f"fit multi: {len(geoms)} configurations, {n_atoms_all} atoms, "
          f"labeled by UFCalculator (f64, fused multi-species route) in "
          f"{label_s:.2f} s, {launches['fit multi: labeling']} "
          f"trio_multi launches; card: {card}")
    forces = [None if i % FIT_MULTI_ENERGY_ONLY == FIT_MULTI_ENERGY_ONLY - 1
              else f for i, f in enumerate(forces_all)]
    order = np.random.RandomState(seed).permutation(len(geoms))
    n_test = int(round(FIT_HOLDOUT * len(geoms)))
    test, train = order[:n_test], np.sort(order[n_test:])
    tr_geoms = [geoms[i] for i in train]
    tr_e, tr_f = [energies[i] for i in train], [forces[i] for i in train]
    # the card against the CPU on the first training configurations
    check = list(range(min(FIT_MULTI_CHECK, len(tr_geoms))))
    card_rows, cpu_rows = (feat.featurize_dataset_device(
        basis, [tr_geoms[i] for i in check], [tr_e[i] for i in check],
        [tr_f[i] for i in check], device=dev) for dev in (device, "cpu"))
    feat_err = max(np.abs(a - b).max() for a, b in zip(card_rows, cpu_rows))
    check_rows = sum(3 * len(tr_geoms[i]) for i in check
                     if tr_f[i] is not None)
    print(f"fit multi: features card vs CPU on {len(check)} configurations "
          f"({sum(len(tr_geoms[i]) for i in check)} atoms, "
          f"{sum(tr_f[i] is None for i in check)} without forces): max |d| "
          f"{feat_err:.3e}")
    tr_atoms = sum(len(g) for g in tr_geoms)
    stats = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    batches = list(feat.featurize_batches(basis, tr_geoms, tr_e, tr_f,
                                          device=device, stats=stats))
    torch.cuda.synchronize()
    feat_s = time.perf_counter() - t0
    seen = sorted(i for b in batches for i in b.index)
    energy_only_ok = all(
        (b.force_rows[k] == 0) == (tr_f[i] is None)
        and b.x_f.shape[0] == sum(b.force_rows) == b.y_f.shape[0]
        and b.x_e.shape[0] == len(b.index)
        for b in batches for k, i in enumerate(b.index))
    print(f"fit multi: featurized {len(tr_geoms)} configurations "
          f"({tr_atoms} atoms, {sum(f is None for f in tr_f)} without "
          f"forces) on the card, route {stats['route']}, in {feat_s:.3f} s: "
          f"{1e3 * feat_s / len(tr_geoms):.4f} ms per configuration, "
          f"{len(tr_geoms) / feat_s:.1f} configurations/s, "
          f"{tr_atoms / feat_s:.1f} atoms/s; {stats['calls']} calls, batch "
          f"sizes by atom count {stats['batch_sizes']}, redos "
          f"{stats['redos']}, peak memory "
          f"{stats['peak_bytes'] / 2 ** 30:.3f} GiB; card: {card}")
    # the device's busy share over one bucket call of 108-atom cells
    mid = [g for g in tr_geoms if len(g) == 108]
    size = stats["batch_sizes"].get(108, 1)
    chunk = mid[:size]
    wall_ms, busy_ms = busy_share(lambda: list(feat.featurize_batches(
        basis, chunk, [0.0] * len(chunk), [np.zeros((108, 3))] * len(chunk),
        device=device, batch_size=size)))
    print(f"fit multi: one bucket call, {len(chunk)} configurations of 108 "
          f"atoms: {wall_ms:.3f} ms wall, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%); card: {card}")
    fit = ls.WeightedLinearModel(basis, device=device, **FIT_REG)
    e_var, f_var = ls.VarianceRecorder(), ls.VarianceRecorder()
    t0 = time.perf_counter()
    grams = fit.gram_from_batches(batches, e_var, f_var)
    torch.cuda.synchronize()
    gram_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    fit.fit_with_gram(*fit.weighted_gram(*grams, e_var, f_var))
    solve_ms = 1e3 * (time.perf_counter() - t0)
    print(f"fit multi: Gram on the card over {e_var.n} energy and "
          f"{f_var.n} force rows x {fit.n_feats} features in "
          f"{len(batches)} batches {gram_ms:.3f} ms, solve on the host "
          f"{solve_ms:.3f} ms; card: {card}")
    del batches, grams
    tmp = tempfile.mkdtemp()
    fitted = os.path.join(tmp, "fitted_multi.json")
    fit.to_json(fitted)
    reset_counts()
    check_calc = UFCalculator(fitted, device=device)
    te_e, te_f = label(check_calc, [geoms[i] for i in test])
    launches["fit multi: hold-out check"] = \
        multi.trio_multi_partials_all.launches
    rmse_e = ls.rmse_metric(
        [e / len(geoms[i]) for e, i in zip(te_e, test)],
        [energies[i] / len(geoms[i]) for i in test])
    rmse_f = ls.rmse_metric(np.concatenate(te_f),
                            np.concatenate([forces_all[i] for i in test]))
    print(f"fit multi: hold-out {len(test)} configurations: RMSE energy "
          f"{rmse_e:.4e} eV/atom, forces {rmse_f:.4e} eV/A against the "
          f"teacher; {launches['fit multi: hold-out check']} trio_multi "
          "launches")
    reset_counts()
    system = MDSystem(fitted, ne_xe((13, 13, 13)), dtype=torch.float32,
                      device=device)
    state = system.init_state(temperature=MULTI_T, seed=0)
    state, md_s = drive(system, state, WINDOW_STEPS, dt_fs=1.0,
                        thermostat="langevin", temperature=MULTI_T)
    launches["fit multi: MD with the fitted model"] = \
        multi.trio_multi_partials_all.launches
    md_ok = not system.overflowed(state) and bool(
        torch.isfinite(state.positions).all()) and np.isfinite(
        float(state.energy))
    print(f"fit multi: MD with the fitted model, {len(state.positions)} "
          f"atoms, {WINDOW_STEPS} Langevin steps at {MULTI_T:g} K in "
          f"{md_s:.2f} s: "
          f"T {system.temperature(state):.2f} K, E "
          f"{float(state.energy):.4f} eV; "
          f"{launches['fit multi: MD with the fitted model']} trio_multi "
          "launches")
    run_fit_multi_commands([geoms[i] for i in train], tmp, device)
    shutil.rmtree(tmp)
    gate("fit multi", {
        f"features card vs CPU within {FIT_FEATURE_TOL:g}":
            feat_err <= FIT_FEATURE_TOL,
        "one energy row and no force row without forces": energy_only_ok
            and card_rows[2].shape[0] == check_rows,
        "every training configuration featurized once":
            seen == list(range(len(tr_geoms))),
        f"hold-out force RMSE <= {FIT_MULTI_FORCE_RMSE:g} eV/A":
            rmse_f <= FIT_MULTI_FORCE_RMSE,
        f"hold-out energy RMSE <= {FIT_MULTI_ENERGY_RMSE:g} eV/atom":
            rmse_e <= FIT_MULTI_ENERGY_RMSE,
        "fitted model's MD on the fused multi-species route, no overflow, "
        "finite": md_ok and system._multi_route(),
        "trio_multi launched in the labeling, the check and the MD":
            all(n > 0 for n in launches.values())})
    return launches


# -- multi-shard MD and fitting on torch.distributed (ROADMAP.md section
# 1, Parallel and halo): a NCCL group of world size 1 holds a 4-shard
# mesh on the card (NCCL holds one rank per GPU; one rank may hold
# several shards)
HALO_SHARDS = 4
HALO_RESPA = dict(n_respa=12, respa_mid=6, respa_switch=(2.5, 3.5),
                  rebuild_every=36)
HALO_CHUNK = 36          # steps per chunk; a stale chunk re-decomposes
HALO_WARMUP = 144
HALO_E_TOL = 1e-10       # relative, the reference's bounds
HALO_F_TOL = 1e-9        # eV/A (tests/test_halo.py:84-111), and virial
HALO_X_TOL, HALO_V_TOL = 1e-9, 1e-11   # trajectories (:114-215)
REPLICATED_XV_TOL, REPLICATED_FE_TOL = 1e-12, 1e-10  # test_parallel.py
SHARDED_FIT_TOL = 1e-10  # relative, predictions against model.fit
DEMO_ENERGY_TOL = 1e-8   # eV, the multichip example's halo vs single, f64
HALO_RESPA_CHUNK = dict(n_respa=HALO_RESPA["n_respa"],
                        respa_mid=HALO_RESPA["respa_mid"])


def init_nccl(device, tmp):
    """A NCCL process group of world size 1 on ``device`` from a file
    store in ``tmp`` (no TCP port)."""
    torch.cuda.set_device(device)
    torch.distributed.init_process_group(
        "nccl", init_method=f"file://{os.path.join(tmp, 'store')}",
        rank=0, world_size=1)
    return torch.distributed.group.WORLD


def halo_dec(system: MDSystem, positions, mesh):
    """The slab decomposition of ``positions`` at the system's cutoffs,
    skin and capacities, its lists built on the mesh's card."""
    return halo.decompose(
        positions, system.cell.double().cpu().numpy(), mesh.n_shards,
        r_cut_2b=system.r_cut_2b, r_cut_3b=system.r_cut_3b,
        skin=system.skin, capacity_2b=system.capacity_2b,
        capacity_3b=system.capacity_3b,
        masses=system.masses.double().cpu().numpy(), device=mesh.device)


def halo_chunk(system, mesh, dec, v0=None, x_own=None, dt_fs=1.0, **kw):
    """One call of a halo chunk from ``dec`` (velocities ``v0`` global,
    zero when None); returns the chunk's outputs."""
    chunk, shard = halo.halo_md_step_factory(system, mesh, **kw)
    d = shard(dec)
    v = torch.zeros_like(d.x_own) if v0 is None \
        else shard(halo.scatter_velocities(dec, v0))
    return chunk(d, d.x_own if x_own is None else shard(x_own), v,
                 dt_fs * units.fs)


def respa_split_loop(system: MDSystem, x, v, nbr2, nbr3, n_steps,
                     dt_fs=1.0):
    """3-level r-RESPA on one device on fixed lists, the halo chunk's
    split (tests/test_halo.py:114-215): positions, velocities."""
    pot, cell = system.potential, system.cell
    spec = pot.pair_spec
    r_lo, r_hi = system.respa_switch
    m = system.masses[:, None]
    dt = dt_fs * units.fs
    short = lambda xx: pair_short_forces(  # noqa: E731
        pot.pair_coefficients, xx, cell, nbr3, spec_pair=spec,
        n_basis_pair=spec.n_basis, with_energy=False, r_lo=r_lo,
        r_hi=r_hi)[1]
    mid = lambda xx: trio.trio_forces(  # noqa: E731
        pot, xx, cell, nbr3, False)[1]
    tail = lambda xx: pair_tail_forces(  # noqa: E731
        pot.pair_coefficients, xx, cell, nbr2, spec_pair=spec,
        n_basis_pair=spec.n_basis, with_energy=False, r_lo=r_lo,
        r_hi=r_hi)[1]
    n_respa, n_mid = system.n_respa, system.respa_mid
    fp, fm, ft = short(x), mid(x), tail(x)
    for _ in range(n_steps // n_respa):
        v = v + 0.5 * dt * n_respa * ft / m
        for _ in range(n_respa // n_mid):
            v = v + 0.5 * dt * n_mid * fm / m
            for _ in range(n_mid):
                v = v + 0.5 * dt * fp / m
                x = x + dt * v
                fp = short(x)
                v = v + 0.5 * dt * fp / m
            fm = mid(x)
            v = v + 0.5 * dt * n_mid * fm / m
        ft = tail(x)
        v = v + 0.5 * dt * n_respa * ft / m
    return x, v


def halo_parity_f64(device, mesh):
    """The halo chunk and the replicated path in float64 at full width
    (bcc W 17^3 rattled 0.05 A, the engine's default capacities):
    energy, forces and virial at n_steps = 0 against the factorized
    oracle ``energy_forces_virial`` and the fused single-device force; 5
    NVE steps and 12 steps of 3-level r-RESPA 12/6 against the
    single-device loops on fixed lists; the replicated chunk 5 steps
    against the single device."""
    geom = bench_geometry((17, 17, 17), rattle=0.05)
    n = len(geom)
    system = MDSystem(MODEL, geom, dtype=torch.float64, device=device,
                      **HALO_RESPA)
    t0 = time.perf_counter()
    dec = halo_dec(system, geom.get_positions(), mesh)
    torch.cuda.synchronize()
    rows = dec.center_w.numel()
    print(f"halo f64: decomposition {time.perf_counter() - t0:.3f} s: "
          f"C_own {dec.c_own}, C_halo {dec.c_halo}, L "
          f"{dec.center_w.shape[1]}, S*L {rows} rows ({1 - n / rows:.3f} "
          f"not owned), capacities {system.capacity_2b}/"
          f"{system.capacity_3b}; one position permute "
          f"{3 * dec.c_halo * 4} bytes in f32")
    x = torch.as_tensor(halo.gather_positions(dec, dec.x_own, n),
                        device=device)
    nbr2, nbr3 = system.build_lists(x)
    e_or, f_or, w_or = system.energy_forces_virial(x, nbr2, nbr3)
    e_fu, f_fu, w_fu = system.energy_forces(x, nbr2, nbr3, with_virial=True)
    _, _, f_own, energy, virial, stale = halo_chunk(
        system, mesh, dec, n_steps=0, with_virial=True)
    f = torch.as_tensor(halo.gather_positions(dec, f_own, n))
    voigt = lambda w: torch.stack([w[a, b] for a, b in  # noqa: E731
                                   ((0, 0), (1, 1), (2, 2), (1, 2), (0, 2),
                                    (0, 1))])
    errs = {}
    for tag, (e_r, f_r, w_r) in (("oracle", (e_or, f_or, w_or)),
                                 ("fused", (e_fu, f_fu, w_fu))):
        errs[tag] = (abs(float(energy - e_r)) / abs(float(e_r)),
                     max_err(f, f_r), max_err(virial, voigt(w_r)))
        print(f"halo f64 n_steps=0 vs single-device {tag}: |dE|/|E| "
              f"{errs[tag][0]:.3e}, max |dF| {errs[tag][1]:.3e} eV/A, max "
              f"|dW| {errs[tag][2]:.3e} eV")
    # NVE and r-RESPA trajectories
    rng = np.random.RandomState(11)
    v0 = rng.normal(scale=5e-4, size=(n, 3))
    m = system.masses[:, None]
    xs, v = x, torch.as_tensor(v0, device=device)
    _, fs, _ = system.energy_forces(xs, nbr2, nbr3, with_energy=False)
    dt = 1.0 * units.fs
    for _ in range(5):
        v = v + 0.5 * dt * fs / m
        xs = xs + dt * v
        _, fs, _ = system.energy_forces(xs, nbr2, nbr3, with_energy=False)
        v = v + 0.5 * dt * fs / m
    out = halo_chunk(system, mesh, dec, v0, n_steps=5)
    nve = (max_err(torch.as_tensor(halo.gather_positions(dec, out[0], n)),
                   xs),
           max_err(torch.as_tensor(halo.gather_positions(dec, out[1], n)),
                   v), bool(out[-1]))
    xr, vr = respa_split_loop(system, x, torch.as_tensor(v0, device=device),
                              nbr2, nbr3, 12)
    out = halo_chunk(system, mesh, dec, v0, n_steps=12, n_respa=12,
                     respa_mid=6)
    respa = (max_err(torch.as_tensor(halo.gather_positions(dec, out[0], n)),
                     xr),
             max_err(torch.as_tensor(halo.gather_positions(dec, out[1], n)),
                     vr), bool(out[-1]))
    for tag, (dx, dv, st) in (("NVE 5 steps", nve),
                              ("3-level r-RESPA 12/6, 12 steps", respa)):
        print(f"halo f64 {tag} vs single device: max |dx| {dx:.3e} A, "
              f"max |dv| {dv:.3e} A/fs-units, stale {st}")
    # the replicated-positions path
    state = system.init_state(temperature=T_TARGET, seed=0)
    xp, vp, fp = state.positions, state.velocities, state.forces
    for _ in range(5):
        vp = vp + 0.5 * dt * fp / m
        xp = xp + dt * vp
        _, fp, _ = system.energy_forces(xp, state.nbr2, state.nbr3,
                                        with_energy=False)
        vp = vp + 0.5 * dt * fp / m
    e_p, f_p, _ = system.energy_forces(xp, state.nbr2, state.nbr3)
    reset_counts()
    mesh.reset_traffic()
    chunk, shard_atoms = pmesh.sharded_md_step_factory(system, mesh,
                                                       n_steps=5)
    xr, vr, fr, er = chunk(state.positions, state.velocities, state.forces,
                           shard_atoms(state.nbr2), shard_atoms(state.nbr3),
                           dt)
    torch.cuda.synchronize()
    repl = (max_err(xr, xp), max_err(vr, vp), max_err(fr, f_p),
            abs(float(er - e_p)))
    repl_launches = trio.trio_partials.launches
    print(f"replicated path, {mesh.n_shards} shards, 5 steps vs single "
          f"device: max |dx| {repl[0]:.3e}, |dv| {repl[1]:.3e}, |dF| "
          f"{repl[2]:.3e}, |dE| {repl[3]:.3e}; {repl_launches} trio "
          f"launches (one per force call for all shards), all_gather "
          f"{len(mesh.traffic['all_gather'])} x "
          f"{max(mesh.traffic['all_gather'])} elements per shard")
    gate("halo f64", {
        f"n_steps=0 |dE|/|E| <= {HALO_E_TOL:g} (oracle, fused)":
            max(errs["oracle"][0], errs["fused"][0]) <= HALO_E_TOL,
        f"n_steps=0 forces <= {HALO_F_TOL:g} eV/A (oracle, fused)":
            max(errs["oracle"][1], errs["fused"][1]) <= HALO_F_TOL,
        f"n_steps=0 virial <= {HALO_F_TOL:g} (oracle, fused)":
            max(errs["oracle"][2], errs["fused"][2]) <= HALO_F_TOL,
        "not stale": not (bool(stale) or nve[2] or respa[2]),
        f"NVE x <= {HALO_X_TOL:g}, v <= {HALO_V_TOL:g}":
            nve[0] <= HALO_X_TOL and nve[1] <= HALO_V_TOL,
        f"r-RESPA x <= {HALO_X_TOL:g}, v <= {HALO_V_TOL:g}":
            respa[0] <= HALO_X_TOL and respa[1] <= HALO_V_TOL,
        f"replicated x, v <= {REPLICATED_XV_TOL:g}":
            max(repl[:2]) <= REPLICATED_XV_TOL,
        f"replicated f, E <= {REPLICATED_FE_TOL:g}":
            max(repl[2:]) <= REPLICATED_FE_TOL,
        "replicated path: one trio launch per force call":
            repl_launches == 6})


def halo_production(device, mesh):
    """The halo chunk at the bench's split in float32: 3-level r-RESPA
    (inner 2 fs, trio every 6, tail every 12, switch (2.5, 3.5) A) NVE
    from 300 K Maxwell-Boltzmann velocities at 9,826 atoms, chunks of
    36 steps, a new decomposition from the gathered positions whenever a
    chunk comes back stale; 144 warm-up steps and 3 timed windows of 720.
    Beside it the single-device 3-level r-RESPA NVE at the same atoms
    and engine settings.  Returns (launches, the f32 decomposition, the
    system)."""
    geom = bench_geometry((17, 17, 17))
    n = len(geom)
    system = MDSystem(MODEL, geom, dtype=torch.float32, device=device,
                      **HALO_RESPA)
    generator = torch.Generator(device=device)
    generator.manual_seed(0)
    sigma = torch.sqrt(units.kB * T_TARGET / system.masses)[:, None]
    v0 = sigma * torch.randn((n, 3), generator=generator,
                             dtype=torch.float32, device=device)
    v0 = (v0 - v0.mean(dim=0)).cpu().numpy()
    x0 = geom.get_positions()
    dec = halo_dec(system, x0, mesh)
    # f32 forces at the start against f64
    f32 = halo_chunk(system, mesh, dec, n_steps=0, **HALO_RESPA_CHUNK)[2]
    f32 = torch.as_tensor(halo.gather_positions(dec, f32, n))
    system64 = MDSystem(MODEL, geom, dtype=torch.float64, device=device,
                        **HALO_RESPA)
    x64 = torch.as_tensor(halo.gather_positions(dec, dec.x_own, n),
                          device=device)
    _, f64, _ = system64.energy_forces(x64, *system64.build_lists(x64))
    f_err = max_err(f32, f64)
    chunk, shard = halo.halo_md_step_factory(system, mesh, n_steps=HALO_CHUNK,
                                             **HALO_RESPA_CHUNK)
    state = dict(dec=dec, d=shard(dec), v=shard(halo.scatter_velocities(
        dec, v0)), decompositions=0, finite=True)
    state["x"] = state["d"].x_own

    def advance(steps):
        """``steps`` in chunks; the total energy after each chunk."""
        energies = []
        for _ in range(steps // HALO_CHUNK):
            x, v, _, energy, stale = chunk(state["d"], state["x"],
                                           state["v"], 2.0 * units.fs)
            state["x"], state["v"] = x, v
            # padding slots carry mass 1 and velocity 0
            kinetic = 0.5 * torch.sum(state["d"].masses.double()
                                      * v.double() ** 2)
            energies.append(float(energy) + float(kinetic))
            state["finite"] = state["finite"] and bool(
                torch.isfinite(x).all() and torch.isfinite(v).all())
            if bool(stale):
                xg = halo.gather_positions(state["dec"], x, n)
                vg = halo.gather_positions(state["dec"], v, n)
                state["dec"] = halo_dec(system, xg, mesh)
                state["d"] = shard(state["dec"])
                state["x"] = state["d"].x_own
                state["v"] = shard(halo.scatter_velocities(state["dec"],
                                                           vg))
                state["decompositions"] += 1
        torch.cuda.synchronize()
        return energies

    t0 = time.perf_counter()
    e_start = advance(HALO_WARMUP)
    print(f"halo f32: set-up + {HALO_WARMUP}-step warm-up "
          f"{time.perf_counter() - t0:.2f} s")
    reset_counts()
    mesh.reset_traffic()
    times, ends, means, windows = [], [e_start[-1]], [], []
    for _ in range(3):
        before = state["decompositions"]
        t0 = time.perf_counter()
        energies = advance(WINDOW_STEPS)
        times.append(time.perf_counter() - t0)
        ends.append(energies[-1])
        means.append(float(np.mean(energies)))
        windows.append(state["decompositions"] - before)
    finite = state["finite"] and bool(np.all(np.isfinite(ends)))
    # the drift as every phase takes it: the total energy from the start
    # of the first timed window to the end of the last, per atom; the
    # windows' mean total energies are printed beside it
    drift = float(abs(ends[-1] - ends[0]) / n)
    swings = np.abs(np.diff(ends)) / n
    launches = trio.trio_partials.launches
    traffic = {op: list(sizes) for op, sizes in mesh.traffic.items()}
    sent = dict(mesh.sent_bytes)
    rate = n * WINDOW_STEPS / sorted(times)[1]
    n_chunks = 3 * WINDOW_STEPS // HALO_CHUNK
    mids = HALO_CHUNK // HALO_RESPA["respa_mid"]
    c_halo = state["dec"].c_halo
    bytes_step = sum(sent.values()) / (3 * WINDOW_STEPS)
    # the single-device 3-level r-RESPA NVE at the same atoms
    _, _, _, rate_single, _, _ = run_path(
        "single-device 3-level r-RESPA 12/6/36 NVE", device,
        dict(HALO_RESPA), dict(dt_fs=2.0, launch_chunks=10))
    card = card_line()
    print(f"halo f32: windows (s) {[round(t, 4) for t in times]}; total "
          f"energy, mean per window {[round(e, 6) for e in means]} eV, "
          f"drift {drift:.3e} eV/atom (start of the first window to end "
          f"of the last), change "
          f"from window end to window end {[f'{d:.3e}' for d in swings]} "
          f"eV/atom; decompositions per window {windows}")
    print(f"MD halo 3-level r-RESPA 12/6, {mesh.n_shards} shards on 1 "
          f"card (NCCL, world size 1): {rate:.1f} atom-steps/s beside "
          f"single-device 3-level r-RESPA 12/6/36 NVE {rate_single:.1f} "
          f"atom-steps/s; {bytes_step:.1f} bytes put into collectives per "
          f"step ({sent}); permutes of at most {max(traffic['ppermute'])} "
          f"elements (C_halo x 3 = {3 * c_halo}); card: {card}")
    gate("halo f32", {
        "finite state": finite,
        f"NVE drift over {2 * WINDOW_STEPS} steps <= {NVE_DRIFT:g} "
        "eV/atom": drift <= NVE_DRIFT,
        f"f32 forces within {FORCE_TOL:g} eV/A of f64 at the start":
            f_err <= FORCE_TOL,
        "one trio launch per mid step for all shards":
            launches == n_chunks * (mids + 2),
        "no permute larger than C_halo x 3": max(traffic["ppermute"])
            <= 3 * c_halo,
        "no all_gather on the halo path": not traffic["all_gather"]})
    print(f"halo f32: max |F_f32 - F_f64| {f_err:.3e} eV/A at the start; "
          f"{launches} trio launches over {n_chunks} chunks")
    return launches, dict(rate=rate, rate_single=rate_single,
                          bytes_per_step=bytes_step, drift=drift,
                          decompositions=windows), system



def compare_trio_weighted(device, system32: MDSystem, mesh):
    """The trio kernel with its center weight on the halo path's own
    rows (the f32 system's decomposition, all shards' local rows, 0 on
    halo rows) and with a non-binary weight vector, in both lane layouts
    (the halo path runs the triangle lanes): f64 within 1e-10 and f32
    forces within 2e-4 eV/A of the plain version; the weighted launch
    timed by graph replay beside the unweighted one on the same rows,
    and the triangle's, the bound counted over the rows of nonzero
    weight."""
    geom = bench_geometry((17, 17, 17))
    dec = halo_dec(system32, geom.get_positions(), mesh)
    pot64 = UF3Potential.from_json(MODEL).to(device)
    pot32 = system32.potential
    cell = system32.cell.double()
    rows = halo.local_rows(dec, cell, torch.float64)
    x_local = halo.local_positions(mesh, dec, rows, dec.x_own)
    d64 = x_local[rows.nbr3.idx] + rows.cache3.sd - x_local[:, None]
    v64 = rows.cache3.valid
    w_halo = rows.weight
    rng = np.random.RandomState(5)
    w_scaled = torch.as_tensor(rng.uniform(0.2, 1.7, len(w_halo)),
                               device=device) * w_halo
    d32, v32 = d64.float(), v64.float()
    errs = {}
    for tag, w, tri in (("halo 0/1", w_halo, False),
                        ("non-binary", w_scaled, False),
                        ("halo 0/1, triangle", w_halo, True),
                        ("non-binary, triangle", w_scaled, True)):
        twin = trio.trio_partials_torch(d64, v64, pot64.grid, pot64.trio,
                                        True, center_weight=w,
                                        triangle=tri)
        k64 = trio.trio_partials(pot64, d64, v64, True, center_weight=w,
                                 triangle=tri)
        k32 = trio.trio_partials(pot32, d32, v32, True,
                                 center_weight=w.float(), triangle=tri)
        f_twin = trio.assemble_forces(*twin, d64, rows.cache3.rev_flat,
                                      rows.nbr3.mask)[1]
        f64 = trio.assemble_forces(*k64, d64, rows.cache3.rev_flat,
                                   rows.nbr3.mask)[1]
        f32 = trio.assemble_forces(*k32, d32, rows.cache3.rev_flat,
                                   rows.nbr3.mask)[1]
        errs[tag] = (max(max(max_err(a, b) for a, b in zip(k64, twin)),
                         max_err(f64, f_twin)), max_err(f32, f_twin))
        print(f"trio weighted ({tag}), {d64.shape[0]} rows, K="
              f"{d64.shape[1]}: f64 max err {errs[tag][0]:.3e} (<= "
              f"{F64_TOL:g}), f32 max |dF| {errs[tag][1]:.3e} eV/A (<= "
              f"{FORCE_TOL:g})")
    w32 = w_halo.float()
    weighted_ms = graph_ms(lambda: trio.trio_partials(
        pot32, d32, v32, False, center_weight=w32))
    triangle_ms = graph_ms(lambda: trio.trio_partials(
        pot32, d32, v32, False, center_weight=w32, triangle=True))
    unweighted_ms = graph_ms(lambda: trio.trio_partials(pot32, d32, v32,
                                                        False))
    plain_ms = cuda_ms(lambda: trio.trio_partials_torch(
        d32, v32, pot32.grid, pot32.trio, False, center_weight=w32), 5)
    live = w_halo != 0
    # the live rows' work, plus the weight read on every row and the
    # zero part / fc / energy written on every row of weight 0
    k = d32.shape[1]
    extra = d32.element_size() * (len(w_halo)
                                  + int((~live).sum()) * (4 + 5 * k))
    bound_ms, bound_by, flop, n_bytes = trio_bound(
        pot32, d32[live], v32[live], False, extra_bytes=extra)
    bound_tri = trio_bound(pot32, d32[live], v32[live], False,
                           extra_bytes=extra, triangle=True)
    occ = trio.trio_occupancy(pot32, d32.shape[1], False,
                              n_atoms=d32.shape[0])
    print(f"trio weighted launch (f32, no energy) on the halo rows: "
          f"{weighted_ms:.4f} ms (graph replay) beside "
          f"{unweighted_ms:.4f} "
          f"ms unweighted on the same {d32.shape[0]} rows, triangle lanes "
          f"(the halo path's) weighted {triangle_ms:.4f} ms, bound "
          f"{bound_tri[0]:.5f} ms ({bound_tri[1]}; {bound_tri[2]:.4g} "
          f"flop); plain "
          f"{plain_ms:.4f} ms; bound over the {int(live.sum())} rows of "
          f"nonzero weight and the zero rows' writes {bound_ms:.5f} ms ({bound_by}; {flop:.4g} flop, "
          f"{n_bytes:.4g} bytes); launch plan {plan_line(occ)}; card: "
          f"{card_line()}")
    gate("trio weighted", {
        f"f64 within {F64_TOL:g}": max(e[0] for e in errs.values())
            <= F64_TOL,
        f"f32 within {FORCE_TOL:g} eV/A": max(e[1] for e in errs.values())
            <= FORCE_TOL,
        "no spills": occ["local_bytes"] == 0})
    return dict(max_abs_err=max(e[1] for e in errs.values()),
                ms=weighted_ms, unweighted_ms=unweighted_ms,
                triangle_ms=triangle_ms, triangle_bound_ms=bound_tri[0],
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, rows=int(d32.shape[0]),
                live_rows=int(live.sum()), k=int(d32.shape[1]),
                registers=occ["registers"], local_bytes=occ["local_bytes"])


def halo_fit(device, mesh, settings_path, features):
    """``fit_sharded`` and ``fit_from_file_sharded`` on the mesh against
    ``model.fit`` on the same rows (the HDF5 store the fit commands
    wrote in ``run_feature_store``, its energy rows per atom):
    predictions within 1e-10 relative."""
    from uf3_tpu_torch.regression import least_squares as ls
    with open(settings_path) as f:
        settings = json.load(f)
    weight = settings["learning"].get("weight", 0.5)

    def fresh():
        return user_config.generate_handlers(settings,
                                             device=device)["learning"]

    host, sharded, streamed = fresh(), fresh(), fresh()
    x_e, y_e, x_f, y_f = ls.feature_rows(
        features, n_elements=len(host.bspline_config.element_list))
    host.fit(x_e, y_e, x_f, y_f, weight=weight)
    pmesh.fit_sharded(sharded, x_e, y_e, x_f, y_f, weight=weight,
                      mesh=mesh)
    pmesh.fit_from_file_sharded(streamed, features,
                                subset=ls.feature_keys(features),
                                weight=weight, mesh=mesh)
    probe = np.concatenate([x_e, x_f])
    p_host = probe @ host.coefficients
    scale = float(np.max(np.abs(p_host)))
    errs = [float(np.max(np.abs(probe @ m.coefficients - p_host))) / scale
            for m in (sharded, streamed)]
    print(f"sharded fit on {mesh.n_shards} shards ({len(y_e)} energy, "
          f"{len(y_f)} force rows of {os.path.basename(features)}): "
          f"predictions vs model.fit, relative {errs[0]:.3e} "
          f"(fit_sharded), {errs[1]:.3e} (fit_from_file_sharded)")
    gate("sharded fit", {f"predictions within {SHARDED_FIT_TOL:g} relative":
                         max(errs) <= SHARDED_FIT_TOL})


def run_halo(device, fit_files=None):
    """Multi-shard MD and fitting on ``torch.distributed``: a NCCL group
    of world size 1 (file store, no TCP port) holding a 4-shard mesh on
    the card.  f64 parity of the halo and replicated paths at full width;
    the f32 production run of the halo chunk, one trio launch per mid
    step for all shards, its collectives halo-sized; the kernel's
    center weight on the path's rows; the sharded fits on the fit
    commands' HDF5 features (``fit_files`` = (settings, features), from
    ``run_feature_store``).  Returns
    (the halo path's trio launches, its weighted-kernel record, rates)."""
    tmp = tempfile.mkdtemp()
    group = init_nccl(device, tmp)
    try:
        mesh = pmesh.make_mesh(HALO_SHARDS, group)
        print(f"halo: {mesh} on {mesh.device}")
        halo_parity_f64(device, mesh)
        launches, rates, system32 = halo_production(device, mesh)
        record = compare_trio_weighted(device, system32, mesh)
        if fit_files is not None:
            halo_fit(device, mesh, *fit_files)
    finally:
        torch.distributed.destroy_process_group()
        shutil.rmtree(tmp)
    return launches, record, rates


def run_multichip_demo(device):
    """The multi-shard example on NCCL, world size 1, 4 shards, float64:
    the halo energy after 5 NVE steps within 1e-8 eV of the single
    device's.  Returns |E_halo - E_single|."""
    out = run_example("multichip_demo", "--shards", str(HALO_SHARDS),
                      device=device)
    found = re.search(r"single-device E after the same steps: \S+ eV "
                      r"\(diff (\S+)\)", out)
    diff = float(found.group(1)) if found else float("nan")
    gate("multichip_demo example", {
        f"|E_halo - E_single| {diff:.2e} <= {DEMO_ENERGY_TOL:g} eV":
            diff <= DEMO_ENERGY_TOL,
        "sharded fit's RMSE printed": "sharded fit:" in out})
    return diff


def main():
    if not torch.cuda.is_available():
        print("no CUDA device: uf3_tpu_torch's kernels need an NVIDIA GPU",
              file=sys.stderr)
        sys.exit(1)
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    environment(device)
    build_kernels()
    records = compare_trio(device)
    tri_records = compare_triangle(device)
    # the gather path: the step anatomy and the gather probes, the
    # gather kernels' counts from 0 over both; then the kernels against
    # their plain versions on the anatomy's system
    reset_counts()
    launches_anatomy, anatomy, parts = run_anatomy(device)
    rev_by_phase = {"step anatomy": gather.rev_gather.launches}
    probes = run_probe_gather(device)
    gather_launches = {fn.__name__: fn.launches for fn in GATHERS}
    rev_by_phase["gather probes"] = \
        gather_launches["rev_gather"] - rev_by_phase["step anatomy"]
    gate("gather path", {f"{name} launched": n > 0
                         for name, n in gather_launches.items()})
    # the fragment path: the fragment probes, the fragment kernels'
    # counts from 0; then the kernels against their plain versions
    reset_counts(FRAGMENTS)
    mosaic = run_probe_mosaic(device)
    fragment_launches = {fn.__name__: fn.launches for fn in FRAGMENTS}
    relayout_modes = dict(fragments.relayout.launches_by_mode)
    gate("fragment path", {f"{name} launched": n > 0
                           for name, n in fragment_launches.items()})
    gather_errors = compare_gather(device, parts)
    fragment_errors = compare_fragments(device)
    langevin = LANGEVIN
    rates, launches, stale = {}, {}, {}
    # the benchmark configuration: 3-level r-RESPA 12/6/36
    name = "3-level r-RESPA 12/6/36"
    system, state, launches["respa3"], rates[name], temps, stale[name] = \
        run_path("3-level r-RESPA", device, BENCH,
                 dict(langevin, launch_chunks=10))
    layer_times(system, state)
    check_path("3-level r-RESPA", system, state, launches["respa3"], temps,
               split=True)
    # plain velocity Verlet with the engine's default arguments
    name = "plain Verlet (defaults)"
    system, state, launches["plain"], rates[name], temps, stale[name] = \
        run_path("plain Verlet", device, {}, langevin)
    layer_times_plain(system, state)
    check_path("plain Verlet", system, state, launches["plain"], temps,
               split=False)
    nve_launches, _, rates["plain Verlet NVE"] = run_nve(system, state)
    launches["plain"] += nve_launches
    # the same path with the pair force and the trio kernel on their own
    # gathers, in the same call
    name = "plain Verlet (defaults), fused=\"separate\""
    launches["fused_separate"], rates[name], stale[name] = \
        run_fused_separate(device)
    # both paths again on the kernel's triangle lanes, then a window of
    # each under the profiler
    run_triangle_paths(device, launches, rates, stale)
    traced, shares = run_tracing(device)
    launches.update(traced)
    launches["step anatomy"] = launches_anatomy
    # 2-level r-RESPA: the bench configuration without a mid level
    name = "2-level r-RESPA 12/36"
    system, state, launches["respa2"], rates[name], temps, stale[name] = \
        run_path("2-level r-RESPA", device, dict(BENCH, respa_mid=1),
                 dict(langevin, launch_chunks=10))
    check_path("2-level r-RESPA", system, state, launches["respa2"],
               temps, split=True)
    name = "plain Verlet, Nose-Hoover"
    launches["nose_hoover"], rates[name], stale[name] = \
        run_nose_hoover(device)
    compare_small_cells(device)
    compare_npt_card_cpu(device)
    launches["npt"], protocol_rates = run_protocol(device)
    launches["melting trial"], melt_log = run_melting_trial(device)
    validation_launches, validation = run_validation(device)
    launches.update({f"validation: {name}": n
                     for name, n in validation_launches.items()})
    measure_launches, measured = run_measurement_scripts(device)
    launches.update(measure_launches)
    rates["md command (2,000 atoms, plain Verlet)"] = run_md_command()[0]
    # the reference's general force path
    name = "2-body W (model_2.json)"
    rates[name], rates[f"{name} NVE"], stale[name] = run_two_body_w(device)
    name = "binary Ne/Xe 2-body (model_pair.json)"
    rates[name], stale[name] = run_binary_pair(device)
    binary = run_binary_trio(device)
    rates["binary Ne/Xe 2+3-body, fused route, NVE (4,000 atoms)"] = \
        binary[0]
    name = "3-body cutoff beyond the 2-body cutoff (separate route)"
    records["K32-separate"], launches["separate_3body"], rates[name], \
        stale[name] = run_separate_3body(device)
    run_async_overflow(device)
    rates["md command, model_2.json (2,000 atoms)"] = run_md_command(
        "model_2.json")[0]
    # the fused multi-species route at full width, and the rebuild
    # schedules
    multi_launches = {"binary 2+3-body, 4,000 atoms, NVE": binary[2]}
    name = "binary Ne/Xe 2+3-body, fused multi-species route"
    record_multi, by_run, rates[name], rates[f"{name} NVE"], stale[name] = \
        run_multi_route(device)
    multi_launches.update({f"multi route 8,788 atoms, {run}": n
                           for run, n in by_run.items()})
    record_ternary = compare_ternary(device)
    name = "plain Verlet (defaults), static_rebuild"
    launches["static_rebuild"], rates[name], stale[name], syncs = \
        run_static_rebuild(device)
    name = "3-level r-RESPA 12/6/36, eager_refilter=False"
    launches["legacy_refilter"], rates[name], stale[name], branches = \
        run_legacy_refilter(device)
    rates["md command --static-rebuild (2,000 atoms)"] = run_md_command(
        "model_2and3.json", "--static-rebuild")[0]
    # the calculator and what runs on it (ROADMAP.md item 4)
    calc64, calc_geom, calc_launches, calc_kernel, calc_times = \
        run_calculator(device)
    launches.update(calc_launches)
    fire_calls, fire_s = run_fire(calc64, calc_geom)
    launches["FIRE, 9,826 atoms, f64"] = fire_calls
    launches.update(run_properties(device))
    launches["export round trip, 9,826 atoms, f64"] = run_export(
        calc64, calc_geom)
    launches["checkpoint round trip, 9,826 atoms"] = run_checkpoint(device)
    multi_launches["batch_relax, 108/108/256 atoms"] = \
        run_batch_relax(device)
    multi_launches["calculator, 8,788 atoms, f64"], multi_kernel, \
        multi_times = run_calculator_multi(device)
    rates["md --traj (2,000 atoms)"] = run_md_traj()
    # the fit on the card (ROADMAP.md item 5), and the multi-species fit
    fit_keep = tempfile.mkdtemp()
    fit_launches, labeled = run_fit(device)
    launches.update(fit_launches)
    store_dir = tempfile.mkdtemp()
    launches["data pipeline: md command"], pipeline = run_data_pipeline(
        device, labeled, keep=store_dir)
    launches["feature store: md command"] = run_feature_store(
        device, labeled, pipeline, keep=fit_keep)
    shutil.rmtree(store_dir)
    launches["last surface: native backend"] = run_last_surface(
        device, labeled)
    del labeled, pipeline
    multi_launches.update(run_fit_multi(device))
    # multi-shard MD and fitting on torch.distributed
    launches["halo"], halo_record, halo_rates = run_halo(device, tuple(
        os.path.join(fit_keep, name) for name in ("settings.json",
                                                  "features.h5")))
    shutil.rmtree(fit_keep)
    demo_diff = run_multichip_demo(device)
    rates["halo 3-level r-RESPA 12/6, 4 shards, NVE (triangle lanes)"] = \
        halo_rates["rate"]
    rates["single device, 3-level r-RESPA 12/6/36, NVE (beside the "
          "halo run)"] = halo_rates["rate_single"]
    card = card_line()
    for name, rate in rates.items():
        print(f"MD {name}: {rate:.1f} atom-steps/s"
              + (f" (median of 3 x {WINDOW_STEPS} steps), stale="
                 f"{stale[name]}" if name in stale else "")
              + f", card: {card}")
    for name, rate in protocol_rates.items():
        print(f"MD melting protocol stage {name}: {rate:.1f} atom-steps/s "
              f"({STAGE_STEPS} steps, 31104 atoms, float32), card: {card}")
    print(f"melting trial ({MELT_T:g} K, {melt_log['n_atoms']} atoms, "
          f"prep_scale {MELT_PREP_SCALE:g}, n_obs {MELT_OBS}): verdict "
          f"{melt_log['verdict']}, series "
          f"{melt_log.get('solid_fraction_series')}, obs_atom_steps_per_s "
          f"{melt_log.get('obs_atom_steps_per_s')}, card: {card}")
    for name, result in validation.items():
        if "drift_trace_ev_per_atom" in result:
            drift = result["final_drift_ev_per_atom"]
            print(f"{name}: final drift {drift:.3e}, secular heating "
                  f"{result['secular_heating_ev_per_atom_over_run']:.3e} "
                  f"eV/atom (f32, 9,826 atoms), card: {card}")
        elif "samples" in result:
            print(f"{name}: worst force error past the stale line "
                  f"{result['max_force_error_past_stale_line_eV_A']} eV/A "
                  f"(9,826 atoms), card: {card}")
    for name, result in measured.items():
        if "e2e_ms_per_step" in result:
            print(f"{name} (9,826 atoms, f32): e2e "
                  f"{result['e2e_ms_per_step']:.5f} ms/step, cycle model "
                  f"device {result['cycle_model_device_ms_per_step']:.5f}, "
                  f"host {result['cycle_model_ms_per_step']:.5f}; card: {card}")
        elif "sizes" in result:
            for row in result["sizes"]:
                print(f"{name}: {row['n_atoms']} atoms, "
                      + (f"{row['atom_steps_per_s']:.1f} atom-steps/s, busy "
                         f"share {row['busy_share']:.3f}"
                         if "atom_steps_per_s" in row else
                         f"full build {row['host_ms']:.4f} ms host, "
                         f"{row['device_busy_ms']:.4f} ms card busy, "
                         f"{row['host_syncs']} host syncs")
                      + f"; card: {card}")
        else:
            print(f"{name}: featurize {result['featurize_ms_per_config']:.4f}"
                  f" ms a configuration"
                  + (f", solve {result['solve_s']:.4f} s"
                     if "solve_s" in result else "") + f"; card: {card}")
    print(f"multichip_demo (NCCL, world size 1, {HALO_SHARDS} shards, "
          f"f64): |E_halo - E_single| {demo_diff:.3e} eV")
    for route, (dev_ms, hst_ms) in binary[1].items():
        print(f"binary 2+3-body, 4,000 atoms, {route}: device "
              f"{dev_ms:.4f} ms, host {hst_ms:.4f} ms per call, card: {card}")
    print(f"host syncs per cycle, plain Verlet defaults, 9,826 atoms: "
          f"{syncs}, card: {card}")
    print(f"3-level r-RESPA, eager_refilter=False: cycles by branch "
          f"{branches}")
    for tag, (hst_ms, dev_ms) in dict(calc_times, multi=multi_times).items():
        print(f"calculator {tag}: get_forces {hst_ms:.4f} ms per call on "
              f"the host, device busy {dev_ms:.4f} ms, card: {card}")
    print(f"FIRE relaxation, 9,826 atoms, f64: {fire_calls} force calls in "
          f"{fire_s:.3f} s, card: {card}")
    print(f"halo path: {halo_rates['bytes_per_step']:.1f} bytes put into "
          f"collectives per step, decompositions per window "
          f"{halo_rates['decompositions']}; trio weighted launch "
          f"{halo_record['ms']:.4f} ms beside "
          f"{halo_record['unweighted_ms']:.4f} ms unweighted "
          f"({halo_record['rows']} rows, {halo_record['live_rows']} of "
          "nonzero weight), bound "
          f"{halo_record['bound_ms']:.5f} ms; triangle lanes weighted "
          f"{halo_record['triangle_ms']:.4f} ms; card: {card}")
    print(f"halo chunk on the triangle lanes: {halo_rates['rate']:.1f} "
          f"atom-steps/s beside {halo_rates['rate_single']:.1f} single-device"
          f" in this call; card: {card}")
    print(f"step anatomy, 9,826 atoms: inner step "
          f"{anatomy['ms']['p4_full_inner_step']:.5f} ms device (graph "
          f"replay), {anatomy['host_ms']['p4_full_inner_step']:.5f} ms host "
          f"(eager); gather kernel launches on the gather path "
          f"{gather_launches}; rev_gather's by phase {rev_by_phase}; "
          f"card: {card}")
    print(f"fragment kernel launches on the fragment path "
          f"{fragment_launches}; relayout's by mode {relayout_modes}; "
          f"card: {card}")
    for name, share in shares.items():
        print(f"device busy share, one traced {WINDOW_STEPS}-step window of "
              f"{name} (9,826 atoms, f32): {100 * share:.1f}%, card: {card}")
    print(f"trio launches by path: {launches}")
    print(f"multi-species trio launches by path: {multi_launches}")
    print(f"trio_partials K=16, 9,826 atoms: {records['K16']['ms']:.4f} ms; "
          f"trio_multi_partials_all, 8,788-atom binary cell: "
          f"{record_multi['ms']:.4f} ms per force call, 1 launch; ternary "
          f"cut: {record_ternary['ms']:.4f} ms; card: {card}")
    record = dict(records["K16"], max_abs_err=max(
        [r["max_abs_err"] for r in records.values()]
        + [r["max_abs_err"] for r in tri_records.values()]
        + [halo_record["max_abs_err"]]))
    print(json.dumps({"kernels": [
        dict(name="trio_partials", route="cuda",
             source="uf3_tpu_torch/csrc/trio.cu",
             replaces="uf3_tpu/ops/pallas_trio.py:1044",
             launches=sum(launches.values()), launches_by_path=launches,
             **record, by_shape=records, calculator_f64=calc_kernel,
             center_weight=halo_record, triangle=tri_records),
        dict(name="trio_multi_partials_all", route="cuda",
             source="uf3_tpu_torch/csrc/trio_multi.cu",
             replaces="uf3_tpu/ops/pallas_trio.py:1337",
             launches=sum(multi_launches.values()),
             launches_by_path=multi_launches,
             **dict(record_multi, max_abs_err=max(
                 record_multi["max_abs_err"], record_ternary["max_abs_err"])),
             ternary=record_ternary, calculator_f64=multi_kernel)] + [
        dict(name=name, route="cuda", source="uf3_tpu_torch/csrc/gather.cu",
             replaces=GATHER_REPLACES[name],
             launches=gather_launches[name], max_abs_err=gather_errors[name],
             **record,
             **({"launches_by_phase": rev_by_phase}
                if name == "rev_gather" else {}),
             probe_cases={case: dict(
                 ms=rec["kernel_ms"], library_ms=rec["library_ms"],
                 plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"])
                 for case, rec in probes["cases"].items()
                 if rec["kind"] == probe_gather.KIND[name]})
        for name, record in gather_records(anatomy, probes).items()] + [
        dict(name=name, route="cuda",
             source="uf3_tpu_torch/csrc/fragments.cu",
             replaces=FRAGMENT_REPLACES[name],
             launches=fragment_launches[name],
             max_abs_err=fragment_errors[name], **record,
             **({"launches_by_mode": relayout_modes}
                if name == "relayout" else {}),
             probe_cases={f"{case} [{size}]": dict(
                 ms=rec["kernel_ms"], library_ms=rec["library_ms"],
                 plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"])
                 for case, sizes in mosaic["cases"].items()
                 for size, rec in sizes.items() if rec["kernel"] == name})
        for name, record in fragment_records(mosaic, device).items()]}))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
