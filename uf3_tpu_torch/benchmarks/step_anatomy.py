"""
Anatomy of the MD inner step on the card: where each microsecond goes.
Port of ``benchmarks/step_anatomy.py``.

The r-RESPA inner step (the switched short pair force and the trio
force on the (N, 16) 3-body rows, velocity Verlet and the Langevin
kick) is the throughput floor of the MD engine: the tail and rebuild
costs amortize, the inner step does not.  The script measures
cumulative prefixes of the step on the bench model's system (bcc W
17^3 = 9,826 atoms, 2-level r-RESPA with n_respa = 3, after 36 Langevin
steps at 300 K), each built from the port's own functions:

    scan_null           carry arithmetic only (the chain's baseline)
    p0_gather_comps     the neighbor gather, shifts, displacements, r
    p1_plus_pair_chain  P0 + the switched short-range pair chain
                        (``ops/pair.py``)
    p2_plus_trio_map    P0 + the trio kernel (``csrc/trio.cu``), no
                        cross-atom assembly
    p3_force_eval       P2 + the reverse-slot assembly
                        (``trio.assemble_forces``)
    p4_full_inner_step  ``trio_short_forces`` + velocity Verlet + the
                        engine's Langevin kick from its own generator
    langevin_only       the Langevin kick alone

plus an FMA chain on the trio's (N, K*K) lane shape and the step's two
neighbor gathers alone, each a kernel of ``csrc/gather.cu`` beside the
library call and the plain version, with its bound (bytes): the row
gather of the positions through the 3-body list (``kernel_gather``,
``gather_rows``; ``library_gather_ms`` is ``x[idx]``) and the
reverse-slot gather of the (N, 16, 5) slot partials
(``kernel_rev_gather``, ``rev_gather``; ``part[idx, rev]``).  A gather
is timed as 30 calls of it in one CUDA graph.

JAX chained each body through ``lax.scan`` to cancel the dispatch; here
30 chained bodies are captured in one CUDA graph and replayed between
CUDA events (``ms``: the device floor of each piece).  The same chain
also runs eagerly on the host clock, ended by a synchronize
(``host_ms``): the gap between the two is the host cost that the MD
path pays per step.  The Langevin bodies draw from the state's own
generator, registered with the graph, so each replay draws new noise.

The JAX script's ``p2`` variants ``b256`` / ``b512`` / ``b1024`` are block
sizes of XLA's ``lax.map`` over the trio body; the trio kernel takes
one warp per atom and has no such block, so they have no counterpart.
The JAX FMA chain fused into one XLA kernel measured the TPU's vector
rate; eager torch launches one ``addcmul`` per FMA, so the chain here
measures a run of memory-bound elementwise kernels.

    python -m uf3_tpu_torch.benchmarks.step_anatomy [--device cpu]

writes ``benchmarks_data/artifacts_torch/anatomy_<commit>.json``.  On
the CPU (``--device cpu``, float64, at ``--reps``) it runs the plain
versions and gives host times only: the device keys are null.
"""

import argparse
import json
import os
from typing import NamedTuple

import numpy as np
import torch

from uf3_tpu_torch.benchmarks import common, probe_gather
from uf3_tpu_torch.data.atoms import bulk
from uf3_tpu_torch.forcefield import units
from uf3_tpu_torch.forcefield.md import MDSystem
from uf3_tpu_torch.ops import gather
from uf3_tpu_torch.ops import neighbors as nb
from uf3_tpu_torch.ops import trio
from uf3_tpu_torch.ops.pair import pair_row_forces

MODEL = os.path.join(common.REPO, "benchmarks_data", "model_2and3.json")
# benchmarks/step_anatomy.py:78-86
REPS = (17, 17, 17)
SYSTEM = dict(rebuild_every=18, skin=0.5, skin_2b=1.2, capacity_2b=72,
              capacity_3b=16, n_respa=3)
WARM_STEPS = 36
TEMPERATURE = 300.0
DT_FS = 2.0
FRICTION_PS = 2.0
FMA_DEPTH = 64
EPS = 1e-30


class StepParts(NamedTuple):
    """What the inner step's pieces read at the measured positions: the
    potential, the 3-body list and its per-cycle invariants, the switch
    band and short-force window, and the integrator's constants and
    noise stream."""
    positions: torch.Tensor   # (N, 3), where the chains start
    potential: object
    nbr3: nb.NeighborList
    cache3: nb.ListCache
    cell: torch.Tensor
    r_lo: float
    r_hi: float
    n_basis_short: int
    masses: torch.Tensor      # (N, 1)
    dt: float
    c1: float
    cn: torch.Tensor          # (N, 1)
    generator: torch.Generator

    @classmethod
    def from_system(cls, system: MDSystem, state):
        """The parts of ``system`` at ``state``'s lists and cell."""
        dt = DT_FS * units.fs
        c1 = float(np.exp(-(FRICTION_PS / units.ps) * dt))
        masses = system.masses[:, None]
        r_lo, r_hi = system.respa_switch
        return cls(state.positions, system.potential, state.nbr3,
                   nb.list_cache(state.nbr3, state.cell, system.dtype),
                   state.cell, r_lo, r_hi, system.n_basis_short, masses,
                   dt, c1, torch.sqrt((1 - c1 ** 2) * units.kB
                                      * TEMPERATURE / masses),
                   state.generator)


def gather_comps(p: StepParts, x):
    """P0: the neighbor gather with the list's shifts, displacements d
    (N, K, 3) and r (N, K)."""
    d = nb.cached_displacements(x, p.nbr3, p.cache3)
    r2 = torch.sum(d * d, dim=-1)
    return d, torch.sqrt(torch.where(r2 > 0, r2, torch.ones_like(r2)))


def pair_short(p: StepParts, d):
    """P1's pair chain: the switched short-range pair force (N, 3) on
    the 3-body rows."""
    spec = p.potential.pair_spec
    return pair_row_forces(p.potential.pair_coefficients, d,
                           p.cache3.valid, spec, p.n_basis_short,
                           with_energy=False, side="short", r_lo=p.r_lo,
                           r_hi=p.r_hi)[1]


def trio_map(p: StepParts, d):
    """P2's trio pass: energy, center force and slot partials."""
    return trio.trio_partials(p.potential, d, p.cache3.valid,
                              with_energy=False)


def force_eval(p: StepParts, d):
    """P3: the 3-body force (N, 3), the trio pass and its reverse-slot
    assembly."""
    energy, f_center, part = trio_map(p, d)
    return trio.assemble_forces(energy, f_center, part, d,
                                p.cache3.rev_flat, p.nbr3.mask)[1]


def _noise(p: StepParts, x):
    return torch.randn(x.shape, generator=p.generator, dtype=x.dtype,
                       device=x.device)


def bodies(p: StepParts) -> dict:
    """Each prefix as a chainable body x -> x' on the positions (N, 3),
    in the order of the JAX script."""
    eps = EPS

    def p0(x):
        d, r = gather_comps(p, x)
        return x + eps * torch.sum(d, dim=1) * r[:, :1]

    def p1(x):
        d, _ = gather_comps(p, x)
        return x + eps * pair_short(p, d)

    def p2(x):
        d, r = gather_comps(p, x)
        _, f_center, part = trio_map(p, d)
        return x + eps * (f_center + part[:, 0, :3] + r[:, :3])

    def p3(x):
        d, _ = gather_comps(p, x)
        return x + eps * force_eval(p, d)

    def p4(x):
        f = trio.trio_short_forces(
            p.potential, x, p.cell, p.nbr3, p.n_basis_short,
            with_energy=False, r_lo=p.r_lo, r_hi=p.r_hi,
            cache3=p.cache3)[2]
        v = eps * x + 0.5 * p.dt * f / p.masses
        xn = x + p.dt * v
        v = p.c1 * v + p.cn * _noise(p, v)
        return xn + eps * v

    def langevin(x):
        return p.c1 * x + eps * p.cn * _noise(p, x)

    return {"scan_null": lambda x: x * (1.0 + eps),
            "p0_gather_comps": p0, "p1_plus_pair_chain": p1,
            "p2_plus_trio_map": p2, "p3_force_eval": p3,
            "p4_full_inner_step": p4, "langevin_only": langevin}


def gathers(p: StepParts) -> dict:
    """The step's two neighbor gathers at its own shapes, each as (kind,
    operands): the positions' row gather through the 3-body list
    (``gather``, the JAX script's Pallas ``gk``) and the reverse-slot
    gather of the trio kernel's slot partials at these positions
    (``rev_gather``, the gather of ``trio.assemble_forces``)."""
    d, _ = gather_comps(p, p.positions)
    part = trio_map(p, d)[2]
    return {"gather": ("rows", (p.positions, p.nbr3.idx)),
            "rev_gather": ("rev", (part, p.nbr3.idx, p.nbr3.rev))}


def setup(device, reps=REPS, warm_steps: int = WARM_STEPS):
    """The anatomy's system (float32 on a card, float64 on the CPU) and
    its state after ``warm_steps`` Langevin steps at 300 K."""
    dtype = torch.float32 if device.type == "cuda" else torch.float64
    geom = bulk("W", "bcc", a=3.1652) * tuple(reps)
    system = MDSystem(MODEL, geom, dtype=dtype, device=device, **SYSTEM)
    state = system.init_state(temperature=TEMPERATURE, seed=0)
    state = system.run(state, n_steps=warm_steps, dt_fs=DT_FS,
                       thermostat="langevin", temperature=TEMPERATURE)
    if system.overflowed(state):
        raise RuntimeError("neighbor overflow in the anatomy's warm-up")
    return system, state


def measure(p: StepParts, scan_len: int = common.SCAN_LEN) -> dict:
    """The prefixes' device ms (graph replay; None on the CPU) and host
    ms (eager), the FMA chain and the two gathers, each chain starting at
    ``p.positions``, under the JAX artifact's keys where their meaning
    carries over."""
    x0 = p.positions
    on_card = x0.is_cuda
    n, k3 = p.nbr3.idx.shape

    def device_ms(fn, x, generators=()):
        return common.graph_chain_ms(fn, x, scan_len, generators) \
            if on_card else None

    ms, host = {}, {}
    for name, fn in bodies(p).items():
        noisy = name in ("p4_full_inner_step", "langevin_only")
        ms[name] = device_ms(fn, x0, (p.generator,) if noisy else ())
        host[name] = common.host_chain_ms(fn, x0, scan_len)
    lanes = torch.ones((n, k3 * k3), dtype=x0.dtype, device=x0.device)
    a = torch.tensor(1.0000001, dtype=x0.dtype, device=x0.device)
    b = torch.tensor(1e-9, dtype=x0.dtype, device=x0.device)

    def fma_chain(y):
        for _ in range(FMA_DEPTH):
            y = torch.addcmul(b, y, a)
        return y

    flop = n * k3 * k3 * FMA_DEPTH * 2
    ms["fma_chain_ms"] = device_ms(fma_chain, lanes)
    ms["fma_achieved_gflops"] = None if ms["fma_chain_ms"] is None \
        else flop / (ms["fma_chain_ms"] * 1e-3) / 1e9
    host["fma_chain_ms"] = common.host_chain_ms(fma_chain, lanes, scan_len)
    rows = n * k3
    for label, (kind, ops) in gathers(p).items():
        out = gather.KERNELS[kind](*ops)
        calls = {"kernel": lambda: gather.KERNELS[kind](*ops),
                 "library": probe_gather.library_call(kind, ops),
                 "plain": lambda: gather.PLAIN[kind](*ops)}
        bound_ms, bound_by, n_bytes = gather.gather_bound(kind, out, *ops)
        ref = calls["plain"]()
        record = {"correct": bool(torch.equal(out, ref) and torch.equal(
            calls["library"](), ref)), "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": n_bytes}
        for name, fn in calls.items():
            t = common.graph_ms(fn, scan_len) if on_card else None
            host[f"{name}_{label}_ms"] = common.host_chain_ms(
                lambda x: (fn(), x)[1], x0, scan_len)
            per_row = None if t is None else t * 1e6 / rows
            if name == "kernel":
                record.update(ms=t, ns_per_row=per_row)
                ms[f"kernel_{label}"] = record
            else:
                ms[f"{name}_{label}_ms"] = t
                ms[f"{name}_{label}_ns_per_row"] = per_row
    return {"ms": ms, "host_ms": host}


def main(device=None, reps=REPS, warm_steps: int = WARM_STEPS,
         scan_len: int = common.SCAN_LEN, out_dir: str = common.ARTIFACTS,
         commit: str = None):
    """Run the anatomy and write ``anatomy_<commit>.json`` to
    ``out_dir``.  Returns (artifact, parts): the parts hold the
    measured positions and their lists, for checks on the same rows."""
    device = common.resolve_device(device)
    system, state = setup(device, reps, warm_steps)
    parts = StepParts.from_system(system, state)
    x0 = parts.positions
    artifact = common.header(device, commit)
    artifact.update(n_atoms=int(x0.shape[0]), k3=int(state.nbr3.idx.shape[1]),
                    dtype=str(system.dtype).replace("torch.", ""),
                    scan_len=scan_len)
    artifact.update(measure(parts, scan_len))
    path = common.write_artifact(artifact, out_dir,
                                 f"anatomy_{artifact['commit']}.json")
    print(json.dumps(artifact, indent=1))
    print(f"wrote {path}")
    return artifact, parts


def cli(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--reps", type=int, nargs=3, default=REPS,
                        help="bcc W supercell (default 17 17 17)")
    parser.add_argument("--out-dir", default=common.ARTIFACTS)
    parser.add_argument("--commit", default=None,
                        help="the artifact's tag (default: git's short "
                             "commit)")
    args = parser.parse_args(argv)
    main(args.device, tuple(args.reps), out_dir=args.out_dir,
         commit=args.commit)


if __name__ == "__main__":
    cli()
