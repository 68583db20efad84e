"""
Speed-of-light budget of one step of the bench path on the card.  Port
of ``benchmarks/budget_step.py``: its purpose, not its TPU formulation.

Two counts of the step's work, whatever implements it, are the
reference's as they are: ``useful_flops_per_step`` (real pairs and
triangles at the bench's coordination with the minimal 4-tap spline
algebra) and ``hbm_bytes_per_step`` (the inner step's memory traffic).
The per-phase counts are the port's own, on the bench state's rows
(bcc W 17^3 = 9,826 atoms, the bench engine, after bench's 144-step
Langevin warm-up from seed 0):

    inner (every step)     pair_short_forces: ``ops.pair.pair_flop`` on
                           the (N, 16) rows' live lanes; the position
                           gather's bytes (``ops.gather.gather_bytes``)
                           and the rows' other operands
    trio (every 6th)       ``ops.trio.trio_bound`` on the same rows, and
                           the assembly: its reverse-slot gather's bytes
                           and ``ASSEMBLY_FLOP`` per live slot
    tail (every 12th)      pair_tail_forces: ``pair_flop`` on the (N, 72)
                           rows' live lanes, their gather's bytes

Each phase's floor is the larger of its flop over the card's float32
peak (``ops.fragments.PEAK_FLOPS``, 67 TFLOP/s) and its bytes over the
memory rate (``ops.gather.PEAK_BYTES``, 3.35 TB/s); the step's floor is
cycle-weighted as the reference weighs it: inner + trio / respa_mid +
tail / n_respa.  The triggers, the thermostat and the rebuilds are not
in it, as in the reference.

Measured: the anatomy (``anatomy_3l_12_6_36.json``) and the newest gate
artifact (``bench_*.json``, newest by its own ``timestamp``: a checkout
sets every file's time) under ``--artifacts``.  Against the gate's
median step (the anatomy's where no gate artifact is there), measured on
a card at this run's atom count: the whole step's useful flop at peak
over the step (``useful_share_of_peak``), the same for the port's own
flop a step (``port_flop_share_of_peak``), and the step's floor over
the step (``floor_share_of_step``).  A CPU artifact gives no share.

    python -m uf3_tpu_torch.benchmarks.budget_step [--device cpu]
        [--reps 17 17 17] [--artifacts DIR] [--out-dir DIR]

writes ``budget_step.json`` under ``benchmarks_data/artifacts_torch/``.
"""

import argparse
import glob
import json
import os

import torch

from uf3_tpu_torch.benchmarks import anatomy_3l, bench, common
from uf3_tpu_torch.ops import gather
from uf3_tpu_torch.ops.fragments import PEAK_FLOPS
from uf3_tpu_torch.ops.pair import pair_flop
from uf3_tpu_torch.ops.trio import trio_bound

# assemble_forces (ops/trio.py) per live slot: r (6), d / r (3), the
# three partial terms (6), their sum (6) and the row's sum (3)
ASSEMBLY_FLOP = 24


def useful_flops_per_step(n_atoms, coord_3b=14, coord_2b=65,
                          c_window=9, n_b=3):
    """Physics floor: ops that touch only REAL pairs/triangles with
    the minimal 4-tap spline algebra (no padding, no dense windows).
    Per triangle: 3 legs x 4-tap eval+deriv (~30 FMA) + 4x4x4
    tensor-product contraction against the grid (~64 FMA) + force
    product rule (~20).  Per pair: 4-tap eval+deriv + force (~20).
    (benchmarks/budget_step.py:113-123)"""
    triangles = n_atoms * coord_3b * (coord_3b - 1) // 2
    pairs = n_atoms * coord_2b
    return triangles * 2 * (30 + 64 + 20) + pairs * 2 * 20


def hbm_bytes_per_step(n_atoms, k2, k3, respa_inner=True):
    """Memory traffic of one inner step: the (N, K3) neighbor
    structures read by the gathers, positions / velocities / forces
    read and written, and the packed partials (N, K3*8) out and back.
    (benchmarks/budget_step.py:125-137)"""
    f32 = 4
    state = 3 * (n_atoms * 3 * f32) * 2          # x, v, f r+w
    k = k3 if respa_inner else k2
    lists = n_atoms * k * f32 * 3                # idx + sd-ish + mask
    gathered = n_atoms * k * 3 * f32             # neighbor positions
    packed = n_atoms * k * 8 * f32 * 2           # partials out + back
    return state + lists + gathered + packed


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def floor_ms(flop: float, n_bytes: int, dtype) -> dict:
    """A phase's floor: the larger of its flop over the card's peak for
    ``dtype`` and its bytes over the memory rate."""
    t_flop = 1e3 * flop / PEAK_FLOPS[dtype]
    t_bytes = 1e3 * n_bytes / gather.PEAK_BYTES
    return {"flop": flop, "bytes": n_bytes, "ms": max(t_flop, t_bytes),
            "bound_by": "operations" if t_flop >= t_bytes else "bytes"}


def row_phase(system, x, nbr, cache, side: str) -> dict:
    """A pair force on one list's rows: the chain's flop on the live
    lanes and, read once, the gather's bytes (indices, output, the
    sectors of the positions reached), the shift products and the mask,
    with the forces written once."""
    pot = system.potential
    r_lo, r_hi = system.respa_switch
    d = x[nbr.idx] + cache.sd - x[:, None, :]
    flop, lanes = pair_flop(d, cache.valid, pot.pair_spec, side=side,
                            r_lo=r_lo, r_hi=r_hi)
    n_bytes = (gather.gather_bytes("rows", x[nbr.idx], x, nbr.idx)
               + nbytes(cache.sd, cache.valid, x))
    return dict(floor_ms(flop, n_bytes, x.dtype), live_lanes=lanes)


def phase_counts(system, state) -> dict:
    """The inner, trio and tail phases' work on ``state``'s rows."""
    x = state.positions
    nbr2, nbr3 = state.nbr2, state.nbr3
    cache2, cache3 = system.list_caches(nbr2, nbr3, state.cell)
    pot = system.potential
    inner = row_phase(system, x, nbr3, cache3, "short")
    tail = row_phase(system, x, nbr2, cache2, "tail")
    d3 = x[nbr3.idx] + cache3.sd - x[:, None, :]
    _, _, trio_flop, trio_bytes = trio_bound(pot, d3, cache3.valid, False)
    part = torch.zeros(d3.shape[:2] + (5,), dtype=x.dtype, device=x.device)
    slots = int(nbr3.mask.sum())
    trio = floor_ms(
        trio_flop + ASSEMBLY_FLOP * slots,
        trio_bytes + gather.gather_bytes("rev", part, part, nbr3.idx,
                                         nbr3.rev) + nbytes(x),
        x.dtype)
    trio.update(live_slots=slots, kernel_flop=trio_flop,
                kernel_bytes=trio_bytes)
    return {"inner": inner, "trio": trio, "tail": tail}


def newest_gate(artifacts: str):
    """(name, artifact) of the gate artifact with the latest
    ``timestamp`` under ``artifacts``, or (None, None)."""
    found = []
    for path in glob.glob(os.path.join(artifacts, "bench_*.json")):
        with open(path) as f:
            found.append((json.load(f), os.path.basename(path)))
    if not found:
        return None, None
    gate, name = max(found, key=lambda item: (item[0].get("timestamp") or "",
                                              item[1]))
    return name, gate


def measured(artifacts: str, cadence, n_atoms: int) -> dict:
    """The anatomy's and the newest gate artifact's figures, and the
    measured ms a step on a card at ``n_atoms`` atoms (the gate's median
    step, else the anatomy's; None where neither is there)."""
    out = {"e2e_ms_per_step": None, "e2e_from": None}
    name = anatomy_3l.artifact_name(cadence)
    path = os.path.join(artifacts, name)
    if os.path.exists(path):
        with open(path) as f:
            an = json.load(f)
        out.update(anatomy_artifact=name,
                   phase_device_ms=an.get("net_of_null_ms"),
                   anatomy_e2e_ms_per_step=an.get("e2e_ms_per_step"),
                   cycle_model_device_ms_per_step=an.get(
                       "cycle_model_device_ms_per_step"),
                   cycle_model_ms_per_step=an.get("cycle_model_ms_per_step"))
        if an["config"]["platform"] == "gpu" \
                and an["config"]["n_atoms"] == n_atoms:
            out.update(e2e_ms_per_step=an["e2e_ms_per_step"],
                       e2e_from=name)
    gate_name, gate = newest_gate(artifacts)
    if gate is not None:
        out.update(gate_artifact=gate_name,
                   gate_atom_steps_per_s=gate["value"],
                   gate_breakdown_ms=gate["breakdown_ms"],
                   gate_card=gate.get("card"))
        if gate["platform"] == "gpu" \
                and gate["config"]["n_atoms"] == n_atoms:
            out.update(e2e_ms_per_step=1e3 * n_atoms / gate["value"],
                       e2e_from=gate_name)
    return out


def run(reps=bench.REPS, device=None, artifacts: str = common.ARTIFACTS,
        commit: str = None) -> dict:
    """The budget of the bench step on bcc W ``reps``."""
    device = common.resolve_device(device)
    system, state = bench.bench_system(reps, device)
    state = system.run(state, **bench.langevin(bench.WARM_STEPS))
    n = state.positions.shape[0]
    cadence = (system.n_respa, system.respa_mid, system.rebuild_every)
    phases = phase_counts(system, state)
    floor = (phases["inner"]["ms"] + phases["trio"]["ms"] / cadence[1]
             + phases["tail"]["ms"] / cadence[0])
    port_flop = (phases["inner"]["flop"] + phases["trio"]["flop"] / cadence[1]
                 + phases["tail"]["flop"] / cadence[0])
    useful = useful_flops_per_step(n)
    peak = PEAK_FLOPS[system.dtype]
    budget = {
        "config": {"n_atoms": n, "capacity_2b": system.capacity_2b,
                   "capacity_3b": system.capacity_3b,
                   "n_respa": cadence[0], "respa_mid": cadence[1],
                   "rebuild_every": cadence[2],
                   "n_basis_short": system.n_basis_short,
                   "dtype": str(system.dtype).replace("torch.", ""),
                   "platform": common.platform(device),
                   "peak_flops": peak, "peak_bytes": gather.PEAK_BYTES},
        "useful_physics_flops_per_step": useful,
        "hbm_bytes_per_step": hbm_bytes_per_step(
            n, system.capacity_2b, system.capacity_3b),
        "phases": phases,
        "port_flop_per_step": port_flop,
        "speed_of_light_ms": {
            "inner": phases["inner"]["ms"], "trio": phases["trio"]["ms"],
            "tail": phases["tail"]["ms"],
            "useful_at_peak": 1e3 * useful / peak,
            "port_flop_at_peak": 1e3 * port_flop / peak},
        "per_step_floor_ms": floor,
    }
    found = measured(artifacts, cadence, n)
    e2e = found["e2e_ms_per_step"]
    found.update(
        useful_share_of_peak=None if e2e is None
        else budget["speed_of_light_ms"]["useful_at_peak"] / e2e,
        port_flop_share_of_peak=None if e2e is None
        else budget["speed_of_light_ms"]["port_flop_at_peak"] / e2e,
        floor_share_of_step=None if e2e is None else floor / e2e)
    budget["measured"] = found
    budget["conclusions"] = conclusions(budget)
    return common.stamp(budget, device, commit)


def conclusions(budget: dict) -> dict:
    """The budget's figures in words: the floor, the ceiling it sets,
    and how far the measured step lies from it."""
    n = budget["config"]["n_atoms"]
    floor = budget["per_step_floor_ms"]
    phases = budget["phases"]
    found = budget["measured"]
    out = {"per_step_floor_ms": floor,
           "ceiling_atom_steps_per_s": 1e3 * n / floor,
           "bound_by": {k: v["bound_by"] for k, v in phases.items()}}
    if found["e2e_ms_per_step"] is None:
        out["against_the_step"] = "not measured: no card artifact at " \
            f"{n} atoms under the artifacts read"
        return out
    out["against_the_step"] = (
        f"The measured step ({found['e2e_from']}) takes "
        f"{found['e2e_ms_per_step']:.5f} ms against a floor of "
        f"{floor:.5f} ms ({100 * found['floor_share_of_step']:.2f}%): the "
        f"useful flop would take {100 * found['useful_share_of_peak']:.3f}% "
        f"of it at the card's peak, the port's own flop "
        f"{100 * found['port_flop_share_of_peak']:.3f}%.  The rest is the "
        "host's launches, the triggers, the thermostat and the rebuilds, "
        "and the kernels' distance from their bounds.")
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--reps", type=int, nargs=3, default=bench.REPS,
                        help="bcc W supercell (default 17 17 17)")
    parser.add_argument("--artifacts", default=common.ARTIFACTS,
                        help="where the anatomy and gate artifacts are read")
    parser.add_argument("--out-dir", default=common.ARTIFACTS)
    args = parser.parse_args(argv)
    budget = run(tuple(args.reps), device=args.device,
                 artifacts=args.artifacts)
    path = common.write_artifact(budget, args.out_dir, "budget_step.json")
    print(json.dumps(budget))
    print(f"wrote {path}")
    return budget


if __name__ == "__main__":
    main()
