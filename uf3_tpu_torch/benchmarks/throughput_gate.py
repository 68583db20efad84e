"""
The throughput gate on the card: fails when the bench path's rate, or a
phase's device time, regresses.  Port of
``benchmarks/throughput_gate.py``.

The end-to-end figure is the headline bench's line (``bench.run``:
bcc W 17^3 = 9,826 atoms, the bench engine, float32, 144 warm-up steps,
one warm window, then 5 timed windows of 720 steps; the median
window's atom-steps/s).  Then the reference's per-phase breakdown at
the equilibrated state under its five keys, each phase from the port's
own functions, and one key more:

    fused_forces        MDSystem.energy_forces(x, nbr2, nbr3,
                        with_energy=False), the lists' caches passed
    respa_inner_short   pair_short_forces on the (N, 16) rows
                        (``anatomy_3l.inner_force``): the port's inner
                        force, which on the 3-level step holds no 3-body
                        term.  The reference's key times
                        ``trio_short_forces``, the 3-body force and the
                        short pair force together
    respa_outer_tail    pair_tail_forces on the (N, 72) rows
                        (``anatomy_3l.tail_force``)
    rebuild_full        wrap + MDSystem.build_lists
                        (``anatomy_3l.full_build``)
    rebuild_3b_filter   filter_neighbor_list from the pair list
                        (``anatomy_3l.refilter``)
    trio                the trio kernel and the reverse-slot assembly on
                        the 3-body rows (``anatomy_3l.trio_force``, the
                        anatomy's ``trio_map_comps_reuse``)

timed as ``anatomy_3l.measure`` times its phases: device ms by CUDA
graph replay of 30 chained calls (``common.graph_chain_ms``), the two
rebuilds, which read the card on the host, from the profiler
(``common.profiled_device_ms``), and host ms of the same calls run
eagerly beside them (every path is host-bound).  ``breakdown_ms`` holds
the device ms (null on the CPU), ``breakdown_host_ms`` the host ms.

The thresholds come from the committed gate artifact (``GATE_ARTIFACT``,
a run on NVIDIA H100 80GB HBM3 at 700 W), as the rule of the reference
(``:51-55``) takes them from the last committed artifact's own figures:

- the rate: at least ``HOST_FACTOR`` (0.5) times its median, so that a
  host up to 2x slower than that run's passes;
- each phase's device ms: at most ``DEVICE_FACTOR`` (1.15) times its
  figure, so that a ~15% regression of a phase fails, as the reference
  means its rate threshold to.  The device ms do not swing with the
  host (within ~1% between runs on one card), but hold only for the
  artifact's card at its power limit.  A phase the artifact lacks is
  not gated.

The verdict: ``passed`` when the rate and every phase pass and no timed
window was stale, or a stale one is covered by the committed probe
artifact (``STALE_PROBE``): the frozen-list force error past the stale
line in float64, which measures truncation, must lie under 1e-5 eV/A
(the reference reads its float32 probe, whose 9.54e-7 eV/A is the
summation floor).  No artifact on disk fails a stale window.  The gate
is on for a card without ``--no-gate``, never on the CPU; a gated run
that did not pass exits 1.

    python -m uf3_tpu_torch.benchmarks.throughput_gate [--no-gate]
        [--device cpu] [--reps 17 17 17] [--out-dir DIR] [--commit TAG]

writes ``bench_<commit>.json`` (the reference's keys, the card's name and
power limit) under ``benchmarks_data/artifacts_torch/``.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from uf3_tpu_torch.benchmarks import anatomy_3l, bench, common

# the thresholds (the module's docstring), from the committed artifact
GATE_ARTIFACT = "bench_4fe6cd6-dirty.json"
HOST_FACTOR = 0.5
DEVICE_FACTOR = 1.15
with open(os.path.join(common.ARTIFACTS, GATE_ARTIFACT)) as _f:
    _GATE = json.load(_f)
GATE_MEDIAN = _GATE["value"]
THRESHOLD_ATOM_STEPS = HOST_FACTOR * GATE_MEDIAN
DEVICE_LIMIT_MS = {k: DEVICE_FACTOR * v
                   for k, v in _GATE["breakdown_ms"].items()}
STALE_PROBE = os.path.join(common.ARTIFACTS,
                           "probe_stale_error_float64.json")
STALE_BOUND = 1e-5   # eV/A
# the artifact's keys (benchmarks/throughput_gate.py:198-218)
REFERENCE_KEYS = ("metric", "value", "threshold", "stale",
                  "stale_force_error_bound_eV_A", "passed", "gated",
                  "platform", "commit", "timestamp", "breakdown_ms",
                  "config")
# the reference's breakdown keys (benchmarks/throughput_gate.py:162-168),
# then the port's own
PHASES = ("fused_forces", "respa_inner_short", "respa_outer_tail",
          "rebuild_full", "rebuild_3b_filter")
BREAKDOWN = PHASES + ("trio",)
# the rebuilds read the card on the host: eager, and the calls timed
EAGER = {"rebuild_full": anatomy_3l.FULL_BUILD_CALLS,
         "rebuild_3b_filter": None}


def fused_forces(system, p: anatomy_3l.Parts, x):
    """The engine's force call at ``x`` on the parts' lists, without the
    energy: (N, 3)."""
    return system.energy_forces(x, p.nbr2, p.nbr3, p.cell,
                                with_energy=False, cache2=p.cache2,
                                cache3=p.cache3)[1]


def phases(system, p: anatomy_3l.Parts) -> dict:
    """The breakdown's phases as chainable bodies x -> x' (the
    anatomy's, under the reference's names and ``trio``)."""
    body = anatomy_3l.bodies(p)
    return {"fused_forces":
            lambda x: x + anatomy_3l.EPS * fused_forces(system, p, x),
            "respa_inner_short": body["inner_force_fresh_gather"],
            "respa_outer_tail": body["tail_force"],
            "rebuild_full": body["rebuild_full_standalone"],
            "rebuild_3b_filter": body["rebuild_3b_filter"],
            "trio": body["trio_map_comps_reuse"]}


def gated(device: torch.device, no_gate: bool) -> bool:
    """Whether a run on ``device`` is gated: on a card, without
    ``--no-gate``."""
    return device.type == "cuda" and not no_gate


def stale_bound(path: str = STALE_PROBE):
    """The force error bound (eV/A) the probe artifact at ``path``
    records, or None where there is none."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f).get("max_force_error_past_stale_line_eV_A")


def judge(value: float, stale: bool, probe: str = STALE_PROBE,
          device_ms: dict = None) -> dict:
    """The verdict on a rate, the windows' stale flag and the phases'
    device ms (None on the CPU): the thresholds, the stale bound (read
    only for a stale window), whether the stale policy holds, the
    phases over their limits and whether the run passed."""
    bound = stale_bound(probe) if stale else None
    stale_ok = not stale or (bound is not None and bound < STALE_BOUND)
    slow = {k: ms for k, ms in (device_ms or {}).items()
            if ms is not None and k in DEVICE_LIMIT_MS
            and ms > DEVICE_LIMIT_MS[k]}
    return {"threshold": THRESHOLD_ATOM_STEPS, "stale": stale,
            "stale_force_error_bound_eV_A": bound,
            "stale_bound_from": os.path.basename(probe) if stale else None,
            "stale_ok": stale_ok, "device_limit_ms": DEVICE_LIMIT_MS,
            "slow_phases": slow,
            "passed": value >= THRESHOLD_ATOM_STEPS and stale_ok
            and not slow}


def commit_tag() -> str:
    """The checkout's short commit, "-dirty" where tracked files
    changed."""
    tag = common.commit()
    if tag == "unknown":
        return tag
    dirty = subprocess.run(["git", "status", "--porcelain", "-uno"],
                           cwd=common.REPO, capture_output=True, text=True,
                           timeout=60).stdout.strip()
    return tag + ("-dirty" if dirty else "")


def run(reps=bench.REPS, windows: int = bench.WINDOWS, device=None,
        no_gate: bool = False, commit: str = None,
        scan_len: int = common.SCAN_LEN, warm_steps: int = bench.WARM_STEPS,
        window_steps: int = bench.WINDOW_STEPS) -> dict:
    """The gate's artifact: the bench line, the breakdown at its last
    state and the verdict."""
    device = common.resolve_device(device)
    kept = {}
    line = bench.run(reps, warm_steps=warm_steps, window_steps=window_steps,
                     windows=windows, device=device, keep=kept)
    system = kept["system"]
    parts = anatomy_3l.Parts.from_state(system, kept["state"])
    device_ms, host_ms = anatomy_3l.measure(
        parts, scan_len, phases(system, parts), EAGER)
    artifact = {
        "metric": f"atom-steps/s (2+3-body W MD, {line['n_atoms']} atoms)",
        "value": line["value"],
        **judge(line["value"], line["stale"], device_ms=device_ms),
        "gated": gated(device, no_gate),
        "platform": common.platform(device),
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "breakdown_ms": device_ms,
        "breakdown_host_ms": host_ms,
        "breakdown_device_ms_from": {
            k: "profiler" if k in EAGER else "graph" for k in device_ms},
        **{k: line[k] for k in ("value_min", "value_max",
                                "window_atom_steps_per_s", "ms_per_step")},
        "config": {"n_atoms": line["n_atoms"], "n_respa": system.n_respa,
                   "respa_mid": system.respa_mid,
                   "rebuild_every": system.rebuild_every,
                   "capacity_2b": system.capacity_2b,
                   "capacity_3b": system.capacity_3b,
                   "dtype": line["dtype"], "windows": windows,
                   "window_steps": window_steps, "scan_len": scan_len},
        "gate_median": GATE_MEDIAN, "host_factor": HOST_FACTOR,
        "device_factor": DEVICE_FACTOR}
    return common.stamp(artifact, device, commit or commit_tag())


def failure(artifact: dict) -> str:
    """Why a gated run failed."""
    reasons = []
    if not artifact["stale_ok"]:
        reasons.append("stale timed window without a committed force-error "
                       "bound under 1e-5 eV/A (run uf3_tpu_torch.benchmarks."
                       "probe_stale_error with --dtype float64)")
    if artifact["value"] < artifact["threshold"]:
        reasons.append(f"{artifact['value']:.3e} < "
                       f"{artifact['threshold']:.3e} atom-steps/s")
    reasons += [f"{k} {ms:.5f} > {artifact['device_limit_ms'][k]:.5f} "
                "device ms" for k, ms in artifact["slow_phases"].items()]
    return "; ".join(reasons)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    parser.add_argument("--no-gate", action="store_true",
                        help="measure and write the artifact, never fail")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--reps", type=int, nargs=3, default=bench.REPS,
                        help="bcc W supercell (default 17 17 17)")
    parser.add_argument("--out-dir", default=common.ARTIFACTS)
    parser.add_argument("--commit", default=None,
                        help="the artifact's commit (default: git's short "
                             "commit, -dirty where tracked files changed)")
    args = parser.parse_args(argv)
    artifact = run(tuple(args.reps), device=args.device,
                   no_gate=args.no_gate, commit=args.commit)
    path = common.write_artifact(artifact, args.out_dir,
                                 f"bench_{artifact['commit']}.json")
    print(json.dumps(artifact))
    print(f"artifact: {path}", file=sys.stderr)
    if artifact["gated"] and not artifact["passed"]:
        print(f"THROUGHPUT GATE FAILED: {failure(artifact)}",
              file=sys.stderr)
        sys.exit(1)
    return artifact


if __name__ == "__main__":
    main()
