"""
The readings that a cell's limits are set from, on the card at the
cell's own size, in one process, each judged by the harness's own
``check`` and ``judge`` against the cell's limits:

- the program: each seed's numbers after a short window (the lower
  readings are the largest over the seeds);
- the control: the reference in TF32 put in the program's place at the
  final state of each control seed (it has to come out not correct;
  the upper readings are the smallest over those seeds);
- each fault of ``faults.py`` named, planted underneath the program, on
  each fault seed (each has to come out not correct).

    python3 mdbench/calibrate.py --workload <cell> --seconds 3
        --seeds <n> ... --control-seeds <n> ...
        [--faults <name> ... --fault-seeds <n> ...] --out <file.json>

The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _reading(run, limits, **given) -> dict:
    from mdbench import harness
    numbers, _ = harness.check(run, **given)
    judged = harness.judge(numbers, limits)
    return dict(numbers=numbers, correct=all(ok for *_, ok in judged),
                failed=[name for name, *_, ok in judged if not ok])


def _over_seeds(readings: dict, pick) -> dict:
    values = [r["numbers"] for r in readings.values() if r.get("numbers")]
    if not values:
        return {}
    return {k: pick(v[k] for v in values) for k in values[0]}


def readings(cell: str, seeds, control_seeds, seconds: float,
             fault_names=(), fault_seeds=(), device="cuda", **kw) -> dict:
    from mdbench import faults, harness, reference
    limits = harness.workload(cell)["limits"]
    program, control, faulty = {}, {}, {}

    def report(**line):
        print(json.dumps(line), flush=True)
    for seed in sorted(set(seeds) | set(control_seeds)):
        t0 = time.perf_counter()
        run = harness.drive(cell, seed, seconds, False, device, **kw)
        if seed in seeds:
            program[str(seed)] = _reading(run, limits)
        if seed in control_seeds:
            model = reference.load(harness.config_path(
                run.workload["config"]))
            e32, f32, _ = reference.energy_forces(
                model, run.positions, run.cell_matrix, precision="tf32")
            control[str(seed)] = _reading(run, limits, forces=f32,
                                          energy=e32)
        report(seed=seed, program=program.get(str(seed)),
               control=control.get(str(seed)), steps=run.window_steps,
               seconds=time.perf_counter() - t0)
        del run
    for name in fault_names:
        for seed in fault_seeds:
            t0 = time.perf_counter()
            patches = faults.Patches()
            try:
                run = harness.drive(
                    cell, seed, seconds, False, device,
                    program_hook=faults.hook(name, patches,
                                             harness.workload(cell)), **kw)
                out = _reading(run, limits)
                steps = run.window_steps
                del run
            except RuntimeError as err:
                # the program's own check stopped the run: no result
                out = dict(numbers=None, correct=False, failed=[],
                           stopped=str(err))
                steps = 0
            finally:
                patches.undo()
            faulty.setdefault(name, {})[str(seed)] = out
            report(fault=name, seed=seed, reading=out, steps=steps,
                   seconds=time.perf_counter() - t0)
    return dict(cell=cell, seconds=seconds, limits=limits,
                program=program, control=control, faults=faulty,
                lower=_over_seeds(program, max),
                upper=_over_seeds(control, min),
                faults_upper={name: _over_seeds(r, min)
                              for name, r in faulty.items()},
                all_program_correct=all(r["correct"]
                                        for r in program.values()),
                no_control_correct=not any(r["correct"]
                                           for r in control.values()),
                no_fault_correct=not any(r["correct"] for f in
                                         faulty.values()
                                         for r in f.values()))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--faults", nargs="*", default=[])
    parser.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    out = readings(args.workload, args.seeds, args.control_seeds,
                   args.seconds, args.faults, args.fault_seeds)
    out["card"] = torch.cuda.get_device_name(0)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in (
        "lower", "upper", "faults_upper", "all_program_correct",
        "no_control_correct", "no_fault_correct")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
