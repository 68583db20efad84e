"""
One run of one cell:

    python3 mdbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout that holds ``uf3_tpu_torch``.  Prints the
numbers that decide ``correct`` beside their limits as the last lines
of standard error and one JSON line as the last line of standard
output.  Exits 2 without the program beside this folder, 3 without the
CUDA cards the cell asks for, 4 where jax, jaxlib, flax or uf3_tpu was
loaded; each without a result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "uf3_tpu")


def forbidden_modules(names=None):
    """The top-level names of loaded modules (or of ``names``) that are
    one of ``FORBIDDEN``, compared whole: ``uf3_tpu_torch`` is not
    ``uf3_tpu``."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names
                   if name.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if not os.path.isfile(os.path.join(ROOT, "uf3_tpu_torch",
                                       "__init__.py")):
        print("mdbench: the program uf3_tpu_torch is not beside this "
              "folder", file=sys.stderr)
        return 2
    import torch
    from mdbench import harness
    cell = next((w for w in harness.benchmark()["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"mdbench: no cell {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        print(f"mdbench: the cell needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    line, judged = harness.run_cell(args.workload, args.seed, args.seconds,
                                    bool(args.trace), device="cuda",
                                    t_start=T_START)
    found = forbidden_modules()
    if found:
        print("mdbench: loaded in this process: " + ", ".join(found),
              file=sys.stderr)
        return 4
    sys.stdout.flush()
    for name, value, limit, ok in judged:
        print(f"check {name} = {value!r} limit {limit!r} "
              f"{'ok' if ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
