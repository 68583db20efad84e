"""
Times builds of the kernel library made from patched copies of ``csrc/``
side by side, one design change to a variant: a variant is a unified
diff against ``csrc/`` (the ``.patch`` files of
``benchmarks_data/artifacts_torch/kernel_variants/``), or none for the
sources as they stand.  Each is applied to its own copy of ``csrc/``,
all copies are built at once (``_build.build``), and each library is
loaded in turn under the package's wrappers.

    python -m uf3_tpu_torch.benchmarks.kernel_variants trio \\
        --variant pr16 --variant pr15=PATCH ...

``trio``: every variant is first held to the plain version on the four
lists of ``common.trio_rows`` (float64 within 1e-10, float32 forces
within 2e-4 eV/A of the float64 plain version, full and triangle lanes,
with and without energy), then timed by CUDA graph replay
(``common.graph_ms``): float32 without energy on full and triangle
lanes of each list, float64 with and without energy on full lanes of
the K = 16 and K = 23 lists; launch plans from ``trio.trio_occupancy``.
``lane_contract``: ``probe_mosaic``'s ``lane_contract`` cases at the
probe's block and at the full system (``probe_mosaic.run_case``: each
call on its own operand copy, bit for bit against the plain version).
Each case is timed in two rounds, the variants in order and then in
reverse, and a variant's time is the mean of its two.  A variant that
fails to build or disagrees is reported and left out.  Writes
``kernel_variants_<kernel>.json`` under ``--out-dir`` (the artifacts
directory by default).
"""

import argparse
import concurrent.futures
import copy
import os
import re
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from uf3_tpu_torch.benchmarks import common, probe_mosaic
from uf3_tpu_torch.ops import _build, trio

F64_TOL, FORCE_TOL = 1e-10, 2e-4


def apply_patch(patch: str, root: str):
    """Apply a unified diff to the files of ``root`` (by base name).
    Every hunk's old lines must stand in the file as written, at the
    hunk's line or the nearest place after the previous hunk."""
    lines = patch.split("\n")
    i = 0
    while i < len(lines):
        if not (lines[i].startswith("--- ") and i + 1 < len(lines)
                and lines[i + 1].startswith("+++ ")):
            i += 1
            continue
        name = os.path.basename(lines[i + 1][4:].split("\t")[0].strip())
        path = os.path.join(root, name)
        with open(path) as f:
            src = f.read().split("\n")
        out, pos, i = [], 0, i + 2
        while i < len(lines) and lines[i].startswith("@@ "):
            start = int(re.match(r"@@ -(\d+)", lines[i]).group(1)) - 1
            old, new, i = [], [], i + 1
            while i < len(lines) and lines[i][:1] in (" ", "-", "+", "\\"):
                if lines[i].startswith("--- ") and i + 1 < len(lines) \
                        and lines[i + 1].startswith("+++ "):
                    break
                tag, text = lines[i][:1], lines[i][1:]
                if tag in " -":
                    old.append(text)
                if tag in " +":
                    new.append(text)
                i += 1
            at = sorted((k for k in range(pos, len(src) - len(old) + 1)
                         if src[k:k + len(old)] == old),
                        key=lambda k: abs(k - start))
            if not at:
                raise ValueError(f"{name}: hunk at line {start + 1} does "
                                 "not apply")
            out += src[pos:at[0]] + new
            pos = at[0] + len(old)
        with open(path, "w") as f:
            f.write("\n".join(out + src[pos:]))


def build_variants(variants, root):
    """name -> (library path, ptxas lines) of every variant that builds
    (all at once); the others are reported on stderr."""
    def one(name, patch):
        csrc = os.path.join(root, name, "csrc")
        shutil.copytree(_build.CSRC, csrc)
        if patch:
            with open(patch) as f:
                apply_patch(f.read(), csrc)
        library = os.path.join(root, name, "libuf3_kernels.so")
        log = _build.build(force=True, csrc=csrc, library=library)["log"]
        return library, [line.strip() for line in log.splitlines()
                         if "entry function" in line or "registers" in line
                         or "spill" in line]
    built = {}
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        jobs = {name: pool.submit(one, name, patch)
                for name, patch in variants}
        for name, job in jobs.items():
            try:
                built[name] = job.result()
            except (RuntimeError, ValueError, OSError) as err:
                print(f"variant {name}: not built: {err}", file=sys.stderr)
    return built


class using:
    """The package's wrappers launch from ``lib`` inside the block."""

    def __init__(self, lib):
        self.lib = lib

    def __enter__(self):
        self.saved = _build._loaded.get("lib")
        _build._loaded["lib"] = self.lib

    def __exit__(self, *exc):
        if self.saved is None:
            _build._loaded.pop("lib", None)
        else:
            _build._loaded["lib"] = self.saved


def _err(a, b) -> float:
    return float(torch.max(torch.abs(a.double() - b.double())))


def trio_check(pot64, d64, v64, rev, mask, twins):
    """The loaded kernel's largest differences from the plain version
    (``twins``: (with_energy, triangle) -> its outputs): float64 outputs
    and forces, float32 forces against the float64 plain version's."""
    pot32 = copy.deepcopy(pot64).to(dtype=torch.float32)
    d32, v32 = d64.float(), v64.float()
    err64 = err32 = 0.0
    for (with_energy, triangle), twin in twins.items():
        k64 = trio.trio_partials(pot64, d64, v64, with_energy,
                                 triangle=triangle)
        k32 = trio.trio_partials(pot32, d32, v32, with_energy,
                                 triangle=triangle)
        f_twin = trio.assemble_forces(*twin, d64, rev, mask)[1]
        f64 = trio.assemble_forces(*k64, d64, rev, mask)[1]
        f32 = trio.assemble_forces(*k32, d32, rev, mask)[1]
        err64 = max([err64, _err(f64, f_twin)]
                    + [_err(a, b) for a, b in zip(k64, twin)])
        err32 = max(err32, _err(f32, f_twin))
    return dict(f64=err64, f32_forces=err32,
                ok=err64 <= F64_TOL and err32 <= FORCE_TOL)


def trio_cases(device):
    """(checks: shape -> check(), cases: name -> (time(), plan())); a
    time() gives (ms, what else it measured or None)."""
    checks, cases = {}, {}
    for shape, (pot64, d64, v64, rev, mask) in \
            common.trio_rows(device).items():
        twins = {(e, t): trio.trio_partials_torch(
            d64, v64, pot64.grid, pot64.trio, e, triangle=t)
            for e in (True, False) for t in (False, True)}
        checks[shape] = (lambda a=(pot64, d64, v64, rev, mask, twins):
                         trio_check(*a))
        pot32 = copy.deepcopy(pot64).to(dtype=torch.float32)
        runs = [("f32", pot32, d64.float(), v64.float(), False, False),
                ("f32", pot32, d64.float(), v64.float(), False, True)]
        if shape in ("K16", "K23"):
            runs += [("f64", pot64, d64, v64, False, False),
                     ("f64 energy", pot64, d64, v64, True, False)]
        for tag, pot, d, v, energy, tri in runs:
            name = f"{shape} {'triangle' if tri else 'full'} {tag}"
            cases[name] = (
                lambda a=(pot, d, v, energy, tri): (common.graph_ms(
                    lambda: trio.trio_partials(*a[:4], triangle=a[4])),
                    None),
                lambda a=(pot, d, v, energy, tri): trio.trio_occupancy(
                    a[0], int(a[1].shape[1]), a[3], a[4],
                    n_atoms=int(a[1].shape[0])))
    return checks, cases


def lane_contract_cases(device):
    """(no separate checks, cases: name -> (time(), None)); each time
    raises if the kernel disagrees with its plain version, and gives the
    library call's time and the bound of the same run beside its own."""
    cases = {}
    for case in probe_mosaic.CASES:
        if case.kernel != "lane_contract":
            continue
        for size in ("probe", "full"):
            def timed(case=case, size=size):
                r = probe_mosaic.run_case(case, size,
                                          np.random.RandomState(1), device)
                if not r["correct"]:
                    raise AssertionError(f"{case.name} {size} disagrees")
                return r["kernel_ms"], dict(library_ms=r["library_ms"],
                                            bound_ms=r["bound_ms"])
            cases[f"{case.name} {size}"] = (timed, None)
    return {}, cases


CASES = {"trio": trio_cases, "lane_contract": lane_contract_cases}


def main(kernel, variants, out_dir=None, device=None):
    device = common.resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("kernel_variants times kernels on the card")
    out_dir = out_dir or common.ARTIFACTS
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="kernel_variants_")
    try:
        built = build_variants(variants, root)
        print(f"built {len(built)} of {len(variants)} variants in "
              f"{time.perf_counter() - t0:.1f} s")
        libs = {name: _build.load(path) for name, (path, _) in built.items()}
        result = dict(card=common.card(device), kernel=kernel,
                      variants={n: os.path.relpath(p, common.REPO) if p
                                else None for n, p in variants},
                      ptxas={n: b[1] for n, b in built.items()},
                      checks={}, ms={}, plans={})
        checks, cases = CASES[kernel](device)
        for shape, check in checks.items():
            for name in list(libs):
                with using(libs[name]):
                    r = check()
                result["checks"].setdefault(name, {})[shape] = r
                print(f"{shape} {name}: {r}")
                if not r["ok"]:
                    libs.pop(name)
        names = list(libs)
        for case, (timed, plan) in cases.items():
            times = {name: [] for name in names}
            for order in (names, names[::-1]):
                for name in order:
                    with using(libs[name]):
                        ms, extra = timed()
                    times[name].append(ms)
                    if extra is not None:
                        result.setdefault("beside", {}).setdefault(
                            case, {}).setdefault(name, []).append(extra)
            result["ms"][case] = {n: sum(t) / len(t)
                                  for n, t in times.items()}
            if plan is not None:
                result["plans"][case] = {}
                for name in names:
                    with using(libs[name]):
                        result["plans"][case][name] = plan()
            print(f"{case}: " + ", ".join(
                f"{n} {result['ms'][case][n]:.5f} ("
                + "/".join(f"{x:.5f}" for x in times[n])
                + (f"; {result['plans'][case][n]['registers']} regs, "
                   f"{result['plans'][case][n]['warps_per_sm']} warps/SM, "
                   f"{result['plans'][case][n]['local_bytes']} B local"
                   if plan is not None else "") + ")" for n in names)
                + f"; card: {result['card']}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    path = common.write_artifact(result, out_dir,
                                 f"kernel_variants_{kernel}.json")
    print(f"wrote {path}")
    return result


def parse_variant(text):
    """NAME or NAME=PATCH -> (name, patch path or None)."""
    name, _, patch = text.partition("=")
    return name, patch or None


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("kernel", choices=sorted(CASES))
    parser.add_argument("--variant", action="append", required=True,
                        help="NAME (the sources as they stand) or "
                             "NAME=PATCH")
    parser.add_argument("--out-dir", default=None)
    args = parser.parse_args()
    main(args.kernel, [parse_variant(v) for v in args.variant],
         args.out_dir)
