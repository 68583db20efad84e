"""
Times builds of the kernel library made from patched copies of ``csrc/``
side by side, one design change to a variant: a variant is a unified
diff against ``csrc/`` (the ``.patch`` files of
``benchmarks_data/artifacts_torch/kernel_variants/``), or none for the
sources as they stand.  Each is applied to its own copy of ``csrc/``,
all copies are built at once (``_build.build``), and each library is
loaded in turn under the package's wrappers.

    python -m uf3_tpu_torch.benchmarks.kernel_variants \\
        trio|lane_contract|trio_multi|relayout|gather \\
        --variant as_is --variant before=PATCH ...

``trio``: every variant is first held to the plain version on the four
lists of ``common.trio_rows`` (float64 within 1e-10, float32 forces
within 2e-4 eV/A of the float64 plain version, full and triangle lanes,
with and without energy), then timed by CUDA graph replay
(``common.graph_ms``): float32 without energy on full and triangle
lanes of each list, float64 with and without energy on full lanes of
the K = 16 and K = 23 lists; launch plans from ``trio.trio_occupancy``.
``trio_multi``: every variant is first held to the plain version on the
rows of ``common.multi_rows`` (the binary 8,788-atom K = 24 rows, the
ternary 4,000-atom rows, the calculator's float64 rows; float64 within
1e-10, float32 forces within 2e-4 eV/A of the float64 plain version,
with and without energy), then timed by graph replay: float32 without
energy on the binary and ternary rows, float64 with energy on the
calculator's; launch plans from ``multi.trio_multi_occupancy``.
``lane_contract`` and ``relayout``: ``probe_mosaic``'s cases of the
kernel (``relayout``: its reshape, the copy) at the probe's block and at
the full system (``probe_mosaic.run_case``: each call on its own operand
copy, bit for bit against the plain version, beside the library call;
``relayout`` also with each call after a memcpy node and after a small
kernel, less that node's own time, as no other copy precedes it; and
the floor of a graph node, ``common.node_floor_ms``).
``gather``: every variant is first held to the plain versions bit for
bit on each row-gather instance (W = 1, 3, 4, 5, 8, 33, float32 and
float64, int32 and int64, entry counts with tails, tables and indices
off a 16-byte boundary, a table that is not contiguous) and each
lane-gather instance (T = 16, 32, 33, 128, 1280); then
``probe_gather``'s row and lane cases, the engine's own position
gathers among them, are timed on operand copies that together pass the
L2 (``probe_gather.cold_ms``: what the bound counts), each call held to
the plain version bit for bit first, with the time on the same operands,
the library call's times and the bound beside, each case's instance
plan (``gather.gather_occupancy``) and the floor of a graph node; the
ptxas lines kept are the gather kernels'.
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

from uf3_tpu_torch.benchmarks import common, probe_gather, probe_mosaic
from uf3_tpu_torch.ops import _build, fragments, gather, multi, trio

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


def multi_check(rows, plains):
    """The loaded multi-species kernel's largest differences from the
    plain version (``plains``: with_energy -> its float64 outputs):
    float64 outputs and forces, float32 forces against the float64 plain
    version's."""
    pot64, d64, v64, s_slot, species, rev, mask = rows
    pot32 = copy.deepcopy(pot64).to(dtype=torch.float32)
    d32, v32 = d64.float(), v64.float()
    err64 = err32 = 0.0
    for with_energy, plain in plains.items():
        k64 = multi.trio_multi_partials_all(pot64, d64, v64, s_slot,
                                            species, with_energy)
        k32 = multi.trio_multi_partials_all(pot32, d32, v32, s_slot,
                                            species, with_energy)
        f_plain = trio.assemble_forces(*plain, d64, rev, mask)[1]
        f64 = trio.assemble_forces(*k64, d64, rev, mask)[1]
        f32 = trio.assemble_forces(*k32, d32, rev, mask)[1]
        err64 = max([err64, _err(f64, f_plain)]
                    + [_err(a, b) for a, b in zip(k64, plain)])
        err32 = max(err32, _err(f32, f_plain))
    return dict(f64=err64, f32_forces=err32,
                ok=err64 <= F64_TOL and err32 <= FORCE_TOL)


def trio_multi_cases(device):
    """(checks: rows -> check(), cases: name -> (time(), plan()))."""
    checks, cases = {}, {}
    for name, rows in common.multi_rows(device).items():
        pot64, d64, v64, s_slot, species = rows[:5]
        plains = {e: multi.trio_multi_partials_all_torch(
            pot64, d64, v64, s_slot, species, e) for e in (True, False)}
        checks[name] = lambda a=(rows, plains): multi_check(*a)
        k = int(d64.shape[1])
        if name == "calculator":  # float64 with energy, as it runs there
            tag, args = (f"calculator f64 energy, K = {k}",
                         (pot64, d64, v64, s_slot, species, True))
        else:
            tag, args = (f"{name} f32, K = {k}",
                         (copy.deepcopy(pot64).to(dtype=torch.float32),
                          d64.float(), v64.float(), s_slot, species, False))
        cases[tag] = (
            lambda a=args: (common.graph_ms(
                lambda: multi.trio_multi_partials_all(*a)), None),
            lambda a=args: multi.trio_multi_occupancy(
                a[0], int(a[1].shape[1]), a[1].dtype == torch.float64,
                a[5], n_atoms=int(a[1].shape[0])))
    return checks, cases


def fragment_cases(kernel, mode=None, after=False):
    """The cases of ``probe_mosaic`` of ``kernel`` (and ``mode``) at both
    sizes: (no separate checks, cases: name -> (time(), plan())); each
    time raises if the kernel disagrees with its plain version, and gives
    the library call's time, the kernel's on one set of operands and the
    bound of the same run beside its own; ``relayout``'s plan is its
    launch plan for ``mode`` (``fragments.relayout_occupancy``), the
    others have none.  With ``after``, each case is also timed with every
    call after a node of another kind (``probe_mosaic.run_case``'s
    ``before``): a 16-byte device-to-device memcpy, and a 4-element
    ``add_`` kernel."""
    plan = None
    if kernel == "relayout":
        def plan():
            return fragments.relayout_occupancy(mode)

    def build(device):
        befores = {"": None}
        if after:
            src = torch.zeros(4, device=device)
            dst, tick = torch.empty_like(src), torch.zeros_like(src)
            befores[", after a memcpy"] = lambda: dst.copy_(src)
            befores[", after a kernel"] = lambda: tick.add_(1.0)
        cases = {}
        for case in probe_mosaic.CASES:
            if case.kernel != kernel or mode not in (None, case.mode):
                continue
            for size in ("probe", "full"):
                for where, before in befores.items():
                    def timed(case=case, size=size, before=before):
                        r = probe_mosaic.run_case(
                            case, size, np.random.RandomState(1), device,
                            before=before)
                        if not r["correct"]:
                            raise AssertionError(
                                f"{case.name} {size} disagrees")
                        return r["kernel_ms"], dict(
                            library_ms=r["library_ms"],
                            bound_ms=r["bound_ms"],
                            warm_ms=r["kernel_warm_ms"],
                            before_ms=r.get("before_ms"))
                    cases[f"{case.name} {size}{where}"] = (timed, plan)
        return {}, cases
    return build


def gather_check(device) -> dict:
    """The loaded gather kernels against their plain versions, bit for
    bit, on every instance: rows of W = 1, 3, 4, 5, 8, 33 (1 to 16 words,
    rows_any and rows_wide) at 1, 127, 1025 and 4099 entries, on a
    contiguous table, a table and an index one element past a 16-byte
    boundary, and a view that is not contiguous (copied first); lanes at
    T = 16, 32, 33, 128, 1280 with 16 and 7 outputs a row; float32 and
    float64, int32 and int64.  Returns the count of calls, the cases that
    differ, and ok."""
    rng = np.random.RandomState(3)
    calls, bad = 0, []
    for dtype in (torch.float32, torch.float64):
        for index_dtype in (torch.int32, torch.int64):
            for w in (1, 3, 4, 5, 8, 33):
                flat = torch.as_tensor(rng.randn(1001 * (w + 1) + 1),
                                       dtype=dtype, device=device)
                wider = flat[:1001 * (w + 1)].view(1001, w + 1)
                raw = torch.as_tensor(rng.randint(0, 1001, size=4100),
                                      dtype=index_dtype, device=device)
                tables = {"contiguous": wider[:, :w].contiguous(),
                          "offset": flat[1:1001 * w + 1].view(1001, w),
                          "strided": wider[:, 1:]}
                for n in (1, 127, 1025, 4099):
                    for view, table in tables.items():
                        for at in (0, 1):
                            idx = raw[at:at + n]
                            got = gather.gather_rows(table, idx)
                            calls += 1
                            if not torch.equal(got, gather.gather_rows_torch(
                                    table, idx)):
                                bad.append(f"rows W={w} n={n} {view} "
                                           f"index+{at} {dtype} "
                                           f"{index_dtype}")
            for width in (16, 32, 33, 128, 1280):
                for b in (16, 7):
                    t = torch.as_tensor(rng.randn(1001, width), dtype=dtype,
                                        device=device)
                    li = torch.as_tensor(rng.randint(0, width,
                                                     size=(1001, b)),
                                         dtype=index_dtype, device=device)
                    calls += 1
                    if not torch.equal(gather.gather_lanes(t, li),
                                       gather.gather_lanes_torch(t, li)):
                        bad.append(f"lanes T={width} B={b} {dtype} "
                                   f"{index_dtype}")
    torch.cuda.synchronize()
    return dict(calls=calls, differ=bad, ok=not bad)


def gather_case(case, device):
    """(time(), plan()) of one ``probe_gather`` case: a time raises if the
    loaded kernel disagrees with the plain version, and gives its device
    ms on operand copies past the L2 (``probe_gather.cold_ms``) with
    beside it its ms on the same operands (``warm_ms``), the library
    call's two times and the bound (the last three measured once)."""
    ops = probe_gather.operands(case, np.random.RandomState(1), device)
    kernel = gather.KERNELS[case.kind]
    ref = gather.PLAIN[case.kind](*ops)
    n_bytes = gather.gather_bytes(case.kind, ref, *ops)
    sets = probe_gather.cold_sets(ops, n_bytes)
    library = [probe_gather.library_call(case.kind, o) for o in sets]
    beside = dict(bound_ms=1e3 * n_bytes / gather.PEAK_BYTES,
                  library_ms=common.graph_ms(library[0]),
                  library_cold_ms=probe_gather.cold_ms(library))

    def timed():
        if not torch.equal(kernel(*ops), ref):
            raise AssertionError(f"{case.name}: the kernel differs from "
                                 "the plain version")
        ms = probe_gather.cold_ms([lambda o=o: kernel(*o) for o in sets])
        return ms, dict(beside,
                        warm_ms=common.graph_ms(lambda: kernel(*ops)))

    def plan():
        return gather.gather_occupancy(
            probe_gather.plan_of(case.kind, ops), ops[0].element_size(),
            ops[1].element_size())
    return timed, plan


def gather_cases(device):
    """(checks: "instances" -> ``gather_check``, cases: name -> (time(),
    plan())) for ``probe_gather``'s row and lane cases
    (``gather_case``)."""
    cases = {case.name: gather_case(case, device)
             for case in probe_gather.CASES if case.kind in ("rows", "lanes")}
    return {"instances": lambda: gather_check(device)}, cases


def kernel_lines(lines, word: str):
    """The ptxas lines of the entry functions whose names hold ``word``
    (each entry's line and the spill and register lines after it)."""
    kept, keep = [], False
    for line in lines:
        if "entry function" in line:
            keep = word in line
        if keep:
            kept.append(line)
    return kept


CASES = {"trio": trio_cases, "trio_multi": trio_multi_cases,
         "lane_contract": fragment_cases("lane_contract"),
         "relayout": fragment_cases("relayout", "reshape", after=True),
         "gather": gather_cases}


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
                      ptxas={n: kernel_lines(b[1], "gather")
                             if kernel == "gather" else b[1]
                             for n, b in built.items()},
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
        if kernel in ("relayout", "gather"):
            result["node_floor_ms"] = common.node_floor_ms(device)
            print(f"graph node floor, ms: {result['node_floor_ms']}; card: "
                  f"{result['card']}")
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
