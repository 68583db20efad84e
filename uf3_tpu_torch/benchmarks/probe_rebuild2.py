"""
The full neighbor rebuild on the card, by size.  Port of
``benchmarks/probe_rebuild2.py``.

The build is the engine's full branch less its wrap
(``MDSystem.build_lists``): the 2-body cell list and the 3-body list
filtered from it, with reverse slots.  The engine is the bench's
(``common.BENCH``: 12/6/36, skins 0.5 / 1.2 A, 72 / 16 slots), float32
(float64 on the CPU), at the lattice positions wrapped into the cell, as
the reference builds them; the sizes are the reference's, bcc W
(17, 17, 17) = 9,826, (34, 17, 17) = 19,652 and (34, 34, 17) = 39,304
atoms.  Per size:

- the cell list's grid and bin capacity;
- host ms per build, ended by a synchronize (the best of 3 runs of
  ``calls`` builds);
- the card's busy ms per build, from the profiler: a build reads the
  card on the host (``_compact``'s ``nonzero``, ``bincount``, the
  index-put, the stencil copies), so no CUDA graph captures it;
- the host syncs of one build by site, under
  ``torch.cuda.set_sync_debug_mode("warn")``;
- the cross-check: both lists against the port's native host cell list
  (``native.cell_list_neighbors``) at the same positions, as neighbor
  sets per row (atom and image) and the overflow flag.

The reference times two selections of its cell list, ``pack`` and
``pack2`` (31-bit key packing for the TPU, which the port does not
have), and checks them bit for bit against each other; the port has one
selection, checked against an independent builder.  Its timings are a
scan less a null scan; here the host clock and the profiler.

    python -m uf3_tpu_torch.benchmarks.probe_rebuild2 [--device cpu
        --reps 7 7 7 ...]

writes ``benchmarks_data/artifacts_torch/probe_rebuild2.json``.  On the
CPU the device keys are null.
"""

import argparse
import json

import numpy as np
import torch

from uf3_tpu_torch import native
from uf3_tpu_torch.benchmarks import common
from uf3_tpu_torch.forcefield.md import MDSystem

# benchmarks/probe_rebuild2.py:99
SIZES = ((17, 17, 17), (34, 17, 17), (34, 34, 17))
CALLS = 5
SHIFT_RANGE = 2   # image shifts the set keys encode: -2..2 per axis


def neighbor_sets(idx, shift, mask) -> np.ndarray:
    """Per-row sorted keys of the (atom, image shift) pairs a list holds,
    -1 where a slot is empty."""
    idx, shift, mask = (np.asarray(a) for a in (idx, shift, mask))
    shift = np.rint(shift).astype(np.int64)
    if mask.any() and np.abs(shift[mask]).max() > SHIFT_RANGE:
        raise ValueError("an image shift past the set keys' range")
    base = 2 * SHIFT_RANGE + 1
    code = (shift + SHIFT_RANGE) @ np.array([base * base, base, 1])
    key = np.where(mask, idx.astype(np.int64) * base ** 3 + code, -1)
    return np.sort(key, axis=1)


def same_sets(a: np.ndarray, b: np.ndarray) -> bool:
    """Whether two lists' ``neighbor_sets`` hold the same pairs per
    row, whatever their capacities."""
    width = max(a.shape[1], b.shape[1])
    a, b = (np.pad(x, ((0, 0), (width - x.shape[1], 0)), constant_values=-1)
            for x in (a, b))
    return a.shape == b.shape and bool(np.array_equal(a, b))


def native_check(system: MDSystem, x, lists) -> dict:
    """Each of ``lists`` (the 2-body list at r_cut_2b + skin_2b, the
    3-body list at r_cut_3b + skin) against the native host cell list at
    the same radius, capacity and positions: overflow flags and, where
    neither overflowed, the neighbor sets."""
    pos = x.detach().double().cpu().numpy()
    cell = system.cell.detach().double().cpu().numpy()
    out = {}
    for name, nbr, r_cut, capacity in (
            ("2b", lists[0], system.r_cut_2b + system.skin_2b,
             system.capacity_2b),
            ("3b", lists[1], system.r_cut_3b + system.skin,
             system.capacity_3b)):
        idx, shift, mask, count = native.cell_list_neighbors(
            pos, cell, system.pbc, r_cut, capacity)
        overflow = bool(nbr.overflow)
        flags = overflow == (count > capacity)
        sets = overflow or same_sets(
            neighbor_sets(nbr.idx.cpu(), nbr.shift.cpu(), nbr.mask.cpu()),
            neighbor_sets(idx, shift, mask))
        out[name] = {"overflow": overflow, "native_max_count": count,
                     "flags_equal": flags, "sets_equal": bool(sets)}
    return out


def run(sizes=SIZES, device=None, model=common.MODEL, calls: int = CALLS,
        commit: str = None, keep: dict = None) -> dict:
    """The probe at each size of ``sizes``.  ``keep``, where given,
    receives per size the system, the positions and both lists."""
    device = common.resolve_device(device)
    dtype = torch.float32 if device.type == "cuda" else torch.float64
    on_card = device.type == "cuda"
    result = {"platform": common.platform(device),
              "config": "bench engine (12/6/36, skins 0.5 / 1.2 A, 72 / 16 "
                        f"slots), {str(dtype).replace('torch.', '')}, "
                        "MDSystem.build_lists at the wrapped lattice",
              "sizes": []}
    kept = []
    for reps in sizes:
        geom = common.bcc_w(reps)
        system = MDSystem(model, geom, dtype=dtype, device=device,
                          **common.BENCH)
        if system._cells_2b is None:
            raise ValueError(f"bcc W {tuple(reps)} takes no cell list "
                             "(fewer than 512 atoms or 16 bins)")
        cell = system.cell
        x = system._wrap(torch.as_tensor(geom.get_positions(), dtype=dtype,
                                         device=device), cell)

        def build():
            return system.build_lists(x, cell)

        lists = build()
        host = common.host_chain_ms(lambda y: (build(), y)[1], x, calls)
        busy = common.profiled_device_ms(build, calls) if on_card else None
        sites = common.count_syncs(build)[1] if on_card else None
        grid_shape, bin_capacity, _ = system._cells_2b
        entry = {"n_atoms": len(geom), "grid": list(grid_shape),
                 "bin_capacity": bin_capacity, "host_ms": host,
                 "device_busy_ms": busy,
                 "host_syncs": None if sites is None else sum(sites.values()),
                 "host_syncs_by_site": sites,
                 "native": native_check(system, x, lists)}
        entry["lists_equal_native"] = all(
            c["flags_equal"] and c["sets_equal"]
            for c in entry["native"].values())
        result["sizes"].append(entry)
        print(json.dumps(entry), flush=True)
        kept.append(dict(system=system, positions=x, lists=lists))
    if keep is not None:
        keep["sizes"] = kept
    return common.stamp(result, device, commit)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--reps", type=int, nargs="+", default=None,
                        help="bcc W supercells, three numbers each "
                             "(default 17 17 17 34 17 17 34 34 17)")
    parser.add_argument("--out-dir", default=common.ARTIFACTS)
    parser.add_argument("--commit", default=None,
                        help="the artifact's commit (default: git's short "
                             "commit)")
    args = parser.parse_args(argv)
    sizes = SIZES
    if args.reps is not None:
        if len(args.reps) % 3:
            parser.error("--reps takes three numbers per size")
        sizes = tuple(tuple(args.reps[i:i + 3])
                      for i in range(0, len(args.reps), 3))
    result = run(sizes, device=args.device, commit=args.commit)
    path = common.write_artifact(result, args.out_dir, "probe_rebuild2.json")
    print(json.dumps({k: v for k, v in result.items() if k != "sizes"}))
    print(f"wrote {path}")
    return result


if __name__ == "__main__":
    main()
