"""
Reading and writing configurations: extended-xyz (energy in the comment
line, forces in a 'force'/'forces' property column), VASP
``vasprun.xml`` ionic steps, and LAMMPS thermo logs with their text
dumps; a training set's files found by pattern and read with per-file
subsampling.

Copy of ``read_xyz`` and ``write_xyz`` with their comment and property
parsers, ``read_vasprun``, ``identify_paths`` and the LAMMPS readers
from ``uf3_tpu/data/io.py`` (that module imports pandas at module level,
which the GPU hosts do not carry): for the same configurations it
writes the same text.  Where the reference's LAMMPS readers return
DataFrames, ``parse_lammps_log`` returns a dict of column arrays,
``parse_lammps_dump`` the matched timesteps and their configurations,
``parse_lammps_outputs`` the configurations with the log's columns in
their ``info``.  ``read_sources`` is ``parse_with_subsampling`` for
extended-xyz and vasprun files, returning named configurations where
the reference fills a pandas ``DataCoordinator``.  The features file
that ``featurize`` writes is an ``.npz`` (``npz_features_path``,
``load_features``); an HDF5 path raises.
"""

import fnmatch
import os
import re
from io import StringIO
from typing import Dict, List, Tuple, Union

import numpy as np

from uf3_tpu_torch.data import elements
from uf3_tpu_torch.data.atoms import Atoms
from uf3_tpu_torch.forcefield.md import _not_ported
from uf3_tpu_torch.util import subsample

_KV_RE = re.compile(r'(\S+?)=(?:"([^"]*)"|(\S+))')


def _parse_xyz_comment(line: str) -> Dict[str, str]:
    return {m.group(1): m.group(2) if m.group(2) is not None else m.group(3)
            for m in _KV_RE.finditer(line)}


def _parse_properties(spec: str) -> List[Tuple[str, str, int]]:
    parts = spec.split(":")
    out = []
    for i in range(0, len(parts), 3):
        out.append((parts[i], parts[i + 1], int(parts[i + 2])))
    return out


def read_xyz(filename: Union[str, StringIO],
             index: slice = None) -> List[Atoms]:
    """Read extended-xyz trajectory (energy in the comment line; forces
    from a 'force'/'forces' property column)."""
    if isinstance(filename, str):
        with open(filename) as f:
            lines = f.read().splitlines()
    else:
        lines = filename.read().splitlines()
    geometries = []
    pos = 0
    while pos < len(lines):
        if not lines[pos].strip():
            pos += 1
            continue
        n_atoms = int(lines[pos].strip())
        comment = _parse_xyz_comment(lines[pos + 1])
        props = _parse_properties(
            comment.get("Properties", "species:S:1:pos:R:3"))
        body = lines[pos + 2:pos + 2 + n_atoms]
        columns = [ln.split() for ln in body]
        col = 0
        species = None
        positions = None
        arrays = {}
        for name, kind, width in props:
            values = [row[col:col + width] for row in columns]
            if name == "species":
                species = [v[0] for v in values]
            elif name == "pos":
                positions = np.array(values, dtype=float)
            else:
                if kind == "S":
                    arr = np.array([v[0] if width == 1 else v
                                    for v in values])
                else:
                    dtype = float if kind == "R" else int
                    arr = np.array(values, dtype=dtype)
                    if width == 1:
                        arr = arr[:, 0]
                arrays[name] = arr
            col += width
        cell = None
        pbc = False
        if "Lattice" in comment:
            cell = np.array(comment["Lattice"].split(),
                            dtype=float).reshape(3, 3)
            pbc = True
        if "pbc" in comment:
            pbc = [p.strip().upper() in ("T", "TRUE", "1")
                   for p in comment["pbc"].split()]
        geom = Atoms([elements.atomic_numbers[s] for s in species],
                     positions, cell=cell, pbc=pbc)
        for key in ("energy", "Energy"):
            if key in comment:
                geom.info["energy"] = float(comment[key])
                break
        for key, value in comment.items():
            if key not in ("Lattice", "Properties", "pbc", "energy",
                           "Energy"):
                try:
                    geom.info[key] = float(value)
                except ValueError:
                    geom.info[key] = value
        for key in ("force", "forces"):
            if key in arrays:
                forces = arrays.pop(key)
                geom.arrays["fx"] = forces[:, 0]
                geom.arrays["fy"] = forces[:, 1]
                geom.arrays["fz"] = forces[:, 2]
                break
        geom.arrays.update({k: v for k, v in arrays.items()
                            if k not in ("Z",)})
        geometries.append(geom)
        pos += 2 + n_atoms
    if index is not None:
        geometries = geometries[index]
    return geometries


def write_xyz(filename: str, geometries: List[Atoms],
              append: bool = False) -> None:
    """Write extended-xyz with energy/forces when present."""
    mode = "a" if append else "w"
    with open(filename, mode) as f:
        for geom in geometries:
            has_forces = all(k in geom.arrays for k in ("fx", "fy", "fz"))
            props = "species:S:1:pos:R:3"
            if has_forces:
                props += ":forces:R:3"
            fields = [f"Properties={props}"]
            if np.any(geom.get_pbc()):
                lattice = " ".join(f"{x:.10f}"
                                   for x in geom.get_cell().ravel())
                fields.append(f'Lattice="{lattice}"')
            if "energy" in geom.info:
                fields.append(f'energy={geom.info["energy"]:.10f}')
            f.write(f"{len(geom)}\n{' '.join(fields)}\n")
            symbols = geom.get_chemical_symbols()
            for i in range(len(geom)):
                row = [f"{symbols[i]:<3}"] + [
                    f"{x:.10f}" for x in geom.positions[i]]
                if has_forces:
                    row += [f"{geom.arrays[c][i]:.10f}"
                            for c in ("fx", "fy", "fz")]
                f.write(" ".join(row) + "\n")


def read_vasprun(filename: str) -> List[Atoms]:
    """Parse ionic steps (structure, free energy, forces) from
    vasprun.xml using the standard library XML parser."""
    import xml.etree.ElementTree as ET
    tree = ET.parse(filename)
    root = tree.getroot()
    # species from atominfo
    species = []
    atominfo = root.find("atominfo")
    for array in atominfo.iter("array"):
        if array.get("name") == "atoms":
            for rc in array.find("set").iter("rc"):
                species.append(rc.find("c").text.strip())
    numbers = elements.symbols_to_numbers(species)
    geometries = []
    for calc in root.iter("calculation"):
        structure = calc.find("structure")
        cell = None
        positions_frac = None
        for varray in structure.iter("varray"):
            if varray.get("name") == "positions":
                positions_frac = np.array(
                    [[float(x) for x in v.text.split()]
                     for v in varray.findall("v")])
        crystal = structure.find("crystal")
        for varray in crystal.iter("varray"):
            if varray.get("name") == "basis":
                cell = np.array([[float(x) for x in v.text.split()]
                                 for v in varray.findall("v")])
        forces = None
        for varray in calc.findall("varray"):
            if varray.get("name") == "forces":
                forces = np.array([[float(x) for x in v.text.split()]
                                   for v in varray.findall("v")])
        energy = None
        energy_block = calc.find("energy")
        if energy_block is not None:
            for entry in energy_block.findall("i"):
                if entry.get("name") == "e_fr_energy":
                    energy = float(entry.text)
        geom = Atoms(numbers, positions_frac @ cell, cell=cell, pbc=True)
        if energy is not None:
            geom.info["energy"] = energy
        if forces is not None:
            geom.arrays["fx"] = forces[:, 0]
            geom.arrays["fy"] = forces[:, 1]
            geom.arrays["fz"] = forces[:, 2]
        geometries.append(geom)
    return geometries


def _columns(text: str) -> Dict[str, np.ndarray]:
    """Whitespace-separated columns under a header line: integer
    columns as int64, the others as float64."""
    lines = [ln.split() for ln in text.strip().splitlines() if ln.strip()]
    header, rows = lines[0], lines[1:]
    out = {}
    for j, name in enumerate(header):
        values = [row[j] for row in rows]
        try:
            out[name] = np.array([int(v) for v in values], dtype=np.int64)
        except ValueError:
            out[name] = np.array(values, dtype=np.float64)
    return out


def parse_lammps_log(fname: str, log_regex: str = None
                     ) -> Dict[str, np.ndarray]:
    """Thermo blocks (Step ... until 'Loop time') as one dict of column
    arrays, repeated rows dropped (the first kept)."""
    log_regex = log_regex or r"\n(Step[^\n]+\n[^A-Z]+)(?:Loop time)"
    with open(fname) as f:
        text = f.read()
    blocks = [_columns(block)
              for block in re.compile(log_regex).findall(text)]
    names = list(dict.fromkeys(k for block in blocks for k in block))
    n_rows = [len(next(iter(block.values()))) for block in blocks]
    merged = {name: np.concatenate([
        block[name] if name in block else np.full(n, np.nan)
        for block, n in zip(blocks, n_rows)]) for name in names}
    seen, keep = set(), []
    for i, row in enumerate(zip(*merged.values())):
        if row not in seen:
            seen.add(row)
            keep.append(i)
    return {name: values[keep] for name, values in merged.items()}


def _construct_cell(bounds: np.ndarray,
                    off_diag: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """LAMMPS box bounds (+tilt) -> cell matrix and displacement."""
    xlo, xhi, ylo, yhi, zlo, zhi = bounds
    xy, xz, yz = off_diag
    xlo -= min(0.0, xy, xz, xy + xz)
    xhi -= max(0.0, xy, xz, xy + xz)
    ylo -= min(0.0, yz)
    yhi -= max(0.0, yz)
    cell = np.array([[xhi - xlo, 0.0, 0.0],
                     [xy, yhi - ylo, 0.0],
                     [xz, yz, zhi - zlo]])
    displacement = np.array([xlo, ylo, zlo])
    return cell, displacement


def _dump_atoms(text: str, lammps_aliases: Dict, cell, pbc) -> Atoms:
    """A dump snapshot's per-atom columns (sorted by ``id``) as Atoms:
    x/y/z the positions, ``type`` the species through the aliases, every
    other column a per-atom array."""
    columns = _columns(text)
    order = np.argsort(columns.pop("id"), kind="stable")
    columns = {k: v[order] for k, v in columns.items()}
    numbers = []
    for item in columns["type"]:
        item = lammps_aliases.get(item, item)
        if isinstance(item, str) and item in elements.atomic_numbers:
            numbers.append(elements.atomic_numbers[item])
        else:
            numbers.append(int(item))
    positions = np.stack([columns[c] for c in ("x", "y", "z")], axis=1)
    atoms = Atoms(numbers, positions, cell=cell, pbc=pbc)
    for key in set(columns) - {"x", "y", "z", "type"}:
        atoms.set_array(key, columns[key])
    return atoms


def parse_lammps_dump(fname: str,
                      lammps_aliases: Dict,
                      timesteps: List[int] = None
                      ) -> Tuple[List[int], List[Atoms]]:
    """Stream a LAMMPS text dump into per-timestep Atoms; optionally
    match a chronological subset of timesteps (duplicates allowed,
    accommodating reset_timestep runs).  Returns (timesteps, Atoms)."""
    parse_subset = timesteps is not None
    remaining = np.array(timesteps) if parse_subset else None
    snapshot_index = []
    snapshot_contents = []
    atom_lines: List[str] = []
    timestep = None
    cell = None
    pbc = None
    celldisp = None
    with open(fname) as f:
        while True:
            line = f.readline()
            if "ITEM: TIMESTEP" in line or not line:
                if timestep is not None and atom_lines:
                    atoms = _dump_atoms("\n".join(atom_lines),
                                        lammps_aliases, cell, pbc)
                    atoms.info["celldisp"] = celldisp
                    if not parse_subset:
                        snapshot_index.append(timestep)
                        snapshot_contents.append(atoms)
                    elif timestep in remaining:
                        snapshot_index.append(timestep)
                        snapshot_contents.append(atoms)
                        first = np.flatnonzero(remaining == timestep)[0]
                        remaining = np.delete(remaining, first)
                        if len(remaining) == 0:
                            break
                if not line:
                    break
                timestep = int(f.readline())
                atom_lines = []
            elif "ITEM: NUMBER OF ATOMS" in line:
                f.readline()
            elif "ITEM: BOX BOUNDS" in line:
                conditions = line.replace("ITEM: BOX BOUNDS ", "").split()
                rows = np.array([f.readline().split() for _ in range(3)],
                                dtype=float)
                bounds = rows[:, :2].reshape(6)
                if len(conditions) < 3:
                    pbc = (False, False, False)
                    off_diag = np.zeros(3)
                elif len(conditions) == 3:
                    pbc = ["p" in c.lower() for c in conditions]
                    off_diag = np.zeros(3)
                else:
                    pbc = ["p" in c.lower() for c in conditions[3:]]
                    off_diag = rows[:, 2]
                cell, celldisp = _construct_cell(bounds, off_diag)
            elif "ITEM: ATOMS" in line:
                atom_lines.append(line.replace("ITEM: ATOMS ", ""))
            else:
                atom_lines.append(line)
    return snapshot_index, snapshot_contents


def parse_lammps_outputs(path: str,
                         lammps_aliases: Dict,
                         column_subs: Dict = None,
                         log_fname: str = "log.lammps",
                         dump_fname: str = "dump.lammpstrj",
                         log_regex: str = None) -> List[Atoms]:
    """A LAMMPS thermo log joined with its dump: the dump's snapshots at
    the log's timesteps, in the order they matched, each carrying its
    log row in ``info`` (columns renamed by ``column_subs``, PotEng ->
    energy by default) and its dump columns (fx, fy, fz, ...) as
    arrays."""
    if column_subs is None:
        column_subs = {"PotEng": "energy"}
    log = parse_lammps_log(os.path.join(path, log_fname),
                           log_regex=log_regex)
    log = {column_subs.get(k, k): v for k, v in log.items()}
    log_timesteps = log["Step"].copy()
    steps, snapshots = parse_lammps_dump(os.path.join(path, dump_fname),
                                         lammps_aliases,
                                         timesteps=log_timesteps)
    remaining_steps = log_timesteps.copy()
    remaining_idx = np.arange(len(log_timesteps))
    for timestep, geom in zip(steps, snapshots):
        i = np.flatnonzero(remaining_steps == timestep)[0]
        row = remaining_idx[i]
        remaining_steps = np.delete(remaining_steps, i)
        remaining_idx = np.delete(remaining_idx, i)
        geom.info.update({k: v[row].item() for k, v in log.items()})
    return snapshots


def identify_paths(experiment_path: str = ".",
                   filename: str = None,
                   filename_pattern: str = None) -> List[str]:
    data_paths = []
    if filename is not None:
        if os.path.isfile(filename):
            data_paths.append(filename)
        elif os.path.isfile(os.path.join(experiment_path, filename)):
            data_paths.append(filename)
    if filename_pattern is not None:
        for directory, _, files in os.walk(experiment_path):
            for name in files:
                if fnmatch.fnmatch(name, filename_pattern):
                    data_paths.append(os.path.join(directory, name))
    return data_paths


def read_sources(data_paths: List[str], max_samples: int = -1,
                 min_diff: float = 0.0) -> Tuple[List[str], List[Atoms]]:
    """Configurations of extended-xyz files, and of ``*.xml`` /
    ``vasprun*`` files through ``read_vasprun``, named "<file>_<i>" (the
    file's path past the paths' common directory, "/" as "-"), with
    per-file farthest-point subsampling on per-atom energies (0 where a
    frame has none) when both ``max_samples`` and ``min_diff`` are
    positive.  Files that do not parse are skipped."""
    common_path = os.path.dirname(os.path.commonprefix(data_paths))
    keys, geometries = [], []
    for data_path in data_paths:
        prefix = data_path[len(common_path):].replace("/", "-").lstrip("-")
        basename = os.path.basename(data_path)
        reader = read_vasprun if (basename.endswith(".xml")
                                  or "vasprun" in basename) else read_xyz
        try:
            found = reader(data_path)
        except (ValueError, IndexError, KeyError, AttributeError,
                FileNotFoundError, SyntaxError):
            continue
        if not found:
            continue
        energy_list = np.array([g.info.get("energy", 0.0) / len(g)
                                for g in found])
        if max_samples > 0 and min_diff > 0:
            samples = subsample.farthest_point_sampling(
                energy_list, max_samples=max_samples, min_diff=min_diff)
        else:
            samples = np.arange(len(energy_list))
        for i in np.sort(samples):
            keys.append(f"{prefix}_{i}")
            geometries.append(found[i])
    return keys, geometries


FEATURIZATION = "Featurization"
FEATURE_KEYS = ("x_e", "y_e", "x_f", "y_f")


def npz_features_path(path: str) -> str:
    """``path`` if it names an ``.npz`` features file; an HDF5 path
    raises (ROADMAP.md, Featurization)."""
    if path.endswith((".h5", ".hdf5")):
        raise _not_ported(f"the HDF5 features file {path} (this package "
                          "writes .npz)", FEATURIZATION)
    return path


def load_features(path: str):
    """(x_e, y_e, x_f, y_f) of a features file ``featurize`` wrote."""
    with np.load(npz_features_path(path)) as data:
        return tuple(data[k] for k in FEATURE_KEYS)
