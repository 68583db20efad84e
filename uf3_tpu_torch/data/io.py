"""
Extended-xyz reading and writing: configurations with their energy in
the comment line and forces in a 'force'/'forces' property column; a
training set's files found by pattern and read with per-file
subsampling.

Copy of ``read_xyz`` and ``write_xyz`` with their comment and property
parsers, and of ``identify_paths``, from ``uf3_tpu/data/io.py`` (that
module imports pandas at module level, which the GPU hosts do not
carry): for the same configurations it writes the same text.
``read_sources`` is ``parse_with_subsampling`` for extended-xyz files,
returning named configurations where the reference fills a pandas
``DataCoordinator``.  The features file that ``featurize`` writes is
an ``.npz`` (``npz_features_path``, ``load_features``); an HDF5 path
raises.
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
    """Configurations of extended-xyz files, named "<file>_<i>" (the
    file's path past the paths' common directory, "/" as "-"), with
    per-file farthest-point subsampling on per-atom energies (0 where a
    frame has none) when both ``max_samples`` and ``min_diff`` are
    positive.  Files that do not parse are skipped."""
    common_path = os.path.dirname(os.path.commonprefix(data_paths))
    keys, geometries = [], []
    for data_path in data_paths:
        prefix = data_path[len(common_path):].replace("/", "-").lstrip("-")
        try:
            found = read_xyz(data_path)
        except (ValueError, IndexError, KeyError, FileNotFoundError):
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
