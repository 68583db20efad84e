"""
Extended-xyz reading and writing: configurations with their energy in
the comment line and forces in a 'force'/'forces' property column.

Copy of ``read_xyz`` and ``write_xyz`` with their comment and property
parsers from ``uf3_tpu/data/io.py`` (that module imports pandas at
module level, which the GPU hosts do not carry): for the same
configurations it writes the same text.
"""

import re
from io import StringIO
from typing import Dict, List, Tuple, Union

import numpy as np

from uf3_tpu_torch.data import elements
from uf3_tpu_torch.data.atoms import Atoms

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
