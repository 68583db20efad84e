"""
Reading and writing configurations: extended-xyz (energy in the comment
line, forces in a 'force'/'forces' property column), VASP
``vasprun.xml`` ionic steps, LAMMPS thermo logs with their text dumps
and ase.db SQLite files; a training set's sources found by pattern,
read with per-file subsampling into a ``DataCoordinator``.

Counterpart of ``uf3_tpu/data/io.py`` without pandas (that module
imports it at module level, and the GPU hosts do not carry it):
``read_xyz`` and ``write_xyz`` with their comment and property parsers,
``read_vasprun``, ``identify_paths``, the LAMMPS readers,
``read_vasp_pressure``, ``parse_with_subsampling``, ``DataCoordinator``
with ``parse_trajectory``, ``prepare_dataframe_from_lists``,
``concat_dataframes`` and ``update_dataframe_from_geometries``,
``get_max_forces`` / ``filter_max_forces`` and the ase.db cache
(``cache_data``, ``read_database``, the same schema and blobs): for the
same configurations it writes the same text and the same database
rows.  Where the reference builds DataFrames, the coordinator holds
``Dataset``s (keys in order, one column per name, row selection by
key); ``parse_lammps_log`` returns a dict of column arrays,
``parse_lammps_dump`` the matched timesteps and their configurations
(each snapshot through ``df_from_tsv_text``, a ``Dataset`` keyed by
atom id, and ``atoms_from_df``),
``parse_lammps_outputs`` the configurations with the log's columns in
their ``info``.  ``read_xyz`` sends a file of the standard layout to
the native tokenizer (``uf3_tpu_torch.native``), as the reference's
``parse_trajectory`` does, and ``read_xyz_python`` is its plain
version.  The features file that ``featurize`` writes is the
reference's HDF5 store of tables (``.h5`` / ``.hdf5``,
``representation.process.save_feature_db``) or an ``.npz`` of the
fitting arrays (``save_features``);
``regression.least_squares.feature_tables`` reads either.
"""

import fnmatch
import json
import os
import re
import sqlite3
import time
import uuid
from io import StringIO
from typing import Dict, List, Tuple, Union

import numpy as np

from uf3_tpu_torch.data import elements
from uf3_tpu_torch.data.atoms import Atoms
from uf3_tpu_torch.util import hdf5, subsample

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


DEFAULT_PROPERTIES = "species:S:1:pos:R:3"


def _frame(comment: Dict[str, str], numbers, columns: Dict) -> Atoms:
    """One configuration from its parsed comment line, its atomic numbers
    and its other columns, ``{name: (kind, width, values)}`` in the order
    of ``Properties`` (values: the (n, width) tokens, or the numbers the
    native tokenizer read)."""
    arrays = {}
    positions = None
    for name, (kind, width, values) in columns.items():
        if name == "pos":
            positions = np.array(values, dtype=float)
        elif kind == "S":
            arrays[name] = np.array([v[0] if width == 1 else v
                                     for v in values])
        else:
            arr = np.array(values, dtype=float if kind == "R" else int)
            arrays[name] = arr[:, 0] if width == 1 else arr
    cell = None
    pbc = False
    if "Lattice" in comment:
        cell = np.array(comment["Lattice"].split(),
                        dtype=float).reshape(3, 3)
        pbc = True
    if "pbc" in comment:
        pbc = [p.strip().upper() in ("T", "TRUE", "1")
               for p in comment["pbc"].split()]
    geom = Atoms(numbers, positions, cell=cell, pbc=pbc)
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
    return geom


def native_layout(filename) -> bool:
    """Whether ``read_xyz`` sends ``filename`` to the native tokenizer: a
    file path whose second line carries no per-axis ``pbc=`` (the
    reference's choice, ``uf3_tpu/data/io.py:398-412``)."""
    if not isinstance(filename, (str, os.PathLike)):
        return False
    with open(filename) as f:
        f.readline()
        return "pbc=" not in f.readline()


def read_xyz(filename: Union[str, StringIO],
             index: slice = None) -> List[Atoms]:
    """Read extended-xyz trajectory (energy in the comment line; forces
    from a 'force'/'forces' property column).  A file path of the
    standard layout (``native_layout``) goes through the native
    tokenizer (``uf3_tpu_torch.native.parse_extxyz_fast``, the same
    configurations); ``read_xyz_python`` reads every other input."""
    if native_layout(filename):
        from uf3_tpu_torch import native
        geometries = native.parse_extxyz_fast(os.fspath(filename))
        return geometries if index is None else geometries[index]
    return read_xyz_python(filename, index)


def read_xyz_python(filename: Union[str, StringIO],
                    index: slice = None) -> List[Atoms]:
    """``read_xyz`` in Python alone: the native tokenizer's plain
    version."""
    if isinstance(filename, (str, os.PathLike)):
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
            comment.get("Properties", DEFAULT_PROPERTIES))
        body = lines[pos + 2:pos + 2 + n_atoms]
        rows = [ln.split() for ln in body]
        col = 0
        species = None
        columns = {}
        for name, kind, width in props:
            values = [row[col:col + width] for row in rows]
            if name == "species":
                species = [v[0] for v in values]
            else:
                columns[name] = (kind, width, values)
            col += width
        geometries.append(_frame(
            comment, [elements.atomic_numbers[s] for s in species], columns))
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
    columns as int64, other numeric columns as float64, the rest as
    strings."""
    lines = [ln.split() for ln in text.strip().splitlines() if ln.strip()]
    header, rows = lines[0], lines[1:]
    out = {}
    for j, name in enumerate(header):
        values = [row[j] for row in rows]
        for parse, dtype in ((int, np.int64), (float, np.float64),
                             (str, str)):
            try:
                out[name] = np.array([parse(v) for v in values], dtype=dtype)
                break
            except ValueError:
                continue
    return out


def df_from_tsv_text(text: str) -> "Dataset":
    """A whitespace-separated table with an ``id`` column as a
    ``Dataset`` keyed by ``id``, its rows sorted by it (the reference's
    ``read_csv(...).set_index("id").sort_index()``)."""
    columns = _columns(text)
    ids = columns.pop("id")
    order = np.argsort(ids, kind="stable")
    return Dataset(ids[order].tolist(),
                   {k: v[order] for k, v in columns.items()})


def parse_lammps_log(fname: str, log_regex: str = None
                     ) -> Dict[str, np.ndarray]:
    """Thermo blocks (Step ... until 'Loop time') as one dict of column
    arrays, repeated rows dropped (the first kept)."""
    return _lammps_log(fname, log_regex)[0]


def _lammps_log(fname: str, log_regex: str = None):
    """``parse_lammps_log``'s columns and, for each row kept, its position
    among the rows of every block (the reference's row labels)."""
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
    return {name: values[keep] for name, values in merged.items()}, keep


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


def atoms_from_df(df, element_key: str = "element",
                  lammps_aliases: Dict = None, info: Dict = None,
                  **atom_kwargs) -> Atoms:
    """Atoms from per-atom columns (a ``Dataset`` of atoms, as
    ``df_from_tsv_text`` gives, or a dict of columns): x/y/z the
    positions, ``element_key`` the species (symbols or atomic numbers,
    through ``lammps_aliases``), every other column a per-atom array;
    ``atom_kwargs`` (``cell``, ``pbc``) to ``Atoms``."""
    lammps_aliases = lammps_aliases or {}
    columns = df.columns if isinstance(df, Dataset) else df
    positions = np.stack([np.asarray(columns[c], dtype=np.float64)
                          for c in ("x", "y", "z")], axis=1)
    numbers = []
    for item in columns[element_key]:
        item = lammps_aliases.get(item, item)
        if isinstance(item, str) and item in elements.atomic_numbers:
            numbers.append(elements.atomic_numbers[item])
        else:
            numbers.append(int(item))
    atoms = Atoms(numbers, positions, **atom_kwargs)
    for key in set(columns) - {"x", "y", "z", element_key}:
        atoms.set_array(key, np.asarray(columns[key]))
    atoms.info = dict(info or {})
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
                    atoms = atoms_from_df(
                        df_from_tsv_text("\n".join(atom_lines)),
                        element_key="type", lammps_aliases=lammps_aliases,
                        cell=cell, pbc=pbc)
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
    return _lammps_matched(path, lammps_aliases, column_subs, log_fname,
                           dump_fname, log_regex)[1]


def _lammps_matched(path, lammps_aliases, column_subs=None,
                    log_fname="log.lammps", dump_fname="dump.lammpstrj",
                    log_regex=None):
    """``parse_lammps_outputs``' snapshots with the log's row labels they
    matched and the log's (renamed) columns: (labels, snapshots,
    columns)."""
    if column_subs is None:
        column_subs = {"PotEng": "energy"}
    log, labels = _lammps_log(os.path.join(path, log_fname),
                              log_regex=log_regex)
    log = {column_subs.get(k, k): v for k, v in log.items()}
    log_timesteps = log["Step"].copy()
    steps, snapshots = parse_lammps_dump(os.path.join(path, dump_fname),
                                         lammps_aliases,
                                         timesteps=log_timesteps)
    remaining_steps = log_timesteps.copy()
    remaining_idx = np.arange(len(log_timesteps))
    rows = []
    for timestep, geom in zip(steps, snapshots):
        i = np.flatnonzero(remaining_steps == timestep)[0]
        rows.append(remaining_idx[i])
        remaining_steps = np.delete(remaining_steps, i)
        remaining_idx = np.delete(remaining_idx, i)
        geom.info.update({k: v[rows[-1]].item() for k, v in log.items()})
    columns = {k: v[np.asarray(rows, dtype=np.int64)]
               for k, v in log.items()}
    return [labels[r] for r in rows], snapshots, columns


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


# ---------------------------------------------------------------------------
# datasets: the DataCoordinator's tables without pandas
# ---------------------------------------------------------------------------
class Dataset:
    """Configurations by key, in order, with one column per name: the
    table a ``DataCoordinator`` consolidates, where the reference builds
    a pandas DataFrame.  A column is a numpy array (energies, sizes, a
    LAMMPS log's columns) or a list (the geometries; the per-atom force
    components ``fx``, ``fy``, ``fz``, None where a configuration has
    none).  ``dataset[name]`` is a column, ``select(keys)`` the rows of
    ``keys`` and ``take(positions)`` the rows at ``positions``."""

    def __init__(self, keys, columns: Dict):
        self.keys = list(keys)
        self.columns = dict(columns)
        for name, values in self.columns.items():
            if len(values) != len(self.keys):
                raise ValueError(f"column {name!r} has {len(values)} rows, "
                                 f"the keys {len(self.keys)}")

    def __len__(self) -> int:
        return len(self.keys)

    def __getitem__(self, name: str):
        return self.columns[name]

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    def __repr__(self) -> str:
        return (f"Dataset({len(self)} configurations, columns "
                f"{list(self.columns)})")

    def take(self, positions) -> "Dataset":
        positions = [int(i) for i in positions]
        return Dataset([self.keys[i] for i in positions],
                       {name: _rows_at(values, positions)
                        for name, values in self.columns.items()})

    def select(self, keys) -> "Dataset":
        """The rows of ``keys``, in their order (KeyError for a key the
        dataset lacks)."""
        where = {key: i for i, key in enumerate(self.keys)}
        return self.take([where[key] for key in keys])

    def rename(self, name_of) -> "Dataset":
        """The same rows under the keys ``name_of(key)``."""
        return Dataset([name_of(key) for key in self.keys], self.columns)


def _rows_at(values, positions):
    if isinstance(values, np.ndarray):
        return values[np.asarray(positions, dtype=np.int64)]
    return [values[i] for i in positions]


def _missing(value) -> bool:
    """A cell the reference's DataFrame holds as NaN: None, a NaN
    scalar, or an array holding a NaN."""
    if value is None:
        return True
    try:
        return bool(np.any(np.isnan(np.asarray(value, dtype=float))))
    except (TypeError, ValueError):
        return False


def _set_scalar(df: Dataset, name: str, idx: int, value) -> None:
    """One scalar cell; a column that meets a value no float holds
    becomes a list, as a DataFrame's column becomes an object column."""
    column = df.columns[name]
    if isinstance(column, np.ndarray):
        try:
            column[idx] = value
            return
        except (TypeError, ValueError):
            column = df.columns[name] = column.tolist()
    column[idx] = value


def update_dataframe_from_geometries(df: Dataset,
                                     scalar_keys=(),
                                     array_keys=(),
                                     atoms_key: str = "geometry",
                                     size_key: str = "size",
                                     inplace: bool = True) -> Dataset:
    """Fill ``df``'s size column and its ``scalar_keys`` / ``array_keys``
    columns from each geometry's ``info`` / ``arrays`` (columns made
    where missing: sizes 0, scalars NaN, arrays None; a value the
    geometry lacks keeps the column's)."""
    if not inplace:
        df = Dataset(df.keys, {name: values.copy() if isinstance(
            values, np.ndarray) else list(values)
            for name, values in df.columns.items()})
    n = len(df)
    for scalar in list(scalar_keys) + [size_key]:
        if scalar not in df:
            df.columns[scalar] = np.zeros(n, dtype=np.int64) \
                if scalar == size_key else np.full(n, np.nan)
    for array in array_keys:
        if array not in df:
            df.columns[array] = [None] * n
    for idx, geom in enumerate(df[atoms_key]):
        _set_scalar(df, size_key, idx, len(geom))
        for scalar in scalar_keys:
            if scalar in geom.info:
                _set_scalar(df, scalar, idx, geom.info[scalar])
        for array in array_keys:
            if array in geom.arrays:
                df[array][idx] = geom.arrays[array]
    return df


def parse_trajectory(fname: str,
                     scalar_keys=(),
                     array_keys=(),
                     prefix: str = None,
                     atoms_key: str = "geometry",
                     energy_key: str = "energy",
                     force_key: str = "force",
                     size_key: str = "size") -> Dataset:
    """A trajectory file as a ``Dataset``: ``*.xml`` / ``vasprun*``
    through ``read_vasprun``, ``*.db`` through ``read_database``, any
    other file as extended-xyz.  The energy column reads ``energy_key``
    from each configuration's ``info`` (0.0 where it has none), the
    force columns its fx / fy / fz arrays.  Extended-xyz goes through
    ``read_xyz`` (the native tokenizer where the layout allows) only
    when the keys are the standard ones; any other key takes
    ``read_xyz_python``, as the reference rules
    (``uf3_tpu/data/io.py:434-441``)."""
    basename = os.path.basename(fname)
    if basename.endswith(".xml") or "vasprun" in basename:
        geometries = read_vasprun(fname)
    elif basename.endswith(".db"):
        geometries = read_database(fname)
    elif (not scalar_keys and not array_keys
          and energy_key.lower() == "energy"
          and force_key.lower() in ("force", "forces")):
        geometries = read_xyz(fname)
    else:
        geometries = read_xyz_python(fname)
    default_columns = [atoms_key, energy_key, "fx", "fy", "fz"]
    scalar_keys = [k for k in scalar_keys if k not in default_columns]
    array_keys = [k for k in array_keys if k not in default_columns]
    n = len(geometries)
    df = Dataset(range(n), {atoms_key: list(geometries),
                            energy_key: np.zeros(n)})
    df = update_dataframe_from_geometries(
        df, atoms_key=atoms_key, size_key=size_key,
        scalar_keys=list(scalar_keys) + [energy_key],
        array_keys=list(array_keys) + ["fx", "fy", "fz"])
    if prefix is not None:
        df = df.rename(lambda i: f"{prefix}_{i}")
    return df


def prepare_dataframe_from_lists(geometries: List[Atoms],
                                 prefix: str = None,
                                 energies=None,
                                 forces=None,
                                 atoms_key: str = "geometry",
                                 energy_key: str = "energy",
                                 force_key: str = "force",
                                 size_key: str = "size",
                                 copy: bool = True) -> Dataset:
    """A ``Dataset`` of ``geometries`` (copied unless ``copy`` is False):
    ``energies`` and (N, 3) ``forces`` where given, which also go into
    each geometry's ``info`` / ``arrays``; otherwise read from them."""
    if copy:
        geometries = [geom.copy() for geom in geometries]
    columns = {atoms_key: list(geometries)}
    if energies is not None:
        columns[energy_key] = np.asarray(energies, dtype=float)
        for geom, energy in zip(geometries, energies):
            geom.info[energy_key] = energy
    if forces is not None:
        forces = [np.asarray(force) for force in forces]
        for c, name in enumerate(("fx", "fy", "fz")):
            columns[name] = [force[:, c] for force in forces]
            for geom, force in zip(geometries, forces):
                geom.arrays[name] = force[:, c]
    df = update_dataframe_from_geometries(
        Dataset(range(len(geometries)), columns), atoms_key=atoms_key,
        size_key=size_key,
        scalar_keys=[energy_key] if energies is None else [],
        array_keys=["fx", "fy", "fz"] if forces is None else [])
    if prefix is not None:
        df = df.rename(lambda i: f"{prefix}_{i}")
    return df


def _duplicated(keys, keep) -> np.ndarray:
    """pandas' ``Index.duplicated(keep=...)``: "first" marks every
    repeat after the first, "last" every one before the last, False
    every key that repeats."""
    keys = list(keys)
    if keep is False:
        counts = {}
        for key in keys:
            counts[key] = counts.get(key, 0) + 1
        return np.array([counts[key] > 1 for key in keys], dtype=bool)
    if keep not in ("first", "last"):
        raise ValueError("keep must be 'first', 'last' or False")
    order = range(len(keys)) if keep == "first" \
        else range(len(keys) - 1, -1, -1)
    out, seen = np.zeros(len(keys), dtype=bool), set()
    for i in order:
        out[i] = keys[i] in seen
        seen.add(keys[i])
    return out


def concat_dataframes(dataframes: List[Dataset],
                      remove_duplicates: bool = True,
                      keep: str = "first") -> Dataset:
    """The rows of ``dataframes`` one after the other (a column one of
    them lacks filled with NaN, or None in a list column); repeated keys
    are counted and, with ``remove_duplicates``, dropped but for the one
    ``keep`` names."""
    if not dataframes:
        raise ValueError("No objects to concatenate")
    names = list(dict.fromkeys(name for df in dataframes
                               for name in df.columns))
    columns = {}
    for name in names:
        parts = [df[name] if name in df else None for df in dataframes]
        if all(isinstance(p, np.ndarray) for p in parts if p is not None):
            columns[name] = np.concatenate([
                p if p is not None else np.full(len(df), np.nan)
                for p, df in zip(parts, dataframes)])
        else:
            columns[name] = [v for p, df in zip(parts, dataframes)
                             for v in (list(p) if p is not None
                                       else [None] * len(df))]
    df = Dataset([key for part in dataframes for key in part.keys], columns)
    duplicates = _duplicated(df.keys, keep)
    if np.any(duplicates):
        print("Duplicates keys found:", int(np.sum(duplicates)))
        if remove_duplicates:
            df = df.take(np.flatnonzero(~duplicates))
    return df


class DataCoordinator:
    """Load trajectories from multiple sources with prefix-indexed keys:
    each source a ``Dataset`` under its prefix, ``consolidate`` their
    rows in load order."""

    def __init__(self,
                 atoms_key: str = "geometry",
                 energy_key: str = "energy",
                 force_key: str = "force",
                 size_key: str = "size",
                 overwrite: bool = False):
        self.atoms_key = atoms_key
        self.energy_key = energy_key
        self.force_key = force_key
        self.size_key = size_key
        self.overwrite = overwrite
        self.data: Dict = {}
        self.keys: List = []

    @staticmethod
    def from_config(config: Dict) -> "DataCoordinator":
        keys = ["atoms_key", "energy_key", "force_key", "size_key",
                "overwrite"]
        return DataCoordinator(**{k: v for k, v in config.items()
                                  if k in keys})

    def __repr__(self):
        if not self.keys:
            return "DataCoordinator:\n    Datasets: None"
        return (f"DataCoordinator:\n    Datasets: {len(self.keys)} "
                f"({self.keys})")

    def consolidate(self, remove_duplicates: bool = True,
                    keep: str = "first") -> Dataset:
        return concat_dataframes([self.data[k] for k in self.keys],
                                 remove_duplicates=remove_duplicates,
                                 keep=keep)

    def load_dataframe(self, dataframe: Dataset, prefix: str = None) -> None:
        for key in (self.atoms_key, self.energy_key, self.size_key):
            if key not in dataframe:
                raise RuntimeError(f'Missing "{key}" column.')
        name_0 = dataframe.keys[0]
        if isinstance(name_0, str) and "_" in name_0:
            prefix = "_".join(name_0.split("_")[:-1])
        if prefix is None:
            prefix = len(self.data)
            dataframe = dataframe.rename(lambda i: f"{prefix}_{i}")
        if prefix in self.data:
            print(f'Data already exists with prefix "{prefix}".', end=" ")
            if self.overwrite:
                print("Overwriting...")
                self.data[prefix] = dataframe
            else:
                print("Skipping...")
            return
        self.data[prefix] = dataframe
        self.keys.append(prefix)

    def dataframe_from_lists(self, geometries, prefix=None, energies=None,
                             forces=None, load: bool = True, **kwargs):
        if prefix is None:
            prefix = len(self.data)
        df = prepare_dataframe_from_lists(
            geometries, prefix, energies=energies, forces=forces,
            atoms_key=self.atoms_key, energy_key=self.energy_key,
            force_key=self.force_key, size_key=self.size_key, **kwargs)
        if load:
            self.load_dataframe(df, prefix=prefix)
        else:
            return df

    def dataframe_from_trajectory(self, filename, prefix=None,
                                  load: bool = True, energy_key=None,
                                  force_key=None, **kwargs):
        if prefix is None:
            prefix = len(self.data)
        energy_key = energy_key or self.energy_key
        force_key = force_key or self.force_key
        df = parse_trajectory(filename, prefix=prefix,
                              atoms_key=self.atoms_key,
                              energy_key=energy_key,
                              force_key=force_key,
                              size_key=self.size_key, **kwargs)
        if energy_key != self.energy_key:
            df.columns[self.energy_key] = df.columns.pop(energy_key)
        if load:
            self.load_dataframe(df, prefix=prefix)
        else:
            return df

    dataframe_from_xyz = dataframe_from_trajectory
    dataframe_from_vasprun = dataframe_from_trajectory

    def dataframe_from_lammps_run(self, path, lammps_aliases, prefix=None,
                                  column_subs=None,
                                  log_fname="log.lammps",
                                  dump_fname="dump.lammpstrj",
                                  load: bool = True, **kwargs):
        if prefix is None:
            prefix = len(self.data)
        df = _lammps_dataset(path, lammps_aliases, prefix=prefix,
                             column_subs=column_subs or {"PotEng": "energy"},
                             log_fname=log_fname, dump_fname=dump_fname,
                             atoms_key=self.atoms_key,
                             size_key=self.size_key, **kwargs)
        if load:
            self.load_dataframe(df, prefix=prefix)
        else:
            return df


def _lammps_dataset(path, lammps_aliases, prefix=None, column_subs=None,
                    log_fname="log.lammps", dump_fname="dump.lammpstrj",
                    atoms_key="geometry", size_key="size",
                    log_regex=None) -> Dataset:
    """A LAMMPS run as a ``Dataset``: the log's columns at the matched
    rows, the dump's snapshots, the energy and force columns from them;
    keys "<prefix>_<log row>" (the row among every block's rows)."""
    labels, snapshots, columns = _lammps_matched(
        path, lammps_aliases, column_subs, log_fname, dump_fname, log_regex)
    df = Dataset(labels, dict(columns, **{atoms_key: snapshots}))
    if prefix is not None:
        df = df.rename(lambda i: f"{prefix}_{i}")
    return update_dataframe_from_geometries(
        df, atoms_key=atoms_key, size_key=size_key, scalar_keys=["energy"],
        array_keys=["fx", "fy", "fz"])


# ---------------------------------------------------------------------------
# sources: VASP pressure, subsampling, force filtering
# ---------------------------------------------------------------------------
_NUMBER = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eEdD][-+]?\d+)?")


def _pstress_of(line: str):
    """The PSTRESS value (kbar) ``line`` sets: the first number after
    the tag, before any ``!`` / ``#`` comment; None where the line sets
    none (no tag, the tag inside a comment, or no number)."""
    head, tag, rest = line.partition("PSTRESS")
    if not tag or "!" in head or "#" in head:
        return None
    found = _NUMBER.search(re.split(r"[!#]", rest, maxsplit=1)[0])
    if found is None:
        return None
    return float(found.group().replace("d", "e").replace("D", "e"))


def read_vasp_pressure(path: str) -> float:
    """PSTRESS from INCAR / OUTCAR / vasprun.xml in ``path`` (the first
    file that sets it), kbar converted to eV/A^3, for the H = E + PV
    enthalpy correction; 0.0 where none sets it.  The value is parsed
    with its sign and without the digits of a trailing comment, where
    the reference keeps every digit and dot of the line
    (``uf3_tpu/data/io.py:632``; ROADMAP.md section 3)."""
    for fname in ("INCAR", "OUTCAR", "vasprun.xml"):
        full = os.path.join(path, fname)
        if not os.path.isfile(full):
            continue
        with open(full) as f:
            for line in f:
                pstress = _pstress_of(line)
                if pstress is not None:
                    return pstress * 1e-22 / 1.602176634e-19
    return 0.0


# files a source directory may hold beside its trajectories (an INCAR, a
# binary) fail to parse with one of these, and are skipped
_UNREADABLE = (ValueError, IndexError, KeyError, AttributeError,
               FileNotFoundError, SyntaxError, sqlite3.DatabaseError)


def parse_with_subsampling(data_paths: List[str],
                           data_coordinator: DataCoordinator,
                           max_samples: int = 100,
                           min_diff: float = 1e-3,
                           vasp_pressure: bool = False,
                           lammps_log: str = None,
                           lammps_aliases: Dict = None,
                           verbose: bool = False) -> None:
    """Load many files into ``data_coordinator``, each under the prefix
    of its path past the paths' common directory ("/" as "-"), with
    per-file farthest-point subsampling on per-atom energies when both
    ``max_samples`` and ``min_diff`` are positive.  ``lammps_log``: each
    path is a LAMMPS dump beside that log (TotEng as the energy).
    ``vasp_pressure``: each configuration's energy less P V, P the
    PSTRESS of its directory (``read_vasp_pressure``).  Files that do
    not parse are skipped."""
    common_path = os.path.dirname(os.path.commonprefix(data_paths))
    energy_key = data_coordinator.energy_key
    size_key = data_coordinator.size_key
    for data_path in data_paths:
        prefix = data_path[len(common_path):].replace("/", "-").lstrip("-")
        try:
            if lammps_log is not None:
                lammps_path, dump_fname = os.path.split(data_path)
                df = data_coordinator.dataframe_from_lammps_run(
                    lammps_path, lammps_aliases, prefix=prefix,
                    load=False, log_fname=lammps_log,
                    dump_fname=dump_fname,
                    column_subs={"TotEng": "energy"})
            else:
                df = data_coordinator.dataframe_from_trajectory(
                    data_path, prefix=prefix, load=False)
        except _UNREADABLE:
            continue
        if df is None or len(df) == 0:
            continue
        energy_list = (np.asarray(df[energy_key], dtype=float)
                       / np.asarray(df[size_key], dtype=float))
        if max_samples > 0 and min_diff > 0:
            samples = subsample.farthest_point_sampling(
                energy_list, max_samples=max_samples, min_diff=min_diff)
        else:
            samples = np.arange(len(energy_list))
        if verbose:
            print(f"{len(samples)}/{len(energy_list)} samples from "
                  f"{prefix}.")
        df = df.take(np.sort(samples))
        if vasp_pressure and lammps_log is None:
            pressure = read_vasp_pressure(os.path.dirname(data_path))
            if pressure != 0:
                volumes = [g.get_volume()
                           for g in df[data_coordinator.atoms_key]]
                df.columns[energy_key] = df[energy_key] - np.multiply(
                    volumes, pressure)
        data_coordinator.load_dataframe(df, prefix=prefix)


def read_sources(data_paths: List[str], max_samples: int = -1,
                 min_diff: float = 0.0) -> Tuple[List[str], List[Atoms]]:
    """The keys and configurations ``parse_with_subsampling`` loads from
    ``data_paths`` with the default keys: each named "<file>_<i>" (the
    file's path past the paths' common directory, "/" as "-")."""
    coordinator = DataCoordinator()
    parse_with_subsampling(data_paths, coordinator,
                           max_samples=max_samples, min_diff=min_diff)
    if not coordinator.keys:
        return [], []
    dataset = coordinator.consolidate()
    return dataset.keys, dataset[coordinator.atoms_key]


def get_max_forces(*component_views) -> float:
    """The largest per-atom force norm of one configuration's fx, fy, fz
    (NaN where a component is missing)."""
    if any(v is None for v in component_views):
        return np.nan
    forces = np.vstack([np.asarray(v, dtype=float)
                        for v in component_views]).T
    return np.max(np.linalg.norm(forces, 2, axis=1))


def filter_max_forces(df_data, cutoff: float = 10,
                      force_keys=("fx", "fy", "fz"),
                      return_values: bool = False):
    """The keys of the configurations whose largest per-atom force norm
    is at most ``cutoff`` (a configuration without forces is dropped),
    and with ``return_values`` every configuration's largest norm.
    ``df_data`` is a ``Dataset``, or a list of configurations (keyed by
    position, the forces from their arrays)."""
    if not isinstance(df_data, Dataset):
        df_data = prepare_dataframe_from_lists(df_data, copy=False)
    max_forces = np.array([get_max_forces(*row) for row in zip(
        *(df_data[k] for k in force_keys))], dtype=float)
    matches = [key for key, value in zip(df_data.keys, max_forces)
               if value <= cutoff]
    if return_values:
        return matches, max_forces
    return matches


def dataset_forces(df_data: Dataset) -> List:
    """The (N, 3) forces of each configuration of a dataset, from its fx,
    fy, fz columns; None where a component is missing."""
    if not all(c in df_data for c in ("fx", "fy", "fz")):
        return [None] * len(df_data)
    return [None if any(_missing(c) for c in row)
            else np.stack([np.asarray(c, dtype=float) for c in row], axis=1)
            for row in zip(df_data["fx"], df_data["fy"], df_data["fz"])]


# ---------------------------------------------------------------------------
# ase.db (SQLite) interop -- dataset caching without an ase dependency
# ---------------------------------------------------------------------------
# Schema-compatible with ase.db's SQLite3 backend and identical to
# uf3_tpu/data/io.py's: numbers as int32 blobs, positions / cell /
# forces as float64 blobs, pbc bit-encoded, user metadata in the
# key_value_pairs JSON column.
_ASE_DB_SCHEMA = [
    """CREATE TABLE IF NOT EXISTS systems (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    unique_id TEXT UNIQUE,
    ctime REAL, mtime REAL, username TEXT,
    numbers BLOB, positions BLOB, cell BLOB, pbc INTEGER,
    initial_magmoms BLOB, initial_charges BLOB, masses BLOB,
    tags BLOB, momenta BLOB, constraints TEXT,
    calculator TEXT, calculator_parameters TEXT,
    energy REAL, free_energy REAL, forces BLOB, stress BLOB,
    dipole BLOB, magmoms BLOB, magmom REAL, charges BLOB,
    key_value_pairs TEXT, data TEXT,
    natoms INTEGER, fmax REAL, smax REAL,
    volume REAL, mass REAL, charge REAL)""",
    """CREATE TABLE IF NOT EXISTS information (
    name TEXT, value TEXT)""",
]


def cache_data(df_data: Dataset,
               filename: str,
               energy_key: str = "energy") -> None:
    """Cache a dataset's configurations as an ase.db-style SQLite
    database (geometry, the energy ``energy_key`` of its ``info``,
    forces and scalar info per row, the key as ``row_name``); appends
    to an existing file."""
    append = os.path.isfile(filename)
    con = sqlite3.connect(filename)
    try:
        cur = con.cursor()
        for stmt in _ASE_DB_SCHEMA:
            cur.execute(stmt)
        if not append:
            cur.execute("INSERT INTO information VALUES (?, ?)",
                        ("version", "9"))
        now = time.time()
        for name, geom in zip(df_data.keys, df_data["geometry"]):
            energy = float(geom.info.get(energy_key, np.nan))
            forces = None
            if all(k in geom.arrays for k in ("fx", "fy", "fz")):
                forces = np.vstack([geom.arrays["fx"],
                                    geom.arrays["fy"],
                                    geom.arrays["fz"]]).T
            info = {k: v for k, v in geom.info.items()
                    if isinstance(v, (int, float, str, np.floating))
                    and k != energy_key}
            info["row_name"] = str(name)
            numbers = np.ascontiguousarray(
                geom.get_atomic_numbers(), dtype=np.int32)
            positions = np.ascontiguousarray(
                geom.get_positions(), dtype=np.float64)
            cell = np.ascontiguousarray(np.asarray(geom.get_cell()),
                                        dtype=np.float64)
            pbc_bits = int(np.dot(np.asarray(geom.get_pbc(),
                                             dtype=int), [1, 2, 4]))
            cur.execute(
                """INSERT INTO systems
                   (unique_id, ctime, mtime, username, numbers,
                    positions, cell, pbc, energy, forces,
                    key_value_pairs, natoms)
                   VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?)""",
                (uuid.uuid4().hex, now, now, "uf3_tpu",
                 numbers.tobytes(), positions.tobytes(),
                 cell.tobytes(), pbc_bits,
                 None if np.isnan(energy) else energy,
                 None if forces is None
                 else np.ascontiguousarray(forces,
                                           np.float64).tobytes(),
                 json.dumps(info), len(geom)))
        con.commit()
    finally:
        con.close()


def read_database(filename: str, index: slice = None) -> List[Atoms]:
    """Read an ase.db-style SQLite database into configurations (energy
    into info, forces into fx/fy/fz arrays, key-value pairs merged into
    info), rows ``index`` (a slice) in insertion order."""
    con = sqlite3.connect(filename)
    try:
        cur = con.cursor()
        count = cur.execute("SELECT COUNT(*) FROM systems"
                            ).fetchone()[0]
        if index is None:
            index = slice(None, None)
        start, stop, _ = index.indices(count)
        if start == stop:
            return []
        rows = cur.execute(
            """SELECT numbers, positions, cell, pbc, energy, forces,
                      key_value_pairs
               FROM systems ORDER BY id LIMIT ? OFFSET ?""",
            (stop - start, start)).fetchall()
    finally:
        con.close()
    geometries = []
    for (numbers, positions, cell, pbc_bits, energy, forces,
         kv_json) in rows:
        numbers = np.frombuffer(numbers, dtype=np.int32)
        positions = np.frombuffer(positions,
                                  dtype=np.float64).reshape(-1, 3)
        cell = (np.frombuffer(cell, dtype=np.float64).reshape(3, 3)
                if cell is not None else None)
        pbc = [bool(pbc_bits & b) for b in (1, 2, 4)]
        geom = Atoms(numbers, positions,
                     cell=cell if cell is not None
                     and np.any(cell != 0) else None, pbc=pbc)
        if energy is not None:
            geom.info["energy"] = float(energy)
        if forces is not None:
            block = np.frombuffer(forces,
                                  dtype=np.float64).reshape(-1, 3)
            geom.arrays["fx"] = block[:, 0].copy()
            geom.arrays["fy"] = block[:, 1].copy()
            geom.arrays["fz"] = block[:, 2].copy()
        if kv_json:
            for k, v in json.loads(kv_json).items():
                geom.info[k] = v
        geometries.append(geom)
    return geometries


FEATURE_KEYS = ("x_e", "y_e", "x_f", "y_f")


def forces_of(geometries) -> List:
    """The (N, 3) forces of each configuration, None where it has
    none."""
    return [np.stack([g.arrays[c] for c in ("fx", "fy", "fz")], axis=1)
            if all(c in g.arrays for c in ("fx", "fy", "fz")) else None
            for g in geometries]


def save_features(path: str, arrays, keys, geometries, force_rows,
                  columns) -> None:
    """The ``.npz`` features file: (x_e, y_e, x_f, y_f), the
    configuration keys, sizes and force rows, the column names.  An
    HDF5 path raises: its tables are written by
    ``representation.process.save_feature_db``."""
    if hdf5.is_hdf5_path(path):
        raise ValueError(f"{path}: HDF5 tables are written by "
                         "save_feature_db, not as .npz arrays")
    with open(path, "wb") as f:
        np.savez(f, **dict(zip(FEATURE_KEYS, arrays)), keys=np.array(keys),
                 sizes=np.array([len(g) for g in geometries]),
                 force_rows=force_rows, columns=np.array(columns))
