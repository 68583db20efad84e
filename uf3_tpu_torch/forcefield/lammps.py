"""
LAMMPS interop: tabulated pair-potential export (pair_style table) and
native ``.uf3`` potential-file generation (pair_style uf3), their
readers, a LAMMPS data-file writer, and ``UFLammps`` on the port's
calculator.

Format parity with uf3/forcefield/lammps.py:218-271 and
lammps_plugin/scripts/generate_uf3_lammps_pots.py:60-165 (the factor-2
bond convention, knot-spacing flags, and block layout), so potentials
fitted here drop into the upstream C++ ``pair_style uf3``.

Host copy of ``uf3_tpu/forcefield/lammps.py``: for the same model the
writers write the same text (apart from the date).  ``UFLammps`` runs
its native backend on ``UFCalculator`` (the CUDA card unless
``device="cpu"``); its in-process LAMMPS backend is not ported.
"""

import os
from datetime import datetime
from typing import Dict, List, Tuple

import numpy as np

from uf3_tpu_torch import io
from uf3_tpu_torch.data import elements
from uf3_tpu_torch.data.atoms import Atoms
from uf3_tpu_torch.forcefield.md import _not_ported
from uf3_tpu_torch.representation import splines as sp

LAMMPS_BACKEND = "LAMMPS library backend"


def export_tabulated_potential(knot_sequence: np.ndarray,
                               coefficients: np.ndarray,
                               interaction: Tuple[str, str],
                               grid: int = None,
                               filename: str = None,
                               contributor: str = None,
                               rounding: int = 6) -> str:
    """Write a pair_style-table file; energies/forces carry the factor
    of 2 because LAMMPS does not double-count bonds."""
    date = datetime.now().strftime("%m/%d/%Y")
    contributor = contributor or ""
    if not isinstance(interaction[0], str):
        interaction = [elements.chemical_symbols[int(z)]
                       for z in interaction]
    tag = "-".join(interaction)
    if grid is None:
        grid = 100
    if isinstance(grid, int):
        x_table = np.linspace(knot_sequence[0], knot_sequence[-1], grid)
    else:
        x_table = np.asarray(grid)
    lines = [
        f"# DATE: {date}  UNITS: metal  CONTRIBUTOR: {contributor}",
        f"# Ultra-Fast Force Field for {tag}\n",
        f"UF_{tag}",
        f"N {len(x_table)}\n",
    ]
    # clamp samples inside the knot span for exact boundary evaluation
    x_eval = np.clip(x_table, knot_sequence[0],
                     knot_sequence[-1] - 1e-12)
    e_values = sp.evaluate_spline(x_eval, knot_sequence, coefficients) * 2
    f_values = -sp.evaluate_spline(x_eval, knot_sequence, coefficients,
                                   nu=1) * 2
    fmt = f"{{0}} {{1:.{rounding}f}} {{2:.{rounding}f}} {{3:.{rounding}f}}"
    for i, (r, e, f) in enumerate(zip(x_table, e_values, f_values)):
        lines.append(fmt.format(i + 1, r, e, f))
    text = "\n".join(lines)
    if filename is not None:
        with open(filename, "w") as f:
            f.write(text)
    return text


def write_lammps_data(filename: str,
                      geom: Atoms,
                      element_list: List[str],
                      masses: bool = True) -> None:
    """Minimal LAMMPS data-file writer (atomic style, triclinic-safe
    for upper-triangular cells)."""
    cell = geom.get_cell()
    if not np.allclose(cell, np.triu(cell) * 0 + np.tril(cell)):
        # general cells require rotation to LAMMPS lower-triangular form
        q, r = np.linalg.qr(cell.T)
        rotation = q
        cell = (cell @ rotation)
        positions = geom.get_positions() @ rotation
    else:
        positions = geom.get_positions()
    type_map = {el: i + 1 for i, el in enumerate(element_list)}
    symbols = geom.get_chemical_symbols()
    lines = ["# LAMMPS data file written by uf3_tpu", "",
             f"{len(geom)} atoms", f"{len(element_list)} atom types", "",
             f"0.0 {cell[0, 0]:.10f} xlo xhi",
             f"0.0 {cell[1, 1]:.10f} ylo yhi",
             f"0.0 {cell[2, 2]:.10f} zlo zhi"]
    if abs(cell[1, 0]) + abs(cell[2, 0]) + abs(cell[2, 1]) > 1e-12:
        lines.append(f"{cell[1, 0]:.10f} {cell[2, 0]:.10f} "
                     f"{cell[2, 1]:.10f} xy xz yz")
    if masses:
        lines += ["", "Masses", ""]
        for el, t in type_map.items():
            lines.append(
                f"{t} {elements.atomic_masses[elements.atomic_numbers[el]]}")
    lines += ["", "Atoms", ""]
    for i in range(len(geom)):
        x, y, z = positions[i]
        lines.append(f"{i + 1} {type_map[symbols[i]]} "
                     f"{x:.10f} {y:.10f} {z:.10f}")
    with open(filename, "w") as f:
        f.write("\n".join(lines) + "\n")


def _format_vector(values, fmt="{:.17g}") -> str:
    return " ".join(fmt.format(float(v)) for v in values)


def write_uf3_lammps_pot_files(chemical_sys=None,
                               model=None,
                               knots_spacing_type: str = "nk",
                               pot_dir: str = ".",
                               uf3_lammps_pot_name: str = None,
                               author: str = "uf3_tpu",
                               lammps_units: str = "metal") -> str:
    """
    Write the combined native ``pair_style uf3`` potential file.

    Block layout matches lammps_plugin/scripts/
    generate_uf3_lammps_pots.py:58-165: per-interaction blocks with a
    header line (2B/3B + element symbols + trims + spacing flag),
    cutoffs and knot counts (3B in reversed jk/ik/ij order), knot
    vectors, coefficient counts, and coefficients (3B as the full
    decompressed L x M x N grid, one M-row per line).
    """
    config = model.bspline_config
    chemical_sys = chemical_sys or config.chemical_system
    if knots_spacing_type not in ("uk", "nk"):
        raise ValueError(f"Invalid knot spacing type {knots_spacing_type}; "
                         "use 'uk' or 'nk'.")
    if uf3_lammps_pot_name is None:
        uf3_lammps_pot_name = "".join(chemical_sys.element_list) + ".uf3"
    os.makedirs(pot_dir, exist_ok=True)
    now = datetime.now().strftime("%Y-%m-%d %H:%M:%S")
    sizes, offsets = config.get_interaction_partitions()
    blocks = {}
    for interaction in chemical_sys.interactions_map[2]:
        key = "_".join(interaction)
        text = (f"#UF3 POT UNITS: {lammps_units} DATE: {now} "
                f"AUTHOR: {author} CITATION:\n")
        text += (f"2B {interaction[0]} {interaction[1]} "
                 f"{config.leading_trim[2]} {config.trailing_trim[2]} "
                 f"{knots_spacing_type}\n")
        knots = config.knots_map[interaction]
        text += f"{config.r_max_map[interaction]} {len(knots)}\n"
        text += _format_vector(knots) + "\n"
        text += f"{sizes[interaction]}\n"
        start = offsets[interaction]
        text += _format_vector(
            model.coefficients[start:start + sizes[interaction]]) + "\n"
        text += "#\n"
        blocks[key] = text
    solutions = io.arrange_coefficients(model.coefficients, config)
    for interaction in config.interactions_map.get(3, []):
        key = "_".join(interaction)
        text = (f"#UF3 POT UNITS: {lammps_units} DATE: {now} "
                f"AUTHOR: {author} CITATION:\n")
        text += (f"3B {interaction[0]} {interaction[1]} {interaction[2]} "
                 f"{config.leading_trim[3]} {config.trailing_trim[3]} "
                 f"{knots_spacing_type}\n")
        r_max = config.r_max_map[interaction]
        seqs = config.knots_map[interaction]
        text += (f"{r_max[2]} {r_max[1]} {r_max[0]} "
                 f"{len(seqs[2])} {len(seqs[1])} {len(seqs[0])}\n")
        text += _format_vector(seqs[2]) + "\n"
        text += _format_vector(seqs[1]) + "\n"
        text += _format_vector(seqs[0]) + "\n"
        grid = config.decompress_3B(solutions[interaction], interaction)
        text += f"{grid.shape[0]} {grid.shape[1]} {grid.shape[2]}\n"
        for i in range(grid.shape[0]):
            for j in range(grid.shape[1]):
                text += " ".join(map(str, grid[i, j])) + "\n"
        text += "#\n"
        blocks[key] = text
    path = os.path.join(pot_dir, uf3_lammps_pot_name)
    with open(path, "w") as f:
        for text in blocks.values():
            f.write(text)
    return path


def read_tabulated_potential(source: str) -> Dict:
    """
    Parse a ``pair_style table`` file written by
    ``export_tabulated_potential`` (or LAMMPS itself) back into arrays.

    Returns dict with 'r', 'energy', 'force' (as stored in the file,
    i.e. carrying the x2 bond convention) and 'keyword'.  Inverse of
    the exporter; used to validate export byte-semantics against the
    source model (reference format: uf3/forcefield/lammps.py:218-271).
    """
    if os.path.isfile(source):
        with open(source) as f:
            text = f.read()
    else:
        text = source
    keyword = None
    n_expected = None
    rows = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("N ") and n_expected is None:
            n_expected = int(line.split()[1])
            continue
        parts = line.split()
        if len(parts) == 4:
            try:
                rows.append([float(p) for p in parts[1:]])
                continue
            except ValueError:
                pass
        if keyword is None and len(parts) == 1:
            keyword = parts[0]
    if not rows:
        raise ValueError("no 4-column table rows found in the "
                         "potential table (index r energy force "
                         "per row expected)")
    data = np.asarray(rows)
    if n_expected is not None and len(data) != n_expected:
        raise ValueError(f"table declares N {n_expected} but has "
                         f"{len(data)} rows")
    return dict(keyword=keyword, r=data[:, 0], energy=data[:, 1],
                force=data[:, 2])


def read_uf3_lammps_pot_file(path: str) -> Dict:
    """
    Parse a combined native ``pair_style uf3`` potential file back into
    its blocks (inverse of ``write_uf3_lammps_pot_files``; format per
    lammps_plugin/scripts/generate_uf3_lammps_pots.py:58-165).

    Returns dict with:
      'elements'   -- sorted element symbols seen in any block
      'degree'     -- 3 if any 3B block is present else 2
      'trims'      -- (leading, trailing) from the block headers
      'knots_map'  -- interaction tuple -> knot vector (2B) or
                      [ij, ik, jk] knot vectors (3B, exporter order)
      'coefficients' -- interaction tuple -> coefficient vector (2B) or
                      full L x M x N grid (3B)
    suitable for ``model_from_uf3_pot_file``.
    """
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f]
    blocks: List[List[str]] = []
    current: List[str] = []
    for line in lines:
        if line.startswith("#UF3 POT"):
            current = []
            continue
        if line.strip() == "#":
            if current:
                blocks.append(current)
            current = []
            continue
        if line.strip():
            current.append(line)
    if current:
        blocks.append(current)
    knots_map: Dict[Tuple, np.ndarray] = {}
    coefficients: Dict[Tuple, np.ndarray] = {}
    elements_seen = []
    degree = 2
    leading: Dict[int, int] = {}
    trailing: Dict[int, int] = {}
    for block in blocks:
        header = block[0].split()
        kind = header[0]
        if kind == "2B":
            el = (header[1], header[2])
            leading[2], trailing[2] = int(header[3]), int(header[4])
            n_knots = int(block[1].split()[1])
            knots = np.asarray([float(v) for v in block[2].split()])
            if len(knots) != n_knots:
                raise ValueError("2B knot count mismatch")
            n_coeff = int(block[3].split()[0])
            coeff = np.asarray([float(v) for v in block[4].split()])
            if len(coeff) != n_coeff:
                raise ValueError("2B coefficient count mismatch")
            knots_map[el] = knots
            coefficients[el] = coeff
            for e in el:
                if e not in elements_seen:
                    elements_seen.append(e)
        elif kind == "3B":
            degree = 3
            trio = (header[1], header[2], header[3])
            leading[3], trailing[3] = int(header[4]), int(header[5])
            meta = block[1].split()
            n_jk, n_ik, n_ij = (int(meta[3]), int(meta[4]),
                                int(meta[5]))
            seq_jk = np.asarray([float(v) for v in block[2].split()])
            seq_ik = np.asarray([float(v) for v in block[3].split()])
            seq_ij = np.asarray([float(v) for v in block[4].split()])
            if (len(seq_jk), len(seq_ik), len(seq_ij)) != (n_jk, n_ik,
                                                           n_ij):
                raise ValueError("3B knot count mismatch")
            shape = tuple(int(v) for v in block[5].split())
            values = []
            for line in block[6:]:
                values.extend(float(v) for v in line.split())
            grid = np.asarray(values).reshape(shape)
            knots_map[trio] = [seq_ij, seq_ik, seq_jk]
            coefficients[trio] = grid
            for e in trio:
                if e not in elements_seen:
                    elements_seen.append(e)
        else:
            raise ValueError(f"Unknown block kind: {kind}")
    return dict(elements=elements_seen, degree=degree,
                leading_trim=leading, trailing_trim=trailing,
                knots_map=knots_map, coefficients=coefficients)


def model_from_uf3_pot_file(path: str):
    """
    Reconstruct a fitted model (``io.FittedModel``) from a native
    ``.uf3`` potential file, re-evaluable through this framework's own
    kernels.
    1-body offsets are not stored in the file format and load as zero.

    The export -> parse -> evaluate round trip validates that the
    written file carries exactly the model the C++ ``pair_style uf3``
    would consume (the reference has no reader; it can only write).
    """
    parsed = read_uf3_lammps_pot_file(path)
    solution = dict(parsed["coefficients"])
    for el in parsed["elements"]:
        solution.setdefault(el, 0.0)
    config = dict(element_list=parsed["elements"],
                  degree=parsed["degree"],
                  knots_map=parsed["knots_map"],
                  leading_trim=parsed["leading_trim"],
                  trailing_trim=parsed["trailing_trim"],
                  coefficients=solution)
    return io.from_dict(config)


def generate_lammps_input(model, pot_path: str) -> str:
    """pair_style/pair_coeff lines for a generated .uf3 file."""
    chemical_sys = model.bspline_config.chemical_system
    lines = [f"pair_style\tuf3 {model.bspline_config.degree} "
             f"{len(chemical_sys.element_list)}",
             f"pair_coeff\t* * {pot_path} "
             + " ".join(chemical_sys.element_list)]
    return "\n".join(lines)


class UFLammps:
    """
    LAMMPS-style calculator (reference UFLammps,
    uf3/forcefield/lammps.py:27-133, an ase.lammpslib subclass that
    drives a linked LAMMPS for evaluation, box/relax minimization,
    elastic constants, and phonons).

    ``backend="native"`` runs these operations through the port's own
    engine (``UFCalculator`` on ``device``, the CUDA card unless
    "cpu", with FIRE and box relaxation); ``backend="auto"`` takes it
    where no ``lammps`` module imports, as the reference does.  The
    in-process ``lammps`` backend is not ported: choosing it (or
    ``"auto"`` where ``lammps`` imports) raises NotImplementedError.

    Results dict after ``evaluate``/``relax``: ``energy``,
    ``free_energy`` (eV), ``forces`` (eV/A), ``stress`` (Voigt
    xx,yy,zz,yz,xz,xy in eV/A^3, ASE sign convention: -pressure),
    ``volume`` (A^3), and ``nsteps`` after ``relax``.
    """

    def __init__(self, model, backend: str = "auto",
                 pot_dir: str = None, device=None):
        self.model = model
        self.device = device
        self.results: Dict = {}
        self._calc = None
        if backend == "auto":
            try:
                import lammps  # noqa: F401
                backend = "lammps"
            except ImportError:
                backend = "native"
        if backend not in ("lammps", "native"):
            raise ValueError(f"unknown backend {backend!r}")
        if backend == "lammps":
            raise _not_ported("UFLammps(backend='lammps'), the in-process "
                              "LAMMPS library", LAMMPS_BACKEND)
        self.backend = backend
        self.pot_dir = pot_dir
        self.pot_path = None

    def _ensure_pot_files(self) -> str:
        """Export the native potential file on first use (needed by
        ``setup_commands``)."""
        if self.pot_path is None:
            if self.pot_dir is None:
                import tempfile
                self.pot_dir = tempfile.mkdtemp(prefix="uf3_pot_")
            self.pot_path = write_uf3_lammps_pot_files(
                model=self.model, pot_dir=self.pot_dir)
        return self.pot_path

    # -- shared surface --------------------------------------------------
    @property
    def element_list(self):
        return self.model.bspline_config.element_list

    def setup_commands(self, data_path: str) -> List[str]:
        """The LAMMPS command sequence that loads a data file and the
        exported ``pair_style uf3`` potential."""
        return (["units metal", "atom_style atomic", "boundary p p p",
                 f"read_data {data_path}"]
                + generate_lammps_input(
                    self.model, self._ensure_pot_files()).split("\n"))

    def evaluate(self, atoms) -> Dict:
        """Single-point energy / forces / stress."""
        return self._native_results(atoms)

    def relax(self, atoms, vmax: float = 0.001,
              max_steps: int = 125, etol: float = 0.0,
              ftol: float = 1e-3) -> Dict:
        """Isotropic box/relax minimization (reference RELAX_LINES,
        uf3/forcefield/lammps.py:22-24): positions and cell volume
        relax together; ``atoms`` is updated in place.  ``vmax`` and
        ``etol`` are the LAMMPS backend's and unused here."""
        from uf3_tpu_torch.forcefield import optimize
        relaxed = optimize.relax_with_cell(
            atoms, self._native_calc(), fmax=ftol,
            max_steps=max_steps)
        atoms.set_positions(relaxed.get_positions())
        atoms.set_cell(relaxed.get_cell())
        results = self._native_results(atoms)
        results["nsteps"] = relaxed.info.get("relax_nsteps",
                                             max_steps)
        return results

    def get_elastic_constants(self, atoms, **kwargs):
        """Finite-strain elastic constants (reference :121-124)."""
        from uf3_tpu_torch.forcefield.properties import elastic
        return elastic.get_elastic_constants(
            atoms, self._native_calc(), **kwargs)

    def get_phonon_data(self, atoms, n_super: int = 5,
                        disp: float = 0.05):
        """Frozen-phonon band data (reference :126-133)."""
        from uf3_tpu_torch.forcefield.properties import phonon
        return phonon.compute_phonon_data(
            atoms, self._native_calc(), n_super=n_super, disp=disp)

    # -- native backend --------------------------------------------------
    def _native_calc(self):
        if self._calc is None:
            from uf3_tpu_torch.forcefield.calculator import UFCalculator
            self._calc = UFCalculator(self.model, device=self.device)
        return self._calc

    def _native_results(self, atoms) -> Dict:
        calc = self._native_calc()
        energy = calc.get_potential_energy(atoms)
        self.results = dict(
            energy=energy, free_energy=energy,
            forces=calc.get_forces(atoms),
            stress=calc.get_stress(atoms),
            volume=atoms.get_volume())
        return self.results
