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
``device="cpu"``) and its ``lammps`` backend through the in-process
``lammps`` Python module, imported only when a run needs it.

Three faults of the reference's LAMMPS path are repaired here:
``write_lammps_data`` rotated a general cell into a frame whose box
lengths LAMMPS refuses as negative (it now flips the rotation's axes so
that they are positive, and returns the rotation); the ``lammps``
backend returned forces and stress, and wrote a relaxed structure back,
in that rotated frame (they are rotated back into the caller's); and
its energy lacked the 1-body offsets, which the ``.uf3`` file does not
carry (they are added, so that both backends give the same energy).
A structure that is not periodic along all three axes is refused by
the ``lammps`` backend, which always writes ``boundary p p p``.
"""

import importlib.util
import os
import tempfile
from datetime import datetime
from typing import Dict, List, Tuple

import numpy as np

from uf3_tpu_torch import io
from uf3_tpu_torch.data import elements
from uf3_tpu_torch.data.atoms import Atoms
from uf3_tpu_torch.representation import splines as sp


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
                      masses: bool = True) -> np.ndarray:
    """Minimal LAMMPS data-file writer (atomic style, triclinic-safe).

    A cell that is lower-triangular with no negative diagonal, LAMMPS's
    own form (a, 0, 0), (b_x, b_y, 0), (c_x, c_y, c_z), is written as it
    is.  Any other cell is rotated (or reflected) into that form with
    positive box lengths: rows map as ``x_lammps = x @ rotation``.
    Returns ``rotation`` (the identity where none was needed)."""
    cell = geom.get_cell()
    rotation = np.eye(3)
    positions = geom.get_positions()
    if not np.allclose(cell, np.tril(cell)) or np.any(np.diag(cell) < 0):
        q, r = np.linalg.qr(cell.T)
        # cell @ q is r.T; LAPACK's r may have a negative diagonal
        signs = np.where(np.diag(r) < 0, -1.0, 1.0)
        rotation = q * signs
        cell = cell @ rotation
        positions = positions @ rotation
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
    return rotation


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


# 1 bar (LAMMPS metal pressure unit) in eV/A^3
_BAR_TO_EV_A3 = 1e5 / 1.602176634e11


def _voigt_matrix(v) -> np.ndarray:
    """The symmetric 3x3 tensor of Voigt xx, yy, zz, yz, xz, xy."""
    xx, yy, zz, yz, xz, xy = v
    return np.array([[xx, xy, xz], [xy, yy, yz], [xz, yz, zz]])


class UFLammps:
    """
    LAMMPS-style calculator (reference UFLammps,
    uf3/forcefield/lammps.py:27-133, an ase.lammpslib subclass that
    drives a linked LAMMPS for evaluation, box/relax minimization,
    elastic constants, and phonons).

    Two interchangeable backends with the same result surface:

    ``backend="lammps"``
        Drives the in-process ``lammps`` Python library (imported at the
        first run; ``ImportError`` there where it is missing) with the
        exported native ``pair_style uf3`` potential file: the
        reference's command sequence, its units and signs, with results
        in the caller's frame and the model's 1-body energy added.
        ``keep_alive`` keeps one LAMMPS instance across calls (``clear``
        between them); otherwise each run closes it.  ``lammps_args``
        are its command-line arguments.
    ``backend="native"``
        The same operations through the port's own engine
        (``UFCalculator`` on ``device``, the CUDA card unless "cpu",
        with FIRE and box relaxation).
    ``backend="auto"``
        ``lammps`` where a ``lammps`` module is installed, else
        ``native``.

    Elastic constants and phonons take the native calculator on both
    backends, as the reference's do.  Results dict after
    ``evaluate``/``relax``: ``energy``, ``free_energy`` (eV),
    ``forces`` (eV/A), ``stress`` (Voigt xx,yy,zz,yz,xz,xy in eV/A^3,
    ASE sign convention: -pressure), ``volume`` (A^3), and ``nsteps``
    after ``relax`` (and after any ``lammps`` run: its ``step``).
    """

    def __init__(self, model, backend: str = "auto",
                 pot_dir: str = None, keep_alive: bool = True,
                 lammps_args: Tuple[str, ...] = ("-log", "none",
                                                 "-screen", "none"),
                 device=None):
        self.model = model
        self.keep_alive = keep_alive
        self.lammps_args = list(lammps_args)
        self.device = device
        self.results: Dict = {}
        self._lmp = None
        self._calc = None
        if backend == "auto":
            backend = "lammps" if importlib.util.find_spec("lammps") \
                else "native"
        if backend not in ("lammps", "native"):
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        self.pot_dir = pot_dir
        self.pot_path = None
        if backend == "lammps":
            self._ensure_pot_files()

    def _ensure_pot_files(self) -> str:
        """Export the native potential file on first use (needed by the
        lammps backend always, and by ``setup_commands`` on any
        backend)."""
        if self.pot_path is None:
            if self.pot_dir is None:
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
        if self.backend == "lammps":
            return self._lammps_run(atoms, relax=False)
        return self._native_results(atoms)

    def relax(self, atoms, vmax: float = 0.001,
              max_steps: int = 125, etol: float = 0.0,
              ftol: float = 1e-3) -> Dict:
        """Isotropic box/relax minimization (reference RELAX_LINES,
        uf3/forcefield/lammps.py:22-24): positions and cell volume
        relax together; ``atoms`` is updated in place.  ``vmax`` and
        ``etol`` are the LAMMPS backend's and unused by the native one."""
        if self.backend == "lammps":
            return self._lammps_run(atoms, relax=True, vmax=vmax,
                                    max_steps=max_steps, etol=etol,
                                    ftol=ftol)
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

    def close(self):
        if self._lmp is not None:
            self._lmp.close()
            self._lmp = None

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

    # -- lammps backend --------------------------------------------------
    def _get_lammps(self):
        try:
            import lammps
        except ImportError as exc:
            raise ImportError(
                "backend='lammps' requires the in-process `lammps` "
                "Python module (pip install lammps, or a LAMMPS build "
                "with -DBUILD_SHARED_LIBS=on and PKG_PYTHON); use "
                "backend='native' for the built-in engine") from exc
        if self._lmp is None:
            self._lmp = lammps.lammps(cmdargs=self.lammps_args)
        return self._lmp

    def _release(self, lmp, ran: bool):
        """After a run: close the instance, or under ``keep_alive`` clear
        it, and close it if ``clear`` itself raises, so that the next call
        starts a fresh one.  That error reaches the caller only after a
        run that ``ran`` to its end: after a failed one, the run's own
        error does."""
        if not self.keep_alive:
            self.close()
            return
        try:
            lmp.command("clear")
        except Exception:
            self.close()
            if ran:
                raise

    def _one_body_energy(self, atoms) -> float:
        """The 1-body offsets of ``atoms``' species, which the ``.uf3``
        file does not carry."""
        solutions = io.arrange_coefficients(self.model.coefficients,
                                            self.model.bspline_config)
        return float(sum(solutions[el]
                         for el in atoms.get_chemical_symbols()))

    def _lammps_run(self, atoms, relax: bool, vmax: float = 0.001,
                    max_steps: int = 125, etol: float = 0.0,
                    ftol: float = 1e-3) -> Dict:
        pbc = tuple(bool(p) for p in atoms.get_pbc())
        if not all(pbc):
            raise ValueError(f"backend='lammps' writes boundary p p p; "
                             f"these atoms have pbc={pbc}: use "
                             "backend='native'")
        lmp = self._get_lammps()
        with tempfile.NamedTemporaryFile(
                mode="w", suffix=".data", delete=False) as handle:
            data_path = handle.name
        # whatever raises, the data file goes and the instance holds no
        # box (a kept instance that did would refuse the next read_data)
        ran = False
        try:
            # rows map as x_lammps = x @ q, and back as x = x_lammps @ q.T
            q = write_lammps_data(data_path, atoms, self.element_list)
            results = self._lammps_commands(lmp, data_path, atoms, q, relax,
                                            vmax, max_steps, etol, ftol)
            ran = True
        finally:
            os.unlink(data_path)
            self._release(lmp, ran)
        self.results = results
        return results

    def _lammps_commands(self, lmp, data_path: str, atoms, q, relax: bool,
                         vmax: float, max_steps: int, etol: float,
                         ftol: float) -> Dict:
        """Load ``data_path`` and the potential into ``lmp``, run or
        minimize, and read the results back into the caller's frame
        (``q``); a relax writes positions and cell back into ``atoms``."""
        for command in self.setup_commands(data_path):
            lmp.command(command)
        if relax:
            lmp.command(f"fix fix_relax all box/relax iso 0.0 "
                        f"vmax {vmax}")
            lmp.command("min_style cg")
            lmp.command(f"minimize {etol} {ftol} {max_steps} "
                        f"{max_steps}")
        else:
            lmp.command("run 0")
        n_atoms = lmp.get_natoms()
        forces = np.array(
            lmp.gather_atoms("f", 1, 3)).reshape(n_atoms, 3) @ q.T
        pressures = np.array([lmp.get_thermo(k) for k in
                              ("pxx", "pyy", "pzz", "pyz", "pxz",
                               "pxy")])
        sigma = q @ _voigt_matrix(-pressures * _BAR_TO_EV_A3) @ q.T
        stress = sigma[[0, 1, 2, 1, 0, 0], [0, 1, 2, 2, 2, 1]]
        energy = float(lmp.get_thermo("pe")) + self._one_body_energy(atoms)
        results = dict(energy=energy, free_energy=energy, forces=forces,
                       stress=stress, volume=float(lmp.get_thermo("vol")),
                       nsteps=int(lmp.get_thermo("step")))
        if relax:
            pos = np.array(
                lmp.gather_atoms("x", 1, 3)).reshape(n_atoms, 3)
            atoms.set_positions(pos @ q.T)
            cell = np.zeros((3, 3))
            boxlo, boxhi, xy, yz, xz, *_ = lmp.extract_box()
            cell[0, 0] = boxhi[0] - boxlo[0]
            cell[1, 1] = boxhi[1] - boxlo[1]
            cell[2, 2] = boxhi[2] - boxlo[2]
            cell[1, 0], cell[2, 0], cell[2, 1] = xy, xz, yz
            atoms.set_cell(cell @ q.T)
        return results
