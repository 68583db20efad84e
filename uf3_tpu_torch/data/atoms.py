"""
A minimal atomic configuration and cubic crystal builder: what the MD
engine, the calculator and its drivers read from a configuration
(numbers, positions, cell, pbc, volume, masses, symbols), supercells,
a seeded rattle, the edits relaxation and finite differences make
(positions, translation, scaled cell, wrap, per-atom arrays, deletion),
and the calculator protocol (``calc``, ``get_potential_energy``,
``get_forces``, ``get_stress``).

Trimmed copy of ``Atoms`` and ``bulk`` from ``uf3_tpu/data/atoms.py``:
the same conventions (cell rows are lattice vectors, cartesian =
fractional @ cell; ``info`` holds per-configuration scalars, ``arrays``
per-atom quantities) and, for the same seed, the same rattled
positions.  The constructor takes atomic numbers, not symbols
(``molecule_from_arrays`` takes symbols).  ``MDSystem`` takes any
object with these reader methods.
"""

from typing import Dict, Iterable, List, Optional, Sequence, Union

import numpy as np

from uf3_tpu_torch.data import elements as el


class Atoms:
    """Species, positions, cell and periodicity of a configuration."""

    def __init__(self, numbers: Sequence[int], positions: Sequence,
                 cell: Optional[Sequence] = None,
                 pbc: Union[bool, Sequence[bool]] = True,
                 info: Optional[Dict] = None,
                 arrays: Optional[Dict] = None):
        self.numbers = np.asarray(numbers, dtype=np.int64)
        n = len(self.numbers)
        self.positions = np.array(positions, dtype=np.float64).reshape(n, 3)
        cell = np.zeros((3, 3)) if cell is None \
            else np.asarray(cell, dtype=np.float64)
        if cell.shape == (3,):
            cell = np.diag(cell)
        self.cell = np.array(cell, dtype=np.float64).reshape(3, 3)
        if isinstance(pbc, (bool, np.bool_)):
            pbc = [pbc] * 3
        self.pbc = np.asarray(pbc, dtype=bool).reshape(3)
        self.info = dict(info) if info else {}
        self.arrays = {k: np.array(v) for k, v in arrays.items()} \
            if arrays else {}
        self.calc = None  # an attached calculator, if any

    def __len__(self) -> int:
        return len(self.numbers)

    def __repr__(self) -> str:
        return (f"Atoms({self.get_chemical_formula()}, "
                f"pbc={self.pbc.tolist()})")

    def __setstate__(self, state: Dict) -> None:
        """Unpickle (a process pool's worker receives its configurations
        so).  An unpickled array carries its own copy of its dtype, on
        which numpy 2.0's ``ufunc.at``, the host featurizer's scatter,
        takes a path ~20x slower: numeric arrays are viewed as their
        canonical dtype."""
        def canonical(value):
            if isinstance(value, np.ndarray) and value.dtype.kind in "biuf":
                return value.view(value.dtype.type)
            return value

        state = {k: canonical(v) for k, v in state.items()}
        state["arrays"] = {k: canonical(v)
                           for k, v in state.get("arrays", {}).items()}
        self.__dict__.update(state)

    def copy(self) -> "Atoms":
        new = Atoms(self.numbers.copy(), self.positions.copy(),
                    self.cell.copy(), self.pbc.copy(), info=dict(self.info))
        new.arrays = {k: v.copy() for k, v in self.arrays.items()}
        return new

    # -- accessors ----------------------------------------------------------
    def get_atomic_numbers(self) -> np.ndarray:
        return self.numbers.copy()

    def get_chemical_symbols(self) -> List[str]:
        return el.numbers_to_symbols(self.numbers)

    def get_chemical_formula(self) -> str:
        syms, counts = np.unique(self.get_chemical_symbols(),
                                 return_counts=True)
        return "".join(f"{s}{c if c > 1 else ''}" for s, c in
                       zip(syms, counts))

    def get_positions(self) -> np.ndarray:
        return self.positions.copy()

    def set_positions(self, positions: Sequence) -> None:
        self.positions = np.array(positions,
                                  dtype=np.float64).reshape(len(self), 3)

    def translate(self, displacement: Sequence) -> None:
        self.positions = self.positions + np.asarray(displacement)

    def get_cell(self) -> np.ndarray:
        return self.cell.copy()

    def set_cell(self, cell: Sequence, scale_atoms: bool = False) -> None:
        """A new cell; with ``scale_atoms`` the fractional coordinates
        are kept."""
        cell = np.asarray(cell, dtype=np.float64)
        if cell.shape == (3,):
            cell = np.diag(cell)
        if scale_atoms:
            frac = self.get_scaled_positions()
            self.cell = cell.reshape(3, 3)
            self.positions = frac @ self.cell
        else:
            self.cell = cell.reshape(3, 3)

    def get_pbc(self) -> np.ndarray:
        return self.pbc.copy()

    def get_volume(self) -> float:
        vol = np.linalg.det(self.cell)
        if vol == 0:
            raise ValueError("Cell has zero volume.")
        return abs(float(vol))

    def get_masses(self) -> np.ndarray:
        return el.atomic_masses[self.numbers]

    def get_scaled_positions(self, wrap: bool = False) -> np.ndarray:
        frac = np.linalg.solve(self.cell.T, self.positions.T).T
        if wrap:
            frac = frac % 1.0
        return frac

    def set_scaled_positions(self, frac: Sequence) -> None:
        self.positions = np.asarray(frac, dtype=np.float64) @ self.cell

    # -- calculator protocol ------------------------------------------------
    def get_potential_energy(self) -> float:
        if self.calc is None:
            raise RuntimeError("No calculator attached.")
        return self.calc.get_potential_energy(self)

    def get_forces(self) -> np.ndarray:
        if self.calc is None:
            raise RuntimeError("No calculator attached.")
        return self.calc.get_forces(self)

    def get_stress(self) -> np.ndarray:
        if self.calc is None:
            raise RuntimeError("No calculator attached.")
        return self.calc.get_stress(self)

    # -- mutation -----------------------------------------------------------
    def wrap(self) -> None:
        """Wrap atoms into the unit cell along periodic directions."""
        frac = self.get_scaled_positions()
        for dim in range(3):
            if self.pbc[dim]:
                frac[:, dim] = frac[:, dim] % 1.0
        self.set_scaled_positions(frac)

    def rattle(self, stdev: float = 0.001, seed: int = 42) -> None:
        """Add Gaussian noise of width ``stdev`` (A) to every position,
        drawn from ``numpy.random.RandomState(seed)``."""
        rng = np.random.RandomState(seed)
        self.positions = self.positions + rng.normal(
            scale=stdev, size=self.positions.shape)

    def repeat(self, reps: Union[int, Sequence[int]]) -> "Atoms":
        """Tile the configuration to build a supercell."""
        if isinstance(reps, (int, np.integer)):
            reps = (reps, reps, reps)
        na, nb, nc = (int(r) for r in reps)
        offsets = np.array([[i, j, k]
                            for i in range(na)
                            for j in range(nb)
                            for k in range(nc)], dtype=np.float64)
        shifts = offsets @ self.cell
        n_img = len(shifts)
        positions = (self.positions[None, :, :]
                     + shifts[:, None, :]).reshape(-1, 3)
        numbers = np.tile(self.numbers, n_img)
        new_cell = self.cell * np.array(reps, dtype=np.float64)[:, None]
        new = Atoms(numbers, positions, new_cell, self.pbc.copy(),
                    info=dict(self.info))
        for key, value in self.arrays.items():
            if value.ndim >= 1 and len(value) == len(self):
                new.arrays[key] = np.concatenate([value] * n_img, axis=0)
        return new

    def __mul__(self, reps):
        return self.repeat(reps)

    def new_array(self, name: str, values: Sequence) -> None:
        values = np.asarray(values)
        if name in self.arrays:
            raise RuntimeError(f"Array '{name}' already exists.")
        if len(values) != len(self):
            raise ValueError("Array length does not match number of atoms.")
        self.arrays[name] = values

    def set_array(self, name: str, values: Sequence) -> None:
        self.arrays[name] = np.asarray(values)

    def delete(self, indices: Iterable[int]) -> None:
        """Remove atoms by index (in place)."""
        mask = np.ones(len(self), dtype=bool)
        mask[np.asarray(list(indices), dtype=int)] = False
        self.numbers = self.numbers[mask]
        self.positions = self.positions[mask]
        self.arrays = {k: v[mask] for k, v in self.arrays.items()}


_CUBIC_BASES = {
    "sc": [[0.0, 0.0, 0.0]],
    "bcc": [[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]],
    "fcc": [[0.0, 0.0, 0.0], [0.5, 0.5, 0.0], [0.5, 0.0, 0.5],
            [0.0, 0.5, 0.5]],
}
_CUBIC_BASES["diamond"] = _CUBIC_BASES["fcc"] + [
    [x + 0.25 for x in p] for p in _CUBIC_BASES["fcc"]]


def bulk(symbol: str, crystalstructure: str = "bcc",
         a: float = 3.16) -> Atoms:
    """The conventional cubic cell of an sc, bcc, fcc or diamond
    crystal of lattice constant ``a`` (A), periodic."""
    if crystalstructure not in _CUBIC_BASES:
        raise ValueError(f"Unknown structure: {crystalstructure} (the port "
                         f"builds {sorted(_CUBIC_BASES)})")
    cell = np.eye(3) * a
    frac = np.array(_CUBIC_BASES[crystalstructure])
    return Atoms([el.atomic_numbers[symbol]] * len(frac), frac @ cell, cell)


def molecule_from_arrays(symbols, positions) -> Atoms:
    """Non-periodic configuration from symbol and position arrays."""
    return Atoms(el.symbols_to_numbers(list(symbols)), positions, pbc=False)
