"""
A minimal atomic configuration and cubic crystal builder: what the MD
engine reads from a configuration (numbers, positions, cell, pbc,
volume), supercells, and a seeded rattle.

Trimmed copy of ``Atoms`` and ``bulk`` from ``uf3_tpu/data/atoms.py``:
the same conventions (cell rows are lattice vectors, cartesian =
fractional @ cell) and, for the same seed, the same rattled positions.
``MDSystem`` takes any object with these reader methods.
"""

from typing import Sequence, Union

import numpy as np

from uf3_tpu_torch.data import elements as el


class Atoms:
    """Species, positions, cell and periodicity of a configuration."""

    def __init__(self, numbers: Sequence[int], positions: Sequence,
                 cell: Sequence, pbc: Union[bool, Sequence[bool]] = True):
        self.numbers = np.asarray(numbers, dtype=np.int64)
        n = len(self.numbers)
        self.positions = np.array(positions, dtype=np.float64).reshape(n, 3)
        self.cell = np.array(cell, dtype=np.float64).reshape(3, 3)
        if isinstance(pbc, (bool, np.bool_)):
            pbc = [pbc] * 3
        self.pbc = np.asarray(pbc, dtype=bool).reshape(3)

    def __len__(self) -> int:
        return len(self.numbers)

    def get_atomic_numbers(self) -> np.ndarray:
        return self.numbers.copy()

    def get_positions(self) -> np.ndarray:
        return self.positions.copy()

    def get_cell(self) -> np.ndarray:
        return self.cell.copy()

    def get_pbc(self) -> np.ndarray:
        return self.pbc.copy()

    def get_volume(self) -> float:
        vol = np.linalg.det(self.cell)
        if vol == 0:
            raise ValueError("Cell has zero volume.")
        return abs(float(vol))

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
        positions = (self.positions[None, :, :]
                     + shifts[:, None, :]).reshape(-1, 3)
        numbers = np.tile(self.numbers, len(shifts))
        new_cell = self.cell * np.array(reps, dtype=np.float64)[:, None]
        return Atoms(numbers, positions, new_cell, self.pbc.copy())

    def __mul__(self, reps):
        return self.repeat(reps)


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
