"""
Minimal crystal-symmetry toolkit (spglib-lite, dependency-free).

The reference package gets symmetry-reduced phonon displacements from
phonopy (reference: uf3/forcefield/properties/phonon.py:25-106, which
calls ``phonopy.generate_displacements``); this framework finds the
space-group operations itself so the frozen-phonon workflow needs no
external packages.

Representation: an operation is (W, w, perm) where ``W`` is the 3x3
integer rotation in fractional coordinates (cartesian rotation
``R = cell.T @ W @ inv(cell.T)`` for row-vector lattice ``cell``),
``w`` the fractional translation, and ``perm`` the atom permutation it
induces: atom ``i`` maps onto atom ``perm[i]``.

Copy of ``uf3_tpu/data/symmetry.py``.
"""

from typing import List, NamedTuple

import numpy as np


class SymmetryOp(NamedTuple):
    rotation: np.ndarray      # (3, 3) int, fractional-coordinate rotation
    translation: np.ndarray   # (3,) float, fractional translation
    permutation: np.ndarray   # (n_atoms,) int, i -> perm[i]
    cartesian: np.ndarray     # (3, 3) float, cartesian rotation matrix


def _lattice_rotations(cell: np.ndarray, tol: float = 1e-5) -> List[np.ndarray]:
    """All integer fractional matrices W with entries in {-1, 0, 1}
    that preserve the lattice metric G = cell @ cell.T (W G W^T == G).

    Entries beyond +/-1 cannot occur for a reduced (niggli-like) cell of
    any common crystal; primitive cells from ``bulk()`` qualify."""
    metric = cell @ cell.T
    rotations = []
    values = (-1, 0, 1)
    from itertools import product
    for flat in product(values, repeat=9):
        w_mat = np.array(flat, dtype=np.int64).reshape(3, 3)
        det = int(round(np.linalg.det(w_mat)))
        if det not in (-1, 1):
            continue
        if np.allclose(w_mat @ metric @ w_mat.T, metric, atol=tol):
            rotations.append(w_mat)
    return rotations


def _match_permutation(frac: np.ndarray,
                       mapped: np.ndarray,
                       numbers: np.ndarray,
                       tol: float) -> np.ndarray:
    """Permutation p with mapped[i] == frac[p[i]] (mod 1), species
    preserved; None if no bijection exists."""
    n = len(frac)
    perm = np.full(n, -1, dtype=np.int64)
    used = np.zeros(n, dtype=bool)
    for i in range(n):
        diff = frac - mapped[i]
        diff -= np.round(diff)
        dist = np.max(np.abs(diff), axis=1)
        candidates = np.where((dist < tol) & (numbers == numbers[i])
                              & ~used)[0]
        if len(candidates) == 0:
            return None
        perm[i] = candidates[0]
        used[candidates[0]] = True
    return perm


def find_symmetry_ops(atoms, tol: float = 1e-5) -> List[SymmetryOp]:
    """Space-group operations of a periodic configuration.

    Searches lattice point-group candidates, then for each rotation all
    inequivalent translations (differences to the orbit of atom 0).
    Complete for crystals whose fractional rotations have entries in
    {-1, 0, 1} -- all cells produced by ``bulk``.
    """
    cell = np.asarray(atoms.get_cell(), dtype=np.float64)
    frac = atoms.get_scaled_positions() % 1.0
    numbers = np.asarray(atoms.get_atomic_numbers())
    inv_cell_t = np.linalg.inv(cell.T)
    ops = []
    seen = set()
    ref = 0
    same_species = np.where(numbers == numbers[ref])[0]
    for w_mat in _lattice_rotations(cell, tol=tol):
        # row convention throughout: x' = x @ W, cartesian r' = r @ R_row
        # with R_row = cell^-1 W cell; `cartesian` stores the
        # column-acting rotation R = R_row^T
        rotated = frac @ w_mat
        for j in same_species:
            trans = frac[j] - rotated[ref]
            mapped = (rotated + trans) % 1.0
            perm = _match_permutation(frac, mapped, numbers, tol)
            if perm is None:
                continue
            key = (w_mat.tobytes(), perm.tobytes())
            if key in seen:
                continue
            seen.add(key)
            cart = cell.T @ w_mat.T @ inv_cell_t
            ops.append(SymmetryOp(rotation=w_mat,
                                  translation=trans - np.round(trans),
                                  permutation=perm,
                                  cartesian=cart))
    return ops


def site_symmetry(ops: List[SymmetryOp], index: int) -> List[SymmetryOp]:
    """Operations whose permutation fixes ``index``."""
    return [op for op in ops if op.permutation[index] == index]


def orbit_representatives(ops: List[SymmetryOp],
                          n_atoms: int):
    """(representatives, map_op) -- for each atom, an op whose
    permutation sends a representative onto it."""
    reps = []
    map_op = {}
    assigned = np.full(n_atoms, -1, dtype=np.int64)
    for i in range(n_atoms):
        if assigned[i] >= 0:
            continue
        reps.append(i)
        for op in ops:
            j = int(op.permutation[i])
            if assigned[j] < 0:
                assigned[j] = i
                map_op[j] = op
    return reps, map_op
