"""
Periodic-image (ghost-atom) supercell generation.

Instead of the minimum-image convention, enough periodic images are tiled
that every in-cell atom sees all neighbors within r_cut; ghost atoms get
indices >= n_atoms because the (0, 0, 0) image comes first.

Copy of ``uf3_tpu/data/geometry.py`` on this package's ``Atoms`` (whose
constructor takes the atomic numbers first).
"""

from typing import Tuple

import numpy as np

from uf3_tpu_torch.data.atoms import Atoms


def get_supercell_factors(cell: np.ndarray, r_cut: float = 10) -> np.ndarray:
    """
    Minimum replicas per lattice direction so in-cell atoms interact with
    all images within r_cut: ceil(r_cut / plane-to-plane distance).
    """
    cell = np.asarray(cell, dtype=np.float64)
    if np.all(cell == 0):
        return np.array([1, 1, 1])
    if np.any(np.linalg.norm(cell, axis=1) == 0):
        import warnings
        warnings.warn("Unit cell has 0-length lattice vector(s).")
        return np.array([1, 1, 1])
    a, b, c = cell
    normals = [np.cross(b, c), np.cross(a, c), np.cross(a, b)]
    factors = []
    for v, n in zip((a, b, c), normals):
        projected = n * np.dot(v, n) / np.dot(n, n)
        factors.append(r_cut / np.linalg.norm(projected))
    return np.ceil(factors)


def generate_periodic_image_indices(cell: np.ndarray, r_cut: float):
    """Per-direction image offsets ordered [0, 1, -1, 2, -2, ...]."""
    factors = get_supercell_factors(cell, r_cut)
    per_direction = []
    for n in factors:
        radius = np.arange(int(n) + 1)
        diameter = np.repeat(radius, 2)[1:]
        diameter = diameter.copy()
        diameter[::2] *= -1
        per_direction.append(diameter)
    return per_direction


def image_index_grid(a_indices, b_indices, c_indices,
                     cell=None, sort: bool = False):
    """
    All image-offset triples, flattened in the reference's meshgrid order
    (b outer, a middle, c inner) so image (0, 0, 0) comes first.
    """
    a_grid, b_grid, c_grid = np.meshgrid(a_indices, b_indices, c_indices,
                                         copy=False)
    a_grid, b_grid, c_grid = (g.flatten() for g in (a_grid, b_grid, c_grid))
    if sort:
        centroids = np.stack([a_grid, b_grid, c_grid], axis=1) @ cell
        order = np.argsort(np.linalg.norm(centroids, axis=1))
        a_grid, b_grid, c_grid = a_grid[order], b_grid[order], c_grid[order]
    return a_grid, b_grid, c_grid


def get_supercell(geometry: Atoms,
                  r_cut: float = 10,
                  sort_indices: bool = False) -> Atoms:
    """Ghost-atom supercell; in-cell atoms occupy indices [0, n_atoms)."""
    cell = geometry.get_cell()
    pbc = geometry.get_pbc()
    per_direction = generate_periodic_image_indices(cell, r_cut)
    for dim in range(3):
        if not pbc[dim]:
            per_direction[dim] = per_direction[dim][:1]
    a_grid, b_grid, c_grid = image_index_grid(*per_direction, cell=cell,
                                              sort=sort_indices)
    offsets = np.stack([a_grid, b_grid, c_grid], axis=1).astype(np.float64)
    shifts = offsets @ cell  # (n_images, 3)
    positions = geometry.get_positions()
    sup_positions = (positions[None, :, :] + shifts[:, None, :]).reshape(-1, 3)
    sup_numbers = np.tile(geometry.get_atomic_numbers(), len(shifts))
    return Atoms(sup_numbers, sup_positions, pbc=False)


def mask_supercell_with_radius(geom: Atoms,
                               supercell: Atoms,
                               r_max: float) -> Atoms:
    """Drop supercell atoms farther than r_max from every in-cell atom."""
    geo_pos = geom.get_positions()
    sup_pos = supercell.get_positions()
    d2 = np.sum((geo_pos[:, None, :] - sup_pos[None, :, :]) ** 2, axis=-1)
    keep = np.any(d2 <= r_max * r_max, axis=0)
    return Atoms(supercell.get_atomic_numbers()[keep], sup_pos[keep],
                 pbc=False)


def get_distance_matrix(geom: Atoms, supercell: Atoms = None) -> np.ndarray:
    """Dense Euclidean distance matrix between geom and supercell atoms
    via the BLAS quadratic expansion |a|^2 + |b|^2 - 2 a.b (no (n, m, 3)
    intermediate)."""
    if supercell is None:
        supercell = geom
    geo_pos = geom.get_positions()
    sup_pos = supercell.get_positions()
    d2 = (np.sum(geo_pos * geo_pos, axis=1)[:, None]
          + np.sum(sup_pos * sup_pos, axis=1)[None, :]
          - 2.0 * (geo_pos @ sup_pos.T))
    return np.sqrt(np.maximum(d2, 0.0))


def generate_displacements_from_forces(geom: Atoms,
                                       energy: float,
                                       forces: np.ndarray,
                                       d: float = 0.01,
                                       n: int = None,
                                       random: bool = True
                                       ) -> Tuple[list, list]:
    """
    Data augmentation: small displacements with first-order energy updates
    dE = -F . dR (cf. reference geometry.py:152-186).
    """
    forces = np.asarray(forces)
    n_atoms = len(geom)
    positions = geom.get_positions()
    displacements = []
    if random:
        n = n or 25
        rng = np.random.RandomState(0)
        displacements = [d * (rng.rand(n_atoms, 3) * 2 - 1)
                         for _ in range(n)]
    else:
        for direction in range(3):
            signs = d * np.sign(forces[:, direction])
            for atom_idx in range(n_atoms):
                displacement = np.zeros_like(positions)
                displacement[atom_idx, direction] += signs[atom_idx]
                displacements.append(displacement)
    snapshots = []
    energies = []
    for displacement in displacements:
        snapshot = geom.copy()
        snapshot.translate(displacement)
        snapshots.append(snapshot)
        energies.append(energy - np.sum(forces * displacement))
    return snapshots, energies
