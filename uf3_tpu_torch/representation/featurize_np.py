"""
Host-side (numpy, float64) featurization engine: per-configuration 2-body
and 3-body energy/force feature vectors.

Copy of ``uf3_tpu/representation/featurize_np.py``, the host oracle the
device featurizer (``uf3_tpu_torch/ops/featurize.py``) is held to: the
reference pipeline's semantics with vectorized scatter-adds.  The host
featurizer (``representation/process.py``) runs it for the bases the
device paths do not take (knots with no closed form).
"""

from typing import Dict, List, Tuple

import numpy as np

from uf3_tpu_torch.data import composition, elements
from uf3_tpu_torch.data import geometry as geo
from uf3_tpu_torch.data.atoms import Atoms
from uf3_tpu_torch.representation import splines as sp


# ---------------------------------------------------------------------------
# 2-body
# ---------------------------------------------------------------------------
def _species_pair_mask(pair_numbers, row_z, col_z) -> np.ndarray:
    za, zb = pair_numbers
    return (((row_z[:, None] == za) & (col_z[None, :] == zb))
            | ((row_z[:, None] == zb) & (col_z[None, :] == za)))


def distances_by_interaction(geom: Atoms,
                             pair_tuples: List[Tuple[str, str]],
                             r_min_map: Dict,
                             r_max_map: Dict,
                             supercell: Atoms = None) -> Dict:
    """
    Pair distances per interaction: rows are in-cell atoms, columns the
    supercell, bounds strict on both ends (each in-cell bond appears twice;
    cf. reference distances.py:19-75).
    """
    if supercell is None:
        supercell = geom
    matrix = geo.get_distance_matrix(geom, supercell)
    geo_z = geom.get_atomic_numbers()
    sup_z = supercell.get_atomic_numbers()
    out = {}
    for pair in pair_tuples:
        pair_numbers = elements.symbols_to_numbers(list(pair))
        r_min = max(r_min_map[pair], 0)
        r_max = r_max_map[pair]
        mask = (_species_pair_mask(pair_numbers, geo_z, sup_z)
                & (matrix > r_min) & (matrix < r_max))
        out[pair] = matrix[mask]
    return out


def derivatives_by_interaction(geom: Atoms,
                               pair_tuples: List[Tuple[str, str]],
                               r_cut: float,
                               r_min_map: Dict,
                               r_max_map: Dict,
                               supercell: Atoms = None) -> Tuple[Dict, Dict]:
    """
    Pair distances plus force-derivative data per interaction, over the
    radius-masked supercell square matrix; ghost-ghost pairs excluded
    (reference distances.py:78-143).  Derivative entries are
    (i_idx, j_idx, unit_vectors) with unit = (pos_j - pos_i) / r.
    """
    if supercell is None:
        supercell = geom
    n_atoms = len(geom)
    supercell = geo.mask_supercell_with_radius(geom, supercell, r_cut)
    sup_pos = supercell.get_positions()
    sup_z = supercell.get_atomic_numbers()
    matrix = geo.get_distance_matrix(supercell, supercell)
    n_sup = len(supercell)
    idx = np.arange(n_sup)
    real_mask = (idx[:, None] < n_atoms) | (idx[None, :] < n_atoms)
    dist_map = {}
    deriv_map = {}
    for pair in pair_tuples:
        pair_numbers = elements.symbols_to_numbers(list(pair))
        r_min = max(r_min_map[pair], 0)
        r_max = r_max_map[pair]
        mask = (_species_pair_mask(pair_numbers, sup_z, sup_z)
                & (matrix > r_min) & (matrix < r_max) & real_mask)
        i_where, j_where = np.nonzero(mask)
        r = matrix[i_where, j_where]
        unit = (sup_pos[j_where] - sup_pos[i_where]) / r[:, None]
        dist_map[pair] = r
        deriv_map[pair] = (i_where, j_where, unit)
    return dist_map, deriv_map


def energy_features_2b(distances: np.ndarray,
                       knot_sequence: np.ndarray,
                       n_lead: int,
                       n_trail: int) -> np.ndarray:
    return sp.evaluate_basis_sums(distances, knot_sequence,
                                  n_lead=n_lead, n_trail=n_trail)


def force_features_2b(r: np.ndarray,
                      i_idx: np.ndarray,
                      j_idx: np.ndarray,
                      unit: np.ndarray,
                      n_atoms: int,
                      knot_sequence: np.ndarray,
                      n_lead: int,
                      n_trail: int) -> np.ndarray:
    """
    x[a, c, s] = -sum_p B'_s(r_p) * [(a==j_p) - (a==i_p)] * unit[p, c],
    accumulated by scatter-add over the pair list (equivalent to the
    reference's dense kronecker formulation, distances.py:306-364).
    """
    n_splines = len(knot_sequence) - 4
    x = np.zeros((n_atoms, 3, n_splines))
    if len(r) == 0:
        return x
    values, idx = sp.deboor_values(r, knot_sequence, nu=1)
    tap_idx = idx[:, None] + np.arange(4)[None, :]  # (n_pairs, 4)
    keep = (tap_idx >= n_lead) & (tap_idx < n_splines - n_trail)
    values = np.where(keep, values, 0.0)
    # per-pair, per-tap, per-direction contribution
    contrib = values[:, :, None] * unit[:, None, :]  # (n_pairs, 4, 3)
    x_flat = x.transpose(0, 2, 1).reshape(n_atoms * n_splines, 3)
    j_real = j_idx < n_atoms
    i_real = i_idx < n_atoms
    flat_j = (j_idx[:, None] * n_splines + tap_idx)[j_real]
    flat_i = (i_idx[:, None] * n_splines + tap_idx)[i_real]
    np.add.at(x_flat, flat_j.ravel(),
              contrib[j_real].reshape(-1, 3))
    np.add.at(x_flat, flat_i.ravel(),
              -contrib[i_real].reshape(-1, 3))
    return -x_flat.reshape(n_atoms, n_splines, 3).transpose(0, 2, 1)


# ---------------------------------------------------------------------------
# 3-body
# ---------------------------------------------------------------------------
def identify_ij(geom: Atoms,
                knot_sets: List[List[np.ndarray]],
                supercell: Atoms = None,
                square: bool = False):
    """
    Pair list for triplet enumeration.  r_min is the global knot minimum;
    r_max the largest center-leg knot maximum; bounds (r_min, r_max]
    (reference angles.py:289-346).
    """
    if supercell is None:
        supercell = geom
    r_min = max(min(float(seq[0]) for set_ in knot_sets for seq in set_), 0)
    r_max = max(float(seq[-1]) for set_ in knot_sets for seq in set_[:2])
    matrix = geo.get_distance_matrix(supercell, supercell)
    n_geo = len(geom)
    if not square:
        cut = matrix[:n_geo, :]
        mask = (cut > r_min) & (cut <= r_max)
        i_where, j_where = np.nonzero(mask)
        return matrix, i_where, j_where
    mask = (matrix > r_min) & (matrix <= r_max)
    i_where, j_where = np.nonzero(mask)
    return supercell.get_positions(), matrix, i_where, j_where


def _triplets_for_center(i_value: int,
                         i_group: np.ndarray,
                         n_atoms: int) -> np.ndarray:
    """Unique neighbor pairs (j < k) of one center; ghost centers require
    at least one real neighbor j (reference angles.py:424-478)."""
    if i_value >= n_atoms:
        j_candidates = i_group[i_group < n_atoms]
        if j_candidates.size == 0:
            return np.zeros((0, 3), dtype=np.int64)
    else:
        j_candidates = i_group
    j_arr, k_arr = np.meshgrid(j_candidates, i_group)
    keep = j_arr < k_arr
    j_idx = j_arr[keep]
    k_idx = k_arr[keep]
    return np.stack([np.full(len(j_idx), i_value, dtype=np.int64),
                     j_idx, k_idx], axis=1)


def enumerate_triplets(geom: Atoms,
                       knot_sets: List[List[np.ndarray]],
                       hashes: np.ndarray,
                       supercell: Atoms,
                       square: bool):
    """
    All (center, j, k) triplets grouped by species hash, with leg
    distances (r_l = d_ij, r_m = d_ik, r_n = d_jk) masked to the
    per-interaction knot ranges (inclusive).  Neighbors are ordered by
    atomic number (ties keep index order).

    Returns:
        results: list per interaction of None or
            (r_l, r_m, r_n, tuples (n, 3) index array)
        aux: (positions or None, distance matrix)
    """
    n_atoms = len(geom)
    if supercell is None:
        supercell = geom
    # ghosts farther than 2 r_max from every in-cell atom can appear in
    # no valid triangle (center within r_max of a real atom, both legs
    # within r_max of the center); drop them before the square matrix
    if len(supercell) > n_atoms:
        r_max = max(float(seq[-1]) for set_ in knot_sets
                    for seq in set_[:2])
        supercell = geo.mask_supercell_with_radius(geom, supercell,
                                                   2.0 * r_max)
    sup_z = supercell.get_atomic_numbers()
    if square:
        coords, matrix, i_where, j_where = identify_ij(
            geom, knot_sets, supercell, square=True)
    else:
        matrix, i_where, j_where = identify_ij(geom, knot_sets, supercell)
        coords = None
    results = [None] * len(hashes)
    if len(i_where) == 0:
        return results, (coords, matrix)
    i_values, counts = np.unique(i_where, return_counts=True)
    groups = np.split(j_where, np.cumsum(counts)[:-1])
    all_tuples = [_triplets_for_center(i_val, grp, n_atoms)
                  for i_val, grp in zip(i_values, groups)]
    tuples = np.concatenate(all_tuples, axis=0) if all_tuples \
        else np.zeros((0, 3), dtype=np.int64)
    if len(tuples) == 0:
        return results, (coords, matrix)
    # order neighbors by atomic number (stable: ties keep j < k)
    zj = sup_z[tuples[:, 1]]
    zk = sup_z[tuples[:, 2]]
    swap = zj > zk
    tuples[swap, 1], tuples[swap, 2] = tuples[swap, 2], tuples[swap, 1]
    comp = np.stack([sup_z[tuples[:, 0]], sup_z[tuples[:, 1]],
                     sup_z[tuples[:, 2]]], axis=1)
    trip_hash = composition.get_szudzik_hash(comp)
    for hash_pos, hash_ in enumerate(hashes):
        sel = trip_hash == hash_
        if not np.any(sel):
            continue
        ituples = tuples[sel]
        r_l = matrix[ituples[:, 0], ituples[:, 1]]
        r_m = matrix[ituples[:, 0], ituples[:, 2]]
        r_n = matrix[ituples[:, 1], ituples[:, 2]]
        ks = knot_sets[hash_pos]
        keep = ((r_l >= ks[0][0]) & (r_l <= ks[0][-1])
                & (r_m >= ks[1][0]) & (r_m <= ks[1][-1])
                & (r_n >= ks[2][0]) & (r_n <= ks[2][-1]))
        if not np.any(keep):
            continue
        results[hash_pos] = (r_l[keep], r_m[keep], r_n[keep], ituples[keep])
    return results, (coords, matrix)


def _leg_basis(r, knot_sequence, n_lead, n_trail, nu=0):
    """4-tap basis values with trimmed-index zeroing."""
    n_splines = len(knot_sequence) - 4
    values, idx = sp.deboor_values(r, knot_sequence, nu=nu)
    tap_idx = idx[:, None] + np.arange(4)[None, :]
    keep = (tap_idx >= n_lead) & (tap_idx < n_splines - n_trail)
    return np.where(keep, values, 0.0), idx


def energy_grids_3b(geom: Atoms,
                    knot_sets: List[List[np.ndarray]],
                    hashes: np.ndarray,
                    supercell: Atoms = None,
                    n_lead: int = 0,
                    n_trail: int = 0) -> List[np.ndarray]:
    """Per-interaction L x M x N energy-feature grids (cf. angles.py:17-139).
    Each triangle scatters a 4x4x4 outer product of leg basis values."""
    if supercell is None:
        supercell = geom
    shapes = [(len(ks[0]) - 4, len(ks[1]) - 4, len(ks[2]) - 4)
              for ks in knot_sets]
    grids = [np.zeros(shape) for shape in shapes]
    results, _ = enumerate_triplets(geom, knot_sets, hashes, supercell,
                                    square=False)
    for pos, data in enumerate(results):
        if data is None:
            continue
        r_l, r_m, r_n, _ = data
        ks = knot_sets[pos]
        vl, il = _leg_basis(r_l, ks[0], n_lead, n_trail)
        vm, im = _leg_basis(r_m, ks[1], n_lead, n_trail)
        vn, iin = _leg_basis(r_n, ks[2], n_lead, n_trail)
        L, M, N = shapes[pos]
        outer = (vl[:, :, None, None] * vm[:, None, :, None]
                 * vn[:, None, None, :])  # (n, 4, 4, 4)
        taps = np.arange(4)
        flat = ((il[:, None, None, None] + taps[None, :, None, None]) * M * N
                + (im[:, None, None, None] + taps[None, None, :, None]) * N
                + (iin[:, None, None, None] + taps[None, None, None, :]))
        np.add.at(grids[pos].reshape(-1), flat.ravel(), outer.ravel())
    return grids


def force_grids_3b(geom: Atoms,
                   knot_sets: List[List[np.ndarray]],
                   hashes: np.ndarray,
                   supercell: Atoms = None,
                   n_lead: int = 0,
                   n_trail: int = 0) -> List[np.ndarray]:
    """
    Per-interaction force-feature grids of shape (n_atoms, 3, L, M, N):
    product-rule over the three legs dotted with direction cosines
    (cf. angles.py:142-286).  Sign convention matches the reference
    (returned grids already carry the leading minus).
    """
    if supercell is None:
        supercell = geom
    n_atoms = len(geom)
    shapes = [(len(ks[0]) - 4, len(ks[1]) - 4, len(ks[2]) - 4)
              for ks in knot_sets]
    force_grids = [np.zeros((n_atoms, 3) + shape) for shape in shapes]
    results, (coords, matrix) = enumerate_triplets(
        geom, knot_sets, hashes, supercell, square=True)
    taps = np.arange(4)
    for pos, data in enumerate(results):
        if data is None:
            continue
        r_l, r_m, r_n, ituples = data
        ks = knot_sets[pos]
        vl, il = _leg_basis(r_l, ks[0], n_lead, n_trail)
        vm, im = _leg_basis(r_m, ks[1], n_lead, n_trail)
        vn, iin = _leg_basis(r_n, ks[2], n_lead, n_trail)
        dl, _ = _leg_basis(r_l, ks[0], n_lead, n_trail, nu=1)
        dm, _ = _leg_basis(r_m, ks[1], n_lead, n_trail, nu=1)
        dn, _ = _leg_basis(r_n, ks[2], n_lead, n_trail, nu=1)
        L, M, N = shapes[pos]
        flat = ((il[:, None, None, None] + taps[None, :, None, None]) * M * N
                + (im[:, None, None, None] + taps[None, None, :, None]) * N
                + (iin[:, None, None, None] + taps[None, None, None, :]))
        flat = flat.reshape(len(r_l), 64)
        # product-rule tensors, (n, 64)
        t_ij = (dl[:, :, None, None] * vm[:, None, :, None]
                * vn[:, None, None, :]).reshape(len(r_l), 64)
        t_ik = (vl[:, :, None, None] * dm[:, None, :, None]
                * vn[:, None, None, :]).reshape(len(r_l), 64)
        t_jk = (vl[:, :, None, None] * vm[:, None, :, None]
                * dn[:, None, None, :]).reshape(len(r_l), 64)
        i_idx, j_idx, k_idx = ituples[:, 0], ituples[:, 1], ituples[:, 2]
        u_ij = (coords[j_idx] - coords[i_idx]) / r_l[:, None]
        u_ik = (coords[k_idx] - coords[i_idx]) / r_m[:, None]
        u_jk = (coords[k_idx] - coords[j_idx]) / r_n[:, None]
        lmn = L * M * N
        grid_flat = force_grids[pos].reshape(n_atoms * 3 * lmn)
        # atom i receives -t_ij*u_ij - t_ik*u_ik; j: +t_ij*u_ij - t_jk*u_jk;
        # k: +t_ik*u_ik + t_jk*u_jk; then overall minus sign.
        contributions = [
            (i_idx, -u_ij, t_ij), (i_idx, -u_ik, t_ik),
            (j_idx, u_ij, t_ij), (j_idx, -u_jk, t_jk),
            (k_idx, u_ik, t_ik), (k_idx, u_jk, t_jk),
        ]
        for atom_idx, u, tensor in contributions:
            real = atom_idx < n_atoms
            if not np.any(real):
                continue
            a = atom_idx[real]
            weighted = u[real][:, :, None] * tensor[real][:, None, :]
            for c in range(3):
                target = (a[:, None] * 3 + c) * lmn + flat[real]
                np.add.at(grid_flat, target.ravel(),
                          weighted[:, c, :].ravel())
    return [-g for g in force_grids]
