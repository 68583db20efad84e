"""
Fixed-capacity padded neighbor lists in torch: (N, K) neighbor indices
plus integer image shifts, a mask, the reverse-slot map the 3-body
force assembly gathers through, and the parent-slot map of a filtered
list.

Counterpart of ``uf3_tpu/ops/neighbors.py`` (O(N^2) minimum-image and
explicit-image builders, cell-list builder, filter, reverse slots --
the builders' ``with_rev`` as ``with_reverse_slots`` --, top-2
staleness trigger).  The JAX cell-list builder packs candidate
keys into 31-bit integers for the TPU; here candidates are compacted
with a cumulative sum and one scatter in int64, which keeps the same
neighbor set per row and the same overflow flag.
"""

from typing import NamedTuple, Tuple

import numpy as np
import torch


class NeighborList(NamedTuple):
    idx: torch.Tensor        # (N, K) int64 neighbor indices (self-padded)
    shift: torch.Tensor      # (N, K, 3) image shifts (float, integer-valued)
    mask: torch.Tensor       # (N, K) bool
    rev: torch.Tensor        # (N, K) int64: slot of atom i in neighbor's list
    overflow: torch.Tensor   # () bool: capacity exceeded
    reference_positions: torch.Tensor  # (N, 3) positions at build time
    sel: torch.Tensor = None  # (N, K) int64 parent-list slot ids of a list
    #   derived by filter_neighbor_list


def cell_transform(vecs, cell):
    """``vecs @ cell`` as three elementwise mul-adds: full working
    precision whatever the backend's matmul precision setting."""
    return (vecs[..., 0:1] * cell[0] + vecs[..., 1:2] * cell[1]
            + vecs[..., 2:3] * cell[2])


def displacements(positions, cell, idx, shift):
    """d[i, k] = R_idx[i,k] + shift[i,k] @ cell - R_i."""
    return (positions[idx] + cell_transform(shift, cell)
            - positions[:, None, :])


class ListCache(NamedTuple):
    """Per-cycle invariants of one list for the force modules."""
    sd: torch.Tensor        # (N, K, 3) shift @ cell
    valid: torch.Tensor     # (N, K) float mask
    rev_flat: torch.Tensor  # (N, K) idx * K + rev (3-body assembly)
    s_slot: torch.Tensor = None  # (N, K) int64 species of each slot
    ptype: torch.Tensor = None   # (N, K) int64 pair type of each slot


def list_cache(nbr: NeighborList, cell, dtype, species=None,
               pair_type=None) -> ListCache:
    """The list's per-cycle invariants; with ``species`` (N,) also the
    slots' species, and with the (S, S) ``pair_type`` table their pair
    types (the multi-species route's columns, as the reference's
    ``build_pair_cache``)."""
    cache = ListCache(sd=cell_transform(nbr.shift.to(dtype), cell),
                      valid=nbr.mask.to(dtype),
                      rev_flat=nbr.idx * nbr.idx.shape[1] + nbr.rev)
    if species is None:
        return cache
    s_slot = species[nbr.idx]
    ptype = None if pair_type is None \
        else pair_type[species[:, None], s_slot]
    return cache._replace(s_slot=s_slot, ptype=ptype)


def cached_displacements(positions, nbr: NeighborList, cache: ListCache):
    """``displacements`` with the per-cycle shift product."""
    return positions[nbr.idx] + cache.sd - positions[:, None, :]


def _reverse_slots(idx, shift, mask):
    """rev[a, s] = slot s' with idx[c, s'] == a and the opposite image
    shift, where c = idx[a, s]; invalid slots map to 0."""
    n_atoms = idx.shape[0]
    cand_idx = idx[idx]                      # (N, K, K)
    cand_shift = shift[idx]                  # (N, K, K, 3)
    a = torch.arange(n_atoms, device=idx.device)[:, None, None]
    match = (cand_idx == a) & torch.all(
        cand_shift == -shift[:, :, None, :], dim=-1)
    rev = torch.argmax(match.to(torch.uint8), dim=-1)
    return torch.where(mask, rev, torch.zeros_like(rev))


def with_reverse_slots(nbr: NeighborList) -> NeighborList:
    """The list with its reverse-slot map filled in (the builders leave
    it zero; a 3-body list that is assembled across atoms needs it)."""
    return nbr._replace(rev=_reverse_slots(nbr.idx, nbr.shift, nbr.mask))


def _self_pad(idx, shift, mask):
    self_idx = torch.arange(idx.shape[0], device=idx.device)[:, None]
    idx = torch.where(mask, idx, self_idx)
    shift = torch.where(mask[:, :, None], shift, torch.zeros_like(shift))
    return idx, shift


def _compact(within, capacity: int):
    """Order-preserving pack of the True lanes of each row of
    ``within`` (R, C) into ``capacity`` slots: returns (rows, lanes,
    slots) of the kept lanes (lanes past the capacity are dropped) and
    the per-row counts."""
    count = within.sum(dim=-1)
    slot = torch.cumsum(within.to(torch.int64), dim=-1) - 1
    keep = within & (slot < capacity)
    rows, lanes = torch.nonzero(keep, as_tuple=True)
    return rows, lanes, slot[rows, lanes], count


BLOCK_ROWS = 512  # rows per distance plane of the O(N^2) builders


def _nearest_first(plane, n_rows: int, r_cut: float, capacity: int):
    """Per-row top-k over candidate planes, ``BLOCK_ROWS`` rows at a
    time so that memory stays bounded: ``plane(start, stop)`` gives the
    squared distances (B, C) of rows start..stop-1 to the C candidates.
    Keeps the nearest ``capacity`` candidates within ``r_cut`` (an
    overflow drops the farthest).  Returns (candidate ids (N, K), mask
    (N, K), overflow)."""
    cand, mask, count = [], [], []
    for start in range(0, n_rows, BLOCK_ROWS):
        d2 = plane(start, min(start + BLOCK_ROWS, n_rows))
        within = (d2 < r_cut * r_cut) & (d2 > 1e-12)
        count.append(within.sum(dim=1))
        key = torch.where(within, -d2, torch.full_like(d2, -torch.inf))
        neg, ids = torch.topk(key, capacity, dim=1)
        cand.append(ids)
        mask.append(neg > -torch.inf)
    return (torch.cat(cand), torch.cat(mask),
            torch.any(torch.cat(count) > capacity))


def build_neighbor_list(positions, cell, pbc, r_cut: float,
                        capacity: int) -> NeighborList:
    """O(N^2) minimum-image neighbor search with nearest-first top-k
    per row, in blocks of ``BLOCK_ROWS`` rows.  Valid where every
    periodic width is at least 2 ``r_cut`` (``images_required`` is 0);
    a non-periodic direction takes no image.  ``rev`` is left zero, as
    in ``build_neighbor_list_cells``."""
    n_atoms = positions.shape[0]
    capacity = min(capacity, n_atoms)
    pbc_vec = torch.tensor(pbc, dtype=positions.dtype,
                           device=positions.device)
    frac = cell_transform(positions, torch.linalg.inv(cell))

    def plane(start, stop):
        # per-component (B, N) arithmetic: no (B, N, 3) image planes
        block = frac[start:stop]
        mic = []
        for c in range(3):
            dc = frac[None, :, c] - block[:, None, c]
            mic.append(dc - torch.round(dc) * pbc_vec[c])
        d2 = torch.zeros_like(mic[0])
        for k in range(3):
            dk = mic[0] * cell[0, k] + mic[1] * cell[1, k] \
                + mic[2] * cell[2, k]
            d2 = d2 + dk * dk
        return d2

    idx, mask, overflow = _nearest_first(plane, n_atoms, r_cut, capacity)
    # the image shift of the selected pairs only, by the same rounding
    shift = -torch.round(frac[idx] - frac[:, None, :]) * pbc_vec
    idx, shift = _self_pad(idx, shift, mask)
    return NeighborList(idx=idx, shift=shift, mask=mask,
                        rev=torch.zeros_like(idx), overflow=overflow,
                        reference_positions=positions)


def build_neighbor_list_images(positions, cell, pbc, r_cut: float,
                               capacity: int,
                               images=(1, 1, 1)) -> NeighborList:
    """O(N^2 M) neighbor search over an explicit range of periodic
    images: exact for small periodic cells where the cutoff passes half
    the cell width, self-image pairs included.  ``images[i]`` copies
    are scanned on each side along a periodic axis i; candidate
    c = j M + m is atom j shifted by image m.  Nearest-first top-k per
    row, in blocks of ``BLOCK_ROWS`` rows; ``rev`` is left zero."""
    n_atoms = positions.shape[0]
    ni = [int(images[i]) if pbc[i] else 0 for i in range(3)]
    grid = np.stack(np.meshgrid(
        np.arange(-ni[0], ni[0] + 1), np.arange(-ni[1], ni[1] + 1),
        np.arange(-ni[2], ni[2] + 1), indexing="ij"), axis=-1).reshape(-1, 3)
    shifts = torch.as_tensor(grid, dtype=positions.dtype,
                             device=positions.device)       # (M, 3)
    n_images = shifts.shape[0]
    capacity = min(capacity, n_atoms * n_images)
    pos_ext = (positions[:, None, :]
               + cell_transform(shifts, cell)[None, :, :]).reshape(-1, 3)

    def plane(start, stop):
        block = positions[start:stop]
        d2 = torch.zeros((stop - start, pos_ext.shape[0]),
                         dtype=positions.dtype, device=positions.device)
        for c in range(3):
            d2 = d2 + (pos_ext[None, :, c] - block[:, None, c]) ** 2
        return d2

    cand, mask, overflow = _nearest_first(plane, n_atoms, r_cut, capacity)
    idx = torch.div(cand, n_images, rounding_mode="floor")
    shift = shifts[cand % n_images]
    idx, shift = _self_pad(idx, shift, mask)
    return NeighborList(idx=idx, shift=shift, mask=mask,
                        rev=torch.zeros_like(idx), overflow=overflow,
                        reference_positions=positions)


def images_required(cell, pbc, r_cut: float) -> Tuple[int, int, int]:
    """Periodic image copies per axis for an exact search at ``r_cut``:
    0 where the minimum-image convention holds (perpendicular width at
    least 2 ``r_cut``) or the axis is not periodic."""
    cell = np.asarray(cell, dtype=np.float64)
    volume = abs(np.linalg.det(cell))
    out = []
    for i in range(3):
        if not pbc[i]:
            out.append(0)
            continue
        area = np.linalg.norm(np.cross(cell[(i + 1) % 3], cell[(i + 2) % 3]))
        width = volume / area
        out.append(0 if width >= 2.0 * r_cut
                   else int(np.ceil(r_cut / width)))
    return tuple(out)


def filter_neighbor_list(nbr: NeighborList, positions, cell,
                         r_cut: float, capacity: int,
                         reference_positions=None) -> NeighborList:
    """Derive a smaller-cutoff list from an existing one (the 3-body
    list is a subset of the 2-body list), keeping parent order and the
    parent slot of every kept entry in ``sel``.

    ``reference_positions`` overrides the staleness reference of the
    derived list (the current positions when re-filtering mid-run)."""
    n_atoms = nbr.idx.shape[0]
    d = displacements(positions, cell, nbr.idx, nbr.shift)
    d2 = torch.sum(d * d, dim=-1)
    within = nbr.mask & (d2 < r_cut * r_cut)
    rows, lanes, slots, count = _compact(within, capacity)
    overflow = nbr.overflow | torch.any(count > capacity)
    sel = torch.zeros((n_atoms, capacity), dtype=torch.int64,
                      device=positions.device)
    sel[rows, slots] = lanes
    mask = (torch.arange(capacity, device=positions.device)[None, :]
            < count[:, None])
    idx = torch.gather(nbr.idx, 1, sel)
    shift = torch.gather(nbr.shift, 1, sel[:, :, None].expand(-1, -1, 3))
    idx, shift = _self_pad(idx, shift, mask)
    if reference_positions is None:
        reference_positions = nbr.reference_positions
    return NeighborList(idx=idx, shift=shift, mask=mask,
                        rev=_reverse_slots(idx, shift, mask),
                        overflow=overflow,
                        reference_positions=reference_positions,
                        sel=sel)


def bin_topology(grid_shape, pbc):
    """Static 27-neighbor bin map: for every bin, the linear ids of its
    (up to) 27 neighbor bins and the integer image shift each crossing
    applies.  Bins repeat with different shifts when a direction has
    fewer than 3 bins.

    Returns (nbr_bins (B, 27) int64, nbr_shifts (B, 27, 3) float,
    valid (B, 27) bool) as numpy arrays."""
    nx, ny, nz = grid_shape
    n_bins = nx * ny * nz
    coords = np.stack(np.meshgrid(np.arange(nx), np.arange(ny),
                                  np.arange(nz), indexing="ij"),
                      axis=-1).reshape(-1, 3)
    offsets = np.stack(np.meshgrid([-1, 0, 1], [-1, 0, 1], [-1, 0, 1],
                                   indexing="ij"), axis=-1).reshape(-1, 3)
    nbr_bins = np.zeros((n_bins, 27), dtype=np.int64)
    nbr_shifts = np.zeros((n_bins, 27, 3))
    valid = np.ones((n_bins, 27), dtype=bool)
    dims = np.array([nx, ny, nz])
    pbc_arr = np.asarray(pbc, dtype=bool)
    for o_idx, offset in enumerate(offsets):
        target = coords + offset
        shift = np.zeros_like(target, dtype=float)
        for d in range(3):
            below = target[:, d] < 0
            above = target[:, d] >= dims[d]
            if pbc_arr[d]:
                shift[below, d] = -1
                shift[above, d] = 1
                target[:, d] = target[:, d] % dims[d]
            else:
                valid[below | above, o_idx] = False
                target[:, d] = np.clip(target[:, d], 0, dims[d] - 1)
        nbr_bins[:, o_idx] = (target[:, 0] * ny + target[:, 1]) * nz \
            + target[:, 2]
        nbr_shifts[:, o_idx] = shift
    return nbr_bins, nbr_shifts, valid


def grid_shape_for(cell: np.ndarray, r_cut: float,
                   pbc) -> Tuple[int, int, int]:
    """Bins per direction: floor(perpendicular width / r_cut), >= 1."""
    cell = np.asarray(cell, dtype=np.float64)
    a, b, c = cell
    normals = [np.cross(b, c), np.cross(a, c), np.cross(a, b)]
    shape = []
    for v, n in zip((a, b, c), normals):
        width = abs(np.dot(v, n)) / max(np.linalg.norm(n), 1e-300)
        shape.append(max(1, int(np.floor(width / r_cut))))
    return tuple(shape)


def build_neighbor_list_cells(positions, cell, pbc, r_cut: float,
                              capacity: int,
                              grid_shape: Tuple[int, int, int],
                              bin_capacity: int,
                              topology) -> NeighborList:
    """O(N) cell-list neighbor search with static bin geometry: atoms
    are sorted into bins of at most ``bin_capacity`` slots, and each
    atom's candidates are the atoms of its bin's 27 stencil bins
    (``topology`` from ``bin_topology``).  ``positions`` must lie in the primary cell along periodic
    directions (``wrap_positions``; the MD engine wraps at rebuilds).

    Neighbors are kept in stencil order; on a capacity overflow (row or
    bin, flagged in ``overflow``) the row is truncated, and atoms past
    a full bin get an empty row.  ``rev`` is left zero: only a 3-body
    list is assembled across atoms, and it carries reverse slots
    (``filter_neighbor_list``, or ``with_reverse_slots`` on a list built
    on its own)."""
    device = positions.device
    dtype = positions.dtype
    n_atoms = positions.shape[0]
    capacity = min(capacity, n_atoms)
    nx, ny, nz = grid_shape
    n_bins = nx * ny * nz
    cap_b = bin_capacity
    nbr_bins, nbr_shifts, nbr_valid = (torch.as_tensor(t, device=device)
                                       for t in topology)
    nbr_shifts = nbr_shifts.to(dtype)
    frac = cell_transform(positions, torch.linalg.inv(cell))
    dims = torch.tensor(grid_shape, device=device)
    # clamping absorbs the ~1-ulp boundary excursions of re-derived frac
    bin_coord = torch.minimum(
        torch.clamp((frac * dims.to(dtype)).to(torch.int64), min=0),
        dims - 1)
    bin_id = (bin_coord[:, 0] * ny + bin_coord[:, 1]) * nz \
        + bin_coord[:, 2]
    order = torch.argsort(bin_id, stable=True)
    counts = torch.bincount(bin_id, minlength=n_bins)
    starts = torch.cumsum(counts, 0) - counts
    overflow_bins = torch.any(counts > cap_b)
    # bin occupancy table: atom index per (bin, slot) plus a slot mask
    slot = torch.arange(cap_b, device=device)
    bin_atoms = order[torch.clamp(starts[:, None] + slot[None, :],
                                  max=n_atoms - 1)]          # (B, cap_b)
    bin_mask = slot[None, :] < counts[:, None]
    bin_pos = positions[bin_atoms]                           # (B, cap_b, 3)
    # candidates: the atoms of each bin's 27 stencil bins (+ shift)
    cand_atoms = bin_atoms[nbr_bins].reshape(n_bins, 27 * cap_b)
    cand_mask = (bin_mask[nbr_bins] & nbr_valid[:, :, None]).reshape(
        n_bins, 27 * cap_b)
    cand_pos = (bin_pos[nbr_bins]
                + cell_transform(nbr_shifts, cell)[:, :, None, :]
                ).reshape(n_bins, 27 * cap_b, 3)
    # per-component accumulation: no (B, cap_b, 27*cap_b, 3) tensor
    d2 = torch.zeros((n_bins, cap_b, 27 * cap_b), dtype=dtype,
                     device=device)
    for c in range(3):
        d2 += (cand_pos[:, None, :, c] - bin_pos[:, :, None, c]) ** 2
    within = (cand_mask[:, None, :] & bin_mask[:, :, None]
              & (d2 < r_cut * r_cut) & (d2 > 1e-12))
    within = within.reshape(n_bins * cap_b, 27 * cap_b)
    rows, lanes, slots, count_row = _compact(within, capacity)
    overflow = overflow_bins | torch.any(count_row > capacity)
    bins = torch.div(rows, cap_b, rounding_mode="floor")
    stencil = torch.div(lanes, cap_b, rounding_mode="floor")
    idx_sel = torch.zeros((n_bins * cap_b, capacity), dtype=torch.int64,
                          device=device)
    shift_sel = torch.zeros((n_bins * cap_b, capacity, 3), dtype=dtype,
                            device=device)
    mask_sel = torch.zeros((n_bins * cap_b, capacity), dtype=torch.bool,
                           device=device)
    idx_sel[rows, slots] = cand_atoms[bins, lanes]
    shift_sel[rows, slots] = nbr_shifts[bins, stencil]
    mask_sel[rows, slots] = True
    # back to atom order: atom a sits at slot rank(a) - starts[bin] of
    # its bin row; atoms past a full bin keep an empty row
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n_atoms, device=device)
    atom_slot = rank - starts[bin_id]
    in_bin = atom_slot < cap_b
    flat_row = bin_id * cap_b + torch.clamp(atom_slot, max=cap_b - 1)
    idx_out = idx_sel[flat_row]
    shift_out = shift_sel[flat_row]
    mask_out = mask_sel[flat_row] & in_bin[:, None]
    idx_out, shift_out = _self_pad(idx_out, shift_out, mask_out)
    return NeighborList(idx=idx_out, shift=shift_out, mask=mask_out,
                        rev=torch.zeros_like(idx_out), overflow=overflow,
                        reference_positions=positions)


def wrap_positions(positions, cell, pbc):
    """Translate atoms by integer multiples of the cell vectors into
    the primary cell along periodic directions (an exact lattice
    translation, so energies and forces are invariant)."""
    pbc_vec = torch.tensor(pbc, dtype=positions.dtype,
                           device=positions.device)
    frac = cell_transform(positions, torch.linalg.inv(cell))
    base = torch.floor(frac) * pbc_vec
    return positions - cell_transform(base, cell)


def needs_rebuild(nbr: NeighborList, positions, skin: float):
    """Device bool: the two largest per-atom drifts since the list was
    built sum past ``skin``, so a pair outside r_cut + skin at build
    time may have reached r_cut."""
    delta = positions - nbr.reference_positions
    d2 = torch.sum(delta * delta, dim=-1)
    top2 = torch.topk(d2, 2).values
    return torch.sqrt(top2[0]) + torch.sqrt(top2[1]) > skin


def estimate_capacity(n_atoms: int, volume: float, r_cut: float,
                      factor: float = 1.35, minimum: int = 8) -> int:
    """Padded capacity from mean density with a safety factor."""
    density = n_atoms / volume
    expected = density * 4.0 / 3.0 * np.pi * r_cut ** 3
    return max(minimum, int(np.ceil(expected * factor)))
