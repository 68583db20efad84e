"""
Device featurization: energy and force feature vectors for training,
computed on the CUDA card (by default) with the same scatter-free
algebra as the force modules, resolved per basis function.

For every center c and neighbor slot m, the partial tensors

    P0[c, m, g]      = sum_n  A[c, m] (x) B[c, n] (x) C[c, m, n]   [g]
    P1[c, m, g]      = sum_n dA[c, m] (x) B[c, n] (x) C[c, m, n]   [g]
    P3[c, m, g]      = sum_n  A[c, m] (x) B[c, n] (x) (dC/r)[c,m,n][g]
    PV[c, m, g, xyz] = sum_n  A (x) B (x) (dC/r) * d[c, n, xyz]    [g]

(g runs over the flattened L*M*NC coefficient grid) give

    energy grid      Phi[g]        = 1/2 sum_cm P0[c, m, g]
    force features   X[a, xyz, g]  = -( sum_m P1[a, m, g] u_am
                                      + sum_s gathered neighbor terms )

Counterpart of ``uf3_tpu/ops/featurize_jax.py``: ``FeaturizeSpec``,
``featurize_device``, ``build_featurize_spec``, the on-device 3-body
compression, ``featurize_configuration_device``, the dataset path
``featurize_dataset_device`` and the multi-species
``featurize_device_multi`` / ``featurize_configuration_device_multi``.
Plain torch: the reference computes these as XLA contractions, outside
any Pallas kernel.  Every three-operand contraction is written as two
pairwise ones.  ``Featurizer`` is the ``featurize`` command's handler:
it takes the unary device path where the basis allows it, the
multi-species device path for every other basis with closed-form knots
(multi-species, or 2-body only), and the host featurizer
(``representation/process.py``) for knots with no closed form.

Differences from the reference, by design:

- the functions take a leading batch axis: a dataset bucket of
  configurations of one shape is one call (the reference maps over the
  configurations), and the 3-body grids are folded onto the
  symmetry-unique wedge right after each outer product, before the
  neighbor gather, which is linear in the grid axis and so commutes
  with it: the gathered rows are (n_wedge,) wide instead of (L*M*NC,);
- the dataset path takes multi-species and 2-body-only bases too
  (species is a per-atom input, so configurations of one shape share a
  call whatever their species), where the reference featurizes them on
  the host (``featurize_jax.py:23``);
- each neighbor list is sized from its own cutoff (images and
  capacity), where the reference sizes both from the 2-body cutoff
  (``featurize_jax.py:463,535``) and drops 3-body neighbors without a
  flag when the 3-body legs reach further;
- the lists are built on the device by ``ops/neighbors.py``; a
  configuration whose estimated capacity overflows is built again at
  its measured neighbor count and featurized alone: no truncated row
  is kept;
- a configuration without forces gives its energy row and no force
  rows, as the reference's ``BasisFeaturizer.evaluate`` does.
"""

import functools
from typing import (Callable, Dict, Iterator, List, NamedTuple, Optional,
                    Tuple)

import numpy as np
import torch

from uf3_tpu_torch.data import elements
from uf3_tpu_torch.data import io as data_io
from uf3_tpu_torch.forcefield.md import _resolve_device
from uf3_tpu_torch.ops import neighbors as nb
from uf3_tpu_torch.ops.splines import LegSpec, _dense_basis, \
    leg_spec_from_knots
from uf3_tpu_torch.representation import process
from uf3_tpu_torch.representation.process import BasisFeaturizer, \
    FeatureTable, check_elements
from uf3_tpu_torch.util import hdf5

BUCKET_GRANULE = 8       # capacities rounded up to a multiple of this
MEMORY_BUDGET = 0.25     # share of the card's memory one batch may take
MAX_BATCH = 256          # configurations per batched call
CPU_BATCH = 8


class FeaturizeSpec(NamedTuple):
    """Static description for the single-pair/single-trio device path."""
    pair: LegSpec            # 2-body leg (full knot sequence)
    pair_lead: int
    pair_trail: int
    trio_l: LegSpec          # 3-body center legs (shared)
    trio_n: LegSpec          # 3-body third leg
    trio_lead: int
    trio_trail: int
    l_basis: int
    n_basis: int


class Lists(NamedTuple):
    """Stacked (B, N, K) neighbor lists of a batch of configurations."""
    idx: torch.Tensor        # (B, N, K) int64 index within the config
    shift: torch.Tensor      # (B, N, K, 3) image shifts
    mask: torch.Tensor       # (B, N, K) bool
    rev: torch.Tensor        # (B, N, K) int64 reverse slots


def _trimmed_basis(r, valid, spec: LegSpec, lead: int, trail: int):
    mat, dmat = _dense_basis(r, valid, spec)
    n_basis = spec.n_basis
    if lead > 0 or trail > 0:
        keep = torch.zeros(n_basis, dtype=torch.bool, device=r.device)
        keep[lead:n_basis - trail] = True
        mat = torch.where(keep, mat, 0.0)
        dmat = torch.where(keep, dmat, 0.0)
    return mat, dmat


def _batched(positions, cell, *lists):
    """Single-configuration arguments with a leading batch axis of 1
    (None passes through)."""
    if positions.dim() == 3:
        return (positions, cell) + tuple(lists)
    return ((positions[None], cell[None])
            + tuple(None if a is None else a[None] for a in lists))


def _displacements(positions, cell, idx, shift):
    """d[b, i, k] = R[b, idx] + shift @ cell[b] - R[b, i] for stacked
    configurations (B, N, 3), cells (B, 3, 3), lists (B, N, K)."""
    flat = positions.reshape(-1, 3)
    offset = (torch.arange(positions.shape[0], device=idx.device)
              * positions.shape[1])[:, None, None]
    cb = cell[:, None, None]
    sd = (shift[..., 0:1] * cb[..., 0, :] + shift[..., 1:2] * cb[..., 1, :]
          + shift[..., 2:3] * cb[..., 2, :])
    return flat[idx + offset] + sd - positions[:, :, None, :]


def _distance(d):
    rsq = torch.sum(d * d, dim=-1)
    return torch.sqrt(torch.where(rsq > 0, rsq, 1.0)), rsq


def _rev_rows(idx, rev):
    """Flat row of the reverse slot of each (b, i, k) among the stacked
    (B * N * K) slot rows."""
    n_cfg, n_atoms, k = idx.shape
    offset = (torch.arange(n_cfg, device=idx.device) * n_atoms)[:, None, None]
    return ((idx + offset) * k + rev).reshape(-1)


def _pair_features(spec: LegSpec, lead, trail, d2v, valid):
    """2-body energy (B, S) and force (B, N, 3, S) features."""
    r2, _ = _distance(d2v)
    valid2 = valid & (r2 > spec.t_min) & (r2 < spec.t_max)
    a2, da2 = _trimmed_basis(r2, valid2, spec, lead, trail)
    unit2 = d2v / r2[..., None]
    # x[a, xyz, s] = 2 sum_k B'_s(r_ak) u_ak  (both bond orientations)
    return (torch.sum(a2, dim=(1, 2)),
            2.0 * torch.einsum("znks,znkc->zncs", da2, unit2))


def _chain(a_m, da_m, a_n, c_mat, dc_over_r, d, fold):
    """Grid partials of one derivative chain, the n role contracted
    first: P0, P1, P3 (B, N, K, G) and PV (B, N, K, 3, G), each folded
    by ``fold`` along its grid axis (G = L*M*NC, or the wedge)."""
    # Q[c, m, b, w] = sum_n B[c, n, b] C[c, m, n, w], and its dC/r twins
    q0 = torch.einsum("zcnb,zcmnw->zcmbw", a_n, c_mat)
    q3 = torch.einsum("zcnb,zcmnw->zcmbw", a_n, dc_over_r)
    bd = a_n[..., :, None] * d[..., None, :]                   # zcnbx
    qv = torch.einsum("zcnbx,zcmnw->zcmxbw", bd, dc_over_r)

    def outer(a, q):
        # (z, c, m, [x,] a) x (z, c, m, [x,] b, w) -> (..., a*b*w)
        p = a[..., :, None, None] * q[..., None, :, :]
        return fold(p.reshape(p.shape[:-3] + (-1,)))

    p0 = outer(a_m, q0)
    p1 = outer(da_m, q0)
    p3 = outer(a_m, q3)
    pv = outer(a_m[:, :, :, None, :], qv)
    return p0, p1, p3, pv


def _neighbor_terms(p1, p3, pv, unit, d, mask_f, rev_rows):
    """sum_k over the partials of the atoms that list a, gathered
    through the reverse slots: (B, N, 3, G)."""
    shape = p1.shape
    g = shape[-1]
    p1_rows = p1.reshape(-1, g).index_select(0, rev_rows).reshape(shape)
    p3_rows = p3.reshape(-1, g).index_select(0, rev_rows).reshape(shape)
    pv_rows = pv.reshape(-1, 3 * g).index_select(0, rev_rows).reshape(
        pv.shape)
    m = mask_f[..., None]
    return (torch.einsum("zakg,zakx->zaxg", p1_rows * m, unit)
            + torch.einsum("zakg,zakx->zaxg", p3_rows * m, d)
            + torch.sum(pv_rows * m[..., None], dim=2))


def _identity(grid):
    return grid


def featurize_device(spec: FeaturizeSpec, positions, cell,
                     nbr_idx, nbr_shift, nbr_mask, nbr_rev,
                     nbr3_idx, nbr3_shift, nbr3_mask, nbr3_rev,
                     fold: Callable = None):
    """
    Energy + force features of one configuration (positions (N, 3),
    cell (3, 3), (N, K) lists), or of a stack of configurations of one
    shape (positions (B, N, 3), cells (B, 3, 3), (B, N, K) lists;
    every output then takes the leading B axis).  Unary system.

    Returns:
        e2: (n_pair_basis,) 2-body energy features
        f2: (N, 3, n_pair_basis) 2-body force features
        e3: (L, L, NC) 3-body energy grid (uncompressed)
        f3: (N, 3, L, L, NC) 3-body force grids (uncompressed,
            reference sign convention)

    With ``fold`` (a linear map on the last, flattened L*L*NC axis, as
    ``compressor`` makes), e3 and f3 come out folded: (G',) and
    (N, 3, G').
    """
    single = positions.dim() == 2
    (positions, cell, idx2, shift2, mask2, _, idx3, shift3, mask3,
     rev3) = _batched(positions, cell, nbr_idx, nbr_shift, nbr_mask,
                      nbr_rev, nbr3_idx, nbr3_shift, nbr3_mask, nbr3_rev)
    # ---- 2-body -----------------------------------------------------------
    e2, f2 = _pair_features(spec.pair, spec.pair_lead, spec.pair_trail,
                            _displacements(positions, cell, idx2, shift2),
                            mask2)
    # ---- 3-body -----------------------------------------------------------
    d = _displacements(positions, cell, idx3, shift3)
    r, _ = _distance(d)
    a_mat, da_mat = _trimmed_basis(r, mask3, spec.trio_l, spec.trio_lead,
                                   spec.trio_trail)
    d_mn = d[:, :, None, :, :] - d[:, :, :, None, :]
    r_mn, r_mn2 = _distance(d_mn)
    pair_ok = (mask3[:, :, :, None] & mask3[:, :, None, :]
               & (r_mn2 > 1e-10))
    c_mat, dc_mat = _trimmed_basis(r_mn, pair_ok, spec.trio_n,
                                   spec.trio_lead, spec.trio_trail)
    dc_over_r = dc_mat / r_mn[..., None]
    p0, p1, p3, pv = _chain(a_mat, da_mat, a_mat, c_mat, dc_over_r, d,
                            fold or _identity)
    # energy grid: ordered pairs double-count -> 1/2
    e3 = 0.5 * torch.sum(p0, dim=(1, 2))
    unit = d / r[..., None]
    # center term sum_m P1[a, m, g] u_am, then the neighbor term; the
    # minus of the reference's raw accumulation is carried by the
    # derivative identities
    f3 = (torch.einsum("zcmg,zcmx->zcxg", p1, unit)
          + _neighbor_terms(p1, p3, pv, unit, d, mask3.to(d.dtype),
                            _rev_rows(idx3, rev3)))
    if fold is None:
        grid = (spec.l_basis, spec.l_basis, spec.n_basis)
        e3 = e3.reshape(e3.shape[:1] + grid)
        f3 = f3.reshape(f3.shape[:3] + grid)
    if single:
        return e2[0], f2[0], e3[0], f3[0]
    return e2, f2, e3, f3


# ---------------------------------------------------------------------------
# host orchestration
# ---------------------------------------------------------------------------
def build_featurize_spec(bspline_config):
    """Static device-featurization spec; None when the model shape is
    outside the fast path (multi-species or non-closed-form knots)."""
    if bspline_config.degree != 3:
        return None
    if len(bspline_config.chemical_system.element_list) != 1:
        return None
    pair = bspline_config.interactions_map[2][0]
    trio = bspline_config.interactions_map[3][0]
    ok_p, spec_p = leg_spec_from_knots(
        bspline_config.knots_map[pair], exact=True)
    seqs = [np.asarray(s) for s in bspline_config.knots_map[trio]]
    if not np.array_equal(seqs[0], seqs[1]):
        return None
    ok_l, spec_l = leg_spec_from_knots(seqs[0], exact=True)
    ok_n, spec_n = leg_spec_from_knots(seqs[2], exact=True)
    if not (ok_p and ok_l and ok_n):
        return None
    return FeaturizeSpec(
        pair=spec_p,
        pair_lead=bspline_config.leading_trim[2],
        pair_trail=bspline_config.trailing_trim[2],
        trio_l=spec_l, trio_n=spec_n,
        trio_lead=bspline_config.leading_trim[3],
        trio_trail=bspline_config.trailing_trim[3],
        l_basis=len(seqs[0]) - 4,
        n_basis=len(seqs[2]) - 4)


def _compression_arrays(bspline_config, trio, dtype, device,
                        transposed: bool = False):
    """Static 3B compression data for the device path: (flat wedge
    indices into the L*M*NC grid, or with ``transposed`` into its
    (M, L, NC) transpose, per-wedge weights, symmetry)."""
    idx = np.asarray(bspline_config.template_mask[trio], dtype=np.int64)
    symmetry = int(bspline_config.symmetry[trio])
    if transposed and symmetry == 1:
        # the symmetrized grids of symmetry 2 and 3 are unchanged by
        # the transpose; symmetry 1 reads the wedge through it
        shape = tuple(len(s) - 4 for s in bspline_config.knots_map[trio])
        a, b, w = np.unravel_index(idx, shape)
        idx = np.ravel_multi_index((b, a, w),
                                   (shape[1], shape[0], shape[2]))
    weights = torch.as_tensor(np.asarray(bspline_config.flat_weights[trio]),
                              dtype=dtype, device=device)
    return torch.as_tensor(idx, device=device), weights, symmetry


def _compress_device(grid_flat, comp_idx, comp_w, symmetry, shape):
    """compress_3B on device: symmetrize + wedge selection + weights.
    grid_flat: (..., L * M * NC), ``shape`` = (L, M, NC)."""
    lead = grid_flat.shape[:-1]
    g = grid_flat.reshape(lead + tuple(shape))
    if symmetry == 2:
        g = g + torch.swapaxes(g, -3, -2)
    elif symmetry == 3:
        perms = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1),
                 (2, 1, 0))
        nd = g.dim()
        base = tuple(range(nd - 3))
        g = sum(g.permute(base + tuple(nd - 3 + p for p in perm))
                for perm in perms)
    flat = g.reshape(lead + (-1,))
    return torch.index_select(flat, -1, comp_idx) * comp_w


def compressor(bspline_config, trio, dtype, device,
               transposed: bool = False) -> Callable:
    """The fold of a trio's flattened grid axis onto its training wedge
    (``compress_3B`` with fitting weights), on the device; with
    ``transposed``, the same fold of the grid given as its (M, L, NC)
    transpose."""
    comp_idx, comp_w, symmetry = _compression_arrays(
        bspline_config, trio, dtype, device, transposed)
    shape = [len(s) - 4 for s in bspline_config.knots_map[trio]]
    if transposed:
        shape[0], shape[1] = shape[1], shape[0]
    return lambda grid: _compress_device(grid, comp_idx, comp_w, symmetry,
                                         tuple(shape))


def _bucket_capacity(count: int, granule: int = BUCKET_GRANULE) -> int:
    """Round a neighbor count up to a shape-bucket granule."""
    return max(granule, -(-int(count) // granule) * granule)


def _cell_of(geom, dtype, device):
    """The configuration's cell as a tensor; the identity for a cluster,
    whose lists take no image."""
    pbc = tuple(bool(p) for p in geom.get_pbc())
    cell = np.asarray(geom.get_cell(), dtype=np.float64) if any(pbc) \
        else np.eye(3)
    return torch.as_tensor(cell, dtype=dtype, device=device), pbc


def _images(cell: np.ndarray, pbc, r_cut: float):
    """Images per periodic axis for the images builder at ``r_cut`` (at
    least one: the positions are wrapped into the cell first)."""
    return tuple(max(1, r) if p else 0
                 for r, p in zip(nb.images_required(cell, pbc, r_cut), pbc))


def _build(positions, cell, pbc, r_cut: float, capacity: int, images,
           with_rev: bool) -> nb.NeighborList:
    """One configuration's list on the device: the images builder for a
    periodic cell, the O(N^2) builder for a cluster."""
    if any(pbc):
        nbr = nb.build_neighbor_list_images(positions, cell, pbc, r_cut,
                                            capacity, images=images)
    else:
        nbr = nb.build_neighbor_list(positions, cell, pbc, r_cut, capacity)
    return nb.with_reverse_slots(nbr) if with_rev else nbr


def _measured(positions, cell, pbc, r_cut: float, images,
              with_rev: bool) -> nb.NeighborList:
    """The list at its measured capacity: built with room for every
    candidate, then cut to the largest count rounded up to the granule
    (the builders put a row's neighbors first, nearest first)."""
    n_images = int(np.prod([2 * i + 1 for i in images])) if any(pbc) else 1
    full = _build(positions, cell, pbc, r_cut,
                  positions.shape[0] * n_images, images, False)
    cap = _bucket_capacity(int(full.mask.sum(dim=1).max()))
    nbr = full._replace(idx=full.idx[:, :cap], shift=full.shift[:, :cap],
                        mask=full.mask[:, :cap], rev=full.rev[:, :cap])
    return nb.with_reverse_slots(nbr) if with_rev else nbr


def _stack(lists: List[nb.NeighborList]) -> Lists:
    return Lists(*(torch.stack([getattr(n, f) for n in lists])
                   for f in Lists._fields))


# ---------------------------------------------------------------------------
# multi-species device featurization
# ---------------------------------------------------------------------------
class PairBlock(NamedTuple):
    """Static per-pair-interaction description (species-gated)."""
    spec: LegSpec
    lead: int
    trail: int
    s_a: int
    s_b: int
    n_basis: int


class TrioBlock(NamedTuple):
    """Static per-trio-interaction description.  The m leg (grid axis
    0, knots_map[trio][0]) binds the LOWER-atomic-number neighbor
    species, matching the oracle's z-ordering of neighbor pairs
    (featurize_np.enumerate_triplets; reference angles.py:424-478)."""
    spec_l1: LegSpec         # center - m leg
    spec_l2: LegSpec         # center - n leg
    spec_n: LegSpec          # m - n (third) leg
    lead: int
    trail: int
    s_c: int
    s_m: int
    s_n: int
    l1_basis: int
    l2_basis: int
    n_basis: int
    weight: float            # 0.5 when s_m == s_n (ordered pairs
    #                          double-count), else 1.0


class MultiFeaturizeSpec(NamedTuple):
    pairs: Tuple             # tuple of PairBlock, interactions order
    trios: Tuple             # tuple of TrioBlock, interactions order
    n_elements: int


def build_featurize_spec_multi(bspline_config):
    """Static multi-species device-featurization spec; None when any
    knot sequence lacks a closed-form LegSpec."""
    config = bspline_config
    element_list = list(config.chemical_system.element_list)
    s_of = {el: i for i, el in enumerate(element_list)}
    pairs = []
    for pair in config.interactions_map[2]:
        ok, spec = leg_spec_from_knots(config.knots_map[pair], exact=True)
        if not ok:
            return None
        pairs.append(PairBlock(
            spec=spec, lead=config.leading_trim[2],
            trail=config.trailing_trim[2],
            s_a=s_of[pair[0]], s_b=s_of[pair[1]],
            n_basis=spec.n_basis))
    trios = []
    if config.degree > 2:
        for trio in config.interactions_map[3]:
            seqs = [np.asarray(s) for s in config.knots_map[trio]]
            specs = []
            for seq in seqs:
                ok, spec = leg_spec_from_knots(seq, exact=True)
                if not ok:
                    return None
                specs.append(spec)
            el_m, el_n = trio[1], trio[2]
            if elements.atomic_numbers[el_m] \
                    > elements.atomic_numbers[el_n]:
                el_m, el_n = el_n, el_m
            trios.append(TrioBlock(
                spec_l1=specs[0], spec_l2=specs[1], spec_n=specs[2],
                lead=config.leading_trim[3],
                trail=config.trailing_trim[3],
                s_c=s_of[trio[0]], s_m=s_of[el_m], s_n=s_of[el_n],
                l1_basis=len(seqs[0]) - 4,
                l2_basis=len(seqs[1]) - 4,
                n_basis=len(seqs[2]) - 4,
                weight=0.5 if el_m == el_n else 1.0))
    return MultiFeaturizeSpec(pairs=tuple(pairs), trios=tuple(trios),
                              n_elements=len(element_list))


def _trio_block_grids(tb: TrioBlock, d, r, r_mn, r_mn2, unit, mask3,
                      s_c_row, s_slot3, rev_rows, folds=None):
    """Energy grid + force grids (B, ...) for one trio interaction.  Both
    derivative chains (m leg and n leg) are explicit because
    heterogeneous trios are single-counted: an atom of species s_m only
    ever occupies the m role (the unary path recovers the n chain from
    the ordered-pair double count instead).  ``folds``, when given, is
    the trio's (fold, fold of the transposed grid) pair (``compressor``),
    applied right after each outer product: the results are then
    (B, G') and (B, N, 3, G')."""
    gate_c = s_c_row == tb.s_c
    mask_m = mask3 & (s_slot3 == tb.s_m) & gate_c[..., None]
    mask_n = mask3 & (s_slot3 == tb.s_n) & gate_c[..., None]
    a1, da1 = _trimmed_basis(r, mask_m, tb.spec_l1, tb.lead, tb.trail)
    a2, da2 = _trimmed_basis(r, mask_n, tb.spec_l2, tb.lead, tb.trail)
    pair_ok = (mask_m[..., :, None] & mask_n[..., None, :]
               & (r_mn2 > 1e-10))
    c_mat, dc_mat = _trimmed_basis(r_mn, pair_ok, tb.spec_n, tb.lead,
                                   tb.trail)
    dc_over_r = dc_mat / r_mn[..., None]
    shape = (tb.l1_basis, tb.l2_basis, tb.n_basis)

    def to_abw(p):
        # the n chain's grid axis, (b, a, w) ordered, in (a, b, w) order
        lead = p.shape[:-1]
        p = p.reshape(lead + (shape[1], shape[0], shape[2]))
        return p.transpose(-3, -2).reshape(lead + (-1,))

    fold_m, fold_n = folds if folds is not None else (_identity, to_abw)
    # m chain: the n role contracted first
    p0, p1m, p3m, pvm = _chain(a1, da1, a2, c_mat, dc_over_r, d, fold_m)
    # n chain: the m role contracted first, on the transposed pair grids
    _, p1n, p3n, pvn = _chain(a2, da2, a1, c_mat.transpose(2, 3),
                              dc_over_r.transpose(2, 3), d, fold_n)
    e3 = tb.weight * torch.sum(p0, dim=(1, 2))
    mask_f = mask3.to(d.dtype)
    forces = tb.weight * (
        torch.einsum("zcmg,zcmx->zcxg", p1m + p1n, unit)
        + _neighbor_terms(p1m, p3m, pvm, unit, d, mask_f, rev_rows)
        + _neighbor_terms(p1n, p3n, pvn, unit, d, mask_f, rev_rows))
    if folds is not None:
        return e3, forces
    return e3.reshape(e3.shape[:1] + shape), \
        forces.reshape(forces.shape[:3] + shape)


def featurize_device_multi(mspec: MultiFeaturizeSpec,
                           species, positions, cell,
                           nbr_idx, nbr_shift, nbr_mask, nbr_rev,
                           nbr3_idx=None, nbr3_shift=None, nbr3_mask=None,
                           nbr3_rev=None, folds=None):
    """
    Energy + force features of one multi-species configuration
    (species (N,), positions (N, 3), cell (3, 3), (N, K) lists), or of a
    stack of configurations of one shape (every input and output then
    takes a leading B axis): species-gated masks over shared neighbor
    geometry, one pass per interaction.  The 3-body list may be None
    when the basis has no trio.

    Returns (e2_blocks, f2_blocks, e3_grids, f3_grids) -- tuples in
    interactions_map order; 3B grids uncompressed (L1, L2, NC), or with
    ``folds`` (per trio the pair ``compressor`` makes, the second for
    the transposed grid) folded onto the wedge: (G',) and (N, 3, G').
    """
    single = positions.dim() == 2
    (positions, cell, species, idx2, shift2, mask2, _, idx3, shift3, mask3,
     rev3) = _batched(positions, cell, species, nbr_idx, nbr_shift,
                      nbr_mask, nbr_rev, nbr3_idx, nbr3_shift, nbr3_mask,
                      nbr3_rev)
    s = species.to(torch.int64)
    # ---- 2-body ----
    d2v = _displacements(positions, cell, idx2, shift2)
    s_slot2 = torch.gather(s, 1, idx2.reshape(s.shape[0], -1)).reshape(
        idx2.shape)
    e2_blocks, f2_blocks = [], []
    for pb in mspec.pairs:
        gate = (((s[..., None] == pb.s_a) & (s_slot2 == pb.s_b))
                | ((s[..., None] == pb.s_b) & (s_slot2 == pb.s_a)))
        e2, f2 = _pair_features(pb.spec, pb.lead, pb.trail, d2v,
                                mask2 & gate)
        e2_blocks.append(e2)
        f2_blocks.append(f2)
    # ---- 3-body ----
    e3_grids, f3_grids = [], []
    if mspec.trios:
        d = _displacements(positions, cell, idx3, shift3)
        r, _ = _distance(d)
        unit = d / r[..., None]
        d_mn = d[:, :, None, :, :] - d[:, :, :, None, :]
        r_mn, r_mn2 = _distance(d_mn)
        s_slot3 = torch.gather(s, 1, idx3.reshape(s.shape[0], -1)).reshape(
            idx3.shape)
        rev_rows = _rev_rows(idx3, rev3)
        for t, tb in enumerate(mspec.trios):
            e3, f3 = _trio_block_grids(
                tb, d, r, r_mn, r_mn2, unit, mask3, s, s_slot3, rev_rows,
                None if folds is None else folds[t])
            e3_grids.append(e3)
            f3_grids.append(f3)
    out = (e2_blocks, f2_blocks, e3_grids, f3_grids)
    if single:
        return tuple(tuple(x[0] for x in part) for part in out)
    return tuple(tuple(part) for part in out)


# ---------------------------------------------------------------------------
# host orchestration: configurations, batches, datasets
# ---------------------------------------------------------------------------
class Plan(NamedTuple):
    """How a basis runs on the device: each list's cutoff (no 3-body
    list for a 2-body basis), the species index of each atomic number,
    and the batched call (positions (B, N, 3), cells (B, 3, 3), species
    (B, N), the stacked lists) giving energy (B, F) with the atom counts
    by element first, and forces (B, N, 3, F) with zeros there."""
    route: str
    r2: float
    r3: Optional[float]
    species_of: Dict[int, int]
    assemble: Callable


def _assemble(spec, fold, positions, cells, species, l2: Lists,
              l3: Lists):
    """The unary path's feature vectors of a batch."""
    e2, f2, e3, f3 = featurize_device(spec, positions, cells, *l2, *l3,
                                      fold=fold)
    n_cfg, n_atoms = positions.shape[:2]
    counts = torch.full((n_cfg, 1), float(n_atoms), dtype=positions.dtype,
                        device=positions.device)
    zeros = torch.zeros((n_cfg, n_atoms, 3, 1), dtype=positions.dtype,
                        device=positions.device)
    return (torch.cat([counts, e2, e3], dim=1),
            torch.cat([zeros, f2, f3], dim=3))


def _assemble_multi(mspec, folds, positions, cells, species, l2: Lists,
                    l3: Optional[Lists]):
    """The multi-species path's feature vectors of a batch."""
    e2, f2, e3, f3 = featurize_device_multi(
        mspec, species, positions, cells, *l2,
        *(l3 if l3 is not None else (None,) * 4), folds=folds)
    n_cfg, n_atoms = positions.shape[:2]
    elements_ = torch.arange(mspec.n_elements, device=species.device)
    counts = (species[..., None] == elements_).sum(dim=1).to(
        positions.dtype)
    zeros = torch.zeros((n_cfg, n_atoms, 3, mspec.n_elements),
                        dtype=positions.dtype, device=positions.device)
    return (torch.cat([counts, *e2, *e3], dim=1),
            torch.cat([zeros, *f2, *f3], dim=3))


def device_plan(bspline_config, dtype=torch.float64, device=None,
                spec: FeaturizeSpec = None,
                mspec: MultiFeaturizeSpec = None) -> Optional[Plan]:
    """The device path a basis takes: the unary 2+3-body path where
    ``build_featurize_spec`` allows it, else the multi-species path
    (multi-species or 2-body-only bases with closed-form knots); None
    for knots with no closed form.  ``spec`` / ``mspec`` pick a path."""
    config = bspline_config
    species_of = {elements.atomic_numbers[el]: i
                  for i, el in enumerate(config.element_list)}
    if mspec is None:
        spec = spec or build_featurize_spec(config)
    if spec is not None:
        trio = config.interactions_map[3][0]
        fold = compressor(config, trio, dtype, device)
        return Plan("device", spec.pair.t_max, spec.trio_l.t_max,
                    species_of, functools.partial(_assemble, spec, fold))
    mspec = mspec or build_featurize_spec_multi(config)
    if mspec is None:
        return None
    trios = config.interactions_map[3] if config.degree > 2 else []
    folds = tuple((compressor(config, trio, dtype, device),
                   compressor(config, trio, dtype, device, transposed=True))
                  for trio in trios)
    r3 = max((max(tb.spec_l1.t_max, tb.spec_l2.t_max)
              for tb in mspec.trios), default=None)
    return Plan("device multi", max(pb.spec.t_max for pb in mspec.pairs),
                r3, species_of,
                functools.partial(_assemble_multi, mspec, folds))


def _species(geom, plan: Plan, device) -> torch.Tensor:
    return torch.as_tensor([plan.species_of[int(z)]
                            for z in geom.get_atomic_numbers()],
                           dtype=torch.int64, device=device)


def _positions(geom, cell, pbc, dtype, device):
    positions = torch.as_tensor(np.asarray(geom.get_positions()),
                                dtype=dtype, device=device)
    return nb.wrap_positions(positions, cell, pbc) if any(pbc) \
        else positions


def _featurize_one(plan: Plan, geom, dtype, device):
    """(energy vector (F,), force features (N, 3, F)) of one
    configuration at measured capacities, on the device."""
    cell, pbc = _cell_of(geom, dtype, device)
    positions = _positions(geom, cell, pbc, dtype, device)
    cell_np = cell.cpu().numpy()
    l2 = _stack([_measured(positions, cell, pbc, plan.r2,
                           _images(cell_np, pbc, plan.r2), False)])
    l3 = None
    if plan.r3 is not None:
        l3 = _stack([_measured(positions, cell, pbc, plan.r3,
                               _images(cell_np, pbc, plan.r3), True)])
    e, f = plan.assemble(positions[None], cell[None],
                         _species(geom, plan, device)[None], l2, l3)
    return e[0], f[0]


def featurize_configuration_device(bspline_config, geom,
                                   spec: FeaturizeSpec = None,
                                   dtype=torch.float64, device=None):
    """
    Device-path equivalent of BasisFeaturizer.evaluate_configuration
    for unary 2+3-body systems: returns (energy feature vector without
    the target column, force feature array (N, 3, n_feats)) as numpy.
    The lists are built on the device at their measured capacities.
    """
    device = _resolve_device(device)
    if spec is None:
        spec = build_featurize_spec(bspline_config)
    if spec is None:
        raise ValueError("configuration outside the device fast path")
    e, f = _featurize_one(device_plan(bspline_config, dtype, device,
                                      spec=spec), geom, dtype, device)
    return e.cpu().numpy(), f.cpu().numpy()


def featurize_configuration_device_multi(bspline_config, geom,
                                         mspec: MultiFeaturizeSpec = None,
                                         dtype=torch.float64, device=None):
    """
    Multi-species device equivalent of
    BasisFeaturizer.evaluate_configuration: returns (energy feature
    vector without the target column, force features (N, 3, n_feats))
    as numpy.  The lists are built on the device at their measured
    capacities, each from its own cutoff.
    """
    device = _resolve_device(device)
    if mspec is None:
        mspec = build_featurize_spec_multi(bspline_config)
    if mspec is None:
        raise ValueError("configuration outside the device fast path")
    e, f = _featurize_one(device_plan(bspline_config, dtype, device,
                                      mspec=mspec), geom, dtype, device)
    return e.cpu().numpy(), f.cpu().numpy()


class FeatureBatch(NamedTuple):
    """Fitting rows of some configurations of a dataset, on the device:
    per-atom energy rows (one per configuration) and force rows
    (fx_0..fx_{N-1}, fy..., fz... per configuration that has forces)."""
    index: List[int]         # the configurations' positions in the dataset
    x_e: torch.Tensor        # (n, F)
    y_e: torch.Tensor        # (n,)
    x_f: torch.Tensor        # (sum of force_rows, F)
    y_f: torch.Tensor        # (sum of force_rows,)
    force_rows: List[int]    # per configuration: 3 N, or 0 without forces


def has_forces(forces, i: int) -> bool:
    """Whether configuration i has force targets (``forces`` None: no
    configuration has)."""
    return forces is not None and forces[i] is not None


def _force_rows(force) -> np.ndarray:
    """Targets fx..., fy..., fz... from (N, 3) forces."""
    return np.asarray(force, dtype=np.float64).T.reshape(-1)


def _rows(index, e_vecs, f_vecs, energies, forces, dtype, device):
    n_atoms = f_vecs.shape[1]
    y_e = torch.as_tensor(np.array([energies[i] for i in index]) / n_atoms,
                          dtype=dtype, device=device)
    keep = [b for b, i in enumerate(index) if has_forces(forces, i)]
    if len(keep) < len(index):
        f_vecs = f_vecs.index_select(0, torch.as_tensor(
            keep, dtype=torch.int64, device=device))
    x_f = f_vecs.transpose(1, 2).reshape(-1, f_vecs.shape[-1])
    y_f = torch.as_tensor(np.concatenate(
        [_force_rows(forces[index[b]]) for b in keep]) if keep
        else np.zeros(0), dtype=dtype, device=device)
    return FeatureBatch(list(index), e_vecs / n_atoms, y_e, x_f, y_f,
                        [3 * n_atoms if has_forces(forces, i) else 0
                         for i in index])


def featurize_batches(bspline_config, geometries, energies, forces,
                      dtype=torch.float64, device=None,
                      batch_size: int = None,
                      stats: Dict = None) -> Iterator[FeatureBatch]:
    """
    Device featurization of a dataset, one ``FeatureBatch`` of device
    tensors per batched call, on the path the basis takes
    (``device_plan``): configurations are grouped by shape (atom count,
    pbc, images, estimated capacities; not species) and each group is
    featurized in calls of ``batch_size`` configurations (by default as
    many as a quarter of the card's memory holds, from the peak memory
    of the group's first call; 8 on the CPU).  The lists are built on
    the device, each from its own cutoff, at capacities estimated from
    the density; a configuration whose list overflows is built again at
    its measured count and featurized alone.  ``forces`` holds (N, 3)
    arrays; an entry None (or ``forces`` None) gives that configuration
    (every configuration) its energy row alone.  ``stats``, when given,
    receives the route, the redo count, the batch sizes, the calls and
    the peak memory.
    """
    device = _resolve_device(device)
    plan = device_plan(bspline_config, dtype, device)
    if plan is None:
        raise ValueError("basis outside the device paths (knots with no "
                         "closed form): the host featurizer "
                         "representation.process.BasisFeaturizer takes it")
    stats = {} if stats is None else stats
    stats.update(route=plan.route, redos=0, calls=0, batch_sizes={},
                 peak_bytes=0)
    on_card = device.type == "cuda"
    buckets: Dict[Tuple, List[int]] = {}
    alone = []   # clusters: measured capacities, one call each
    for i, geom in enumerate(geometries):
        check_elements(geom, bspline_config.element_list, i)
        cell, pbc = _cell_of(geom, torch.float64, "cpu")
        if not any(pbc):
            alone.append(i)
            continue
        cell = cell.numpy()
        volume = abs(np.linalg.det(cell))
        n_atoms = len(geom)
        key = (n_atoms, pbc) + tuple(
            (_images(cell, pbc, r), _bucket_capacity(
                nb.estimate_capacity(n_atoms, volume, r)))
            if r is not None else None for r in (plan.r2, plan.r3))
        buckets.setdefault(key, []).append(i)
    redo = []
    for (n_atoms, pbc, list2, list3), entries in buckets.items():
        size = batch_size or (1 if on_card else CPU_BATCH)
        start = 0
        while start < len(entries):
            chunk = entries[start:start + size]
            if on_card:
                torch.cuda.reset_peak_memory_stats(device)
                base = torch.cuda.memory_allocated(device)
            positions, cells, species, l2, l3 = [], [], [], [], []
            for i in chunk:
                cell, _ = _cell_of(geometries[i], dtype, device)
                x = _positions(geometries[i], cell, pbc, dtype, device)
                positions.append(x)
                cells.append(cell)
                species.append(_species(geometries[i], plan, device))
                l2.append(_build(x, cell, pbc, plan.r2, list2[1], list2[0],
                                 False))
                if list3 is not None:
                    l3.append(_build(x, cell, pbc, plan.r3, list3[1],
                                     list3[0], True))
            flags = [n.overflow for n in l2 + l3]
            overflow = torch.stack(flags).reshape(
                -1, len(chunk)).any(dim=0).cpu().numpy()
            e_vecs, f_vecs = plan.assemble(
                torch.stack(positions), torch.stack(cells),
                torch.stack(species), _stack(l2),
                _stack(l3) if l3 else None)
            stats["calls"] += 1
            start += len(chunk)
            if on_card:
                peak = torch.cuda.max_memory_allocated(device)
                stats["peak_bytes"] = max(stats["peak_bytes"], peak)
                if batch_size is None and start == len(chunk):
                    per_cfg = max(1, (peak - base) / len(chunk))
                    budget = MEMORY_BUDGET * torch.cuda.get_device_properties(
                        device).total_memory
                    size = int(max(1, min(MAX_BATCH, budget // per_cfg)))
            stats["batch_sizes"][n_atoms] = size
            keep = np.flatnonzero(~overflow)
            redo.extend(chunk[b] for b in np.flatnonzero(overflow))
            if len(keep):
                rows = torch.as_tensor(keep, device=device)
                yield _rows([chunk[b] for b in keep],
                            e_vecs.index_select(0, rows),
                            f_vecs.index_select(0, rows), energies, forces,
                            dtype, device)
    stats["redos"] = len(redo)
    for i in alone + redo:
        e, f = _featurize_one(plan, geometries[i], dtype, device)
        stats["calls"] += 1
        yield _rows([i], e[None], f[None], energies, forces, dtype, device)


def featurize_dataset_device(bspline_config, geometries, energies, forces,
                             dtype=torch.float64, device=None,
                             batch_size: int = None, stats: Dict = None):
    """
    Device featurization of a dataset into fitting arrays
    (x_e, y_e, x_f, y_f) as numpy, with per-atom energy normalization,
    matching ``regression.least_squares.dataframe_to_tuples`` semantics
    of the reference: per-atom energy rows in dataset order, then the
    force rows fx_0..fx_{N-1}, fy..., fz... of each configuration that
    has forces, in dataset order.  ``featurize_batches`` gives the same
    rows batch by batch on the device (for a Gram matrix that never
    leaves it).
    """
    e_rows, f_rows = [None] * len(geometries), [None] * len(geometries)
    n_columns = None
    for batch in featurize_batches(bspline_config, geometries, energies,
                                   forces, dtype=dtype, device=device,
                                   batch_size=batch_size, stats=stats):
        x_e, y_e = batch.x_e.cpu().numpy(), batch.y_e.cpu().numpy()
        x_f, y_f = batch.x_f.cpu().numpy(), batch.y_f.cpu().numpy()
        n_columns = x_e.shape[1]
        offset = 0
        for b, i in enumerate(batch.index):
            n_rows = batch.force_rows[b]
            e_rows[i] = (x_e[b], y_e[b])
            f_rows[i] = (x_f[offset:offset + n_rows],
                         y_f[offset:offset + n_rows])
            offset += n_rows
    return (np.stack([e[0] for e in e_rows]),
            np.array([e[1] for e in e_rows]),
            np.concatenate([f[0] for f in f_rows]).reshape(-1, n_columns),
            np.concatenate([f[1] for f in f_rows]))


class Featurizer:
    """
    The fitting rows of a dataset for any basis, by the route the basis
    allows (``route``): ``"device"``, the unary 2+3-body path;
    ``"device multi"``, the multi-species path, for every other basis
    with closed-form knots (multi-species, or 2-body only); ``"host"``,
    the host featurizer ``BasisFeaturizer``, for knots with no closed
    form.  ``fit_forces`` False gives no force rows; ``prefix`` is the
    reference's column prefix, carried as it carries it.  The device
    routes run on ``device``, the CUDA card unless it says otherwise.
    """

    def __init__(self, bspline_config, fit_forces: bool = True,
                 prefix: str = "x", device=None, dtype=torch.float64):
        self.bspline_config = bspline_config
        self.fit_forces = bool(fit_forces)
        self.prefix = prefix
        self.device = _resolve_device(device)
        self.dtype = dtype
        plan = device_plan(bspline_config, dtype, self.device)
        self.route = "host" if plan is None else plan.route

    def force_rows(self, geometries, forces) -> np.ndarray:
        """Force rows per configuration: 3 N, or 0 without forces or
        with ``fit_forces`` False."""
        return np.array([3 * len(g) if self.fit_forces
                         and has_forces(forces, i) else 0
                         for i, g in enumerate(geometries)], dtype=np.int64)

    def featurize_dataset(self, geometries, energies, forces,
                          stats: Dict = None):
        """(x_e, y_e, x_f, y_f) as numpy, in the order of
        ``featurize_dataset_device``; ``forces`` as it takes them."""
        forces = forces if self.fit_forces else None
        if self.route == "host":
            if stats is not None:
                stats.update(route=self.route, calls=len(geometries),
                             redos=0)
            return BasisFeaturizer(
                self.bspline_config, fit_forces=self.fit_forces,
                prefix=self.prefix).featurize_dataset(geometries, energies,
                                                      forces)
        return featurize_dataset_device(
            self.bspline_config, geometries, energies, forces,
            dtype=self.dtype, device=self.device, stats=stats)

    def feature_table(self, df_data, atoms_key: str = "geometry",
                      energy_key: str = "energy",
                      stats: Dict = None) -> FeatureTable:
        """The reference's feature table of a ``data.io.Dataset``
        (``BasisFeaturizer.evaluate``'s rows, names and kinds: per
        configuration its ``energy_key`` row, then fx / fy / fz per atom
        where it has forces and ``fit_forces`` is on), featurized on the
        featurizer's route."""
        if self.route == "host":
            if stats is not None:
                stats.update(route=self.route, calls=len(df_data), redos=0)
            return BasisFeaturizer(
                self.bspline_config, fit_forces=self.fit_forces,
                prefix=self.prefix).evaluate(df_data, atoms_key=atoms_key,
                                             energy_key=energy_key)
        geometries = df_data[atoms_key]
        energies = np.asarray(df_data[energy_key], dtype=float)
        forces = data_io.dataset_forces(df_data) if self.fit_forces else None
        blocks = [None] * len(geometries)
        for batch in featurize_batches(
                self.bspline_config, geometries, energies, forces,
                dtype=self.dtype, device=self.device, stats=stats):
            x_e, x_f, y_f = (t.cpu().numpy() for t in (batch.x_e, batch.x_f,
                                                      batch.y_f))
            start = 0
            for b, i in enumerate(batch.index):
                stop = start + batch.force_rows[b]
                # the device's energy rows are per atom; the table's are not
                blocks[i] = np.concatenate([
                    np.concatenate([[energies[i]],
                                    x_e[b] * len(geometries[i])])[None],
                    np.column_stack([y_f[start:stop], x_f[start:stop]])])
                start = stop
        index = []
        for key, geom, block in zip(df_data.keys, geometries, blocks):
            index.append((key, energy_key))
            if len(block) > 1:
                index.extend((key, f"{c}_{a}") for c in ("fx", "fy", "fz")
                             for a in range(len(geom)))
        return FeatureTable(index, self.bspline_config.get_column_names(),
                            np.concatenate(blocks))

    def write_features(self, filename: str, df_data,
                       atoms_key: str = "geometry",
                       energy_key: str = "energy", stats: Dict = None,
                       batch_size: int = 50,
                       table_template: str = "features_{}"):
        """Featurize a ``data.io.Dataset`` (its ``atoms_key`` geometries,
        ``energy_key`` energies and fx / fy / fz forces) into the
        features file ``filename``.

        An HDF5 path (``.h5`` / ``.hdf5``) gets the reference's
        ``batched_to_hdf`` tables: batches of ``batch_size``
        configurations under its names (``process.table_batches``), each
        featurized (``feature_table``), brought to the host and written
        as one table before the next starts; tables the file holds are
        skipped, so a run cut short resumes.  Returns the names of the
        tables written.  Any other path gets the ``.npz`` with the keys,
        sizes, force rows and column names; returns (x_e, y_e, x_f, y_f)
        and the force rows.  ``stats``, when given, receives the route,
        the featurization calls and redos, the energy and force rows
        written and, for HDF5, the tables written and skipped."""
        stats = {} if stats is None else stats
        if hdf5.is_hdf5_path(filename):
            return self._write_tables(filename, df_data, atoms_key,
                                      energy_key, stats, batch_size,
                                      table_template)
        geometries = df_data[atoms_key]
        forces = data_io.dataset_forces(df_data)
        arrays = self.featurize_dataset(
            geometries, np.asarray(df_data[energy_key], dtype=float),
            forces, stats=stats)
        force_rows = self.force_rows(geometries, forces)
        data_io.save_features(filename, arrays, df_data.keys, geometries,
                              force_rows,
                              self.bspline_config.get_column_names())
        stats.update(energy_rows=len(arrays[1]), force_rows=len(arrays[3]))
        return arrays, force_rows

    def _write_tables(self, filename, df_data, atoms_key, energy_key, stats,
                      batch_size, table_template) -> List[str]:
        existing = set(process.existing_tables(filename))
        stats.update(route=self.route, calls=0, redos=0, energy_rows=0,
                     force_rows=0, tables=[], skipped=0)
        for name, positions in process.table_batches(
                len(df_data), batch_size, table_template):
            if name in existing:
                stats["skipped"] += 1
                continue
            part = {}
            table = self.feature_table(df_data.take(positions), atoms_key,
                                       energy_key, stats=part)
            process.save_feature_db(table, filename, table_name=name)
            n_energy = sum(kind == energy_key for kind in table.kinds)
            stats["calls"] += part["calls"]
            stats["redos"] += part["redos"]
            stats["energy_rows"] += n_energy
            stats["force_rows"] += len(table) - n_energy
            stats["tables"].append(name)
        return stats["tables"]
