"""
The reference's general (factorized) force path in torch: the tables
of any fitted model (any species, any knots, with or without a 3-body
term) as buffers of one ``nn.Module``, and the energy, forces and
(3, 3) virial computed from them on padded neighbor rows.

Counterpart of ``uf3_tpu/ops/potential.py``: ``PotentialParams`` and
``PotentialStatic`` (the buffers and the plain attributes of
``FactorizedPotential``), ``params_from_model`` and ``build_potential``
(``FactorizedPotential.from_model``), ``pair_contributions``,
``pair_contributions_fast``, ``_dense_leg_basis``,
``trio_contributions_factorized``, ``trio_contributions`` and
``compute_energy_forces``.  Two choices depart from it in form only:
``pair_contributions_fast`` picks each pair's polynomial row by a
gather per pair type, where the reference multiplies by a one-hot
matrix (a TPU workaround); ``_dense_leg_basis`` returns the values and
the derivatives of one recursion.  Contractions on the card run with
TF32 off.
"""

import contextlib

import numpy as np
import torch
from torch import nn

from uf3_tpu_torch import io
from uf3_tpu_torch.data import elements
from uf3_tpu_torch.ops.neighbors import NeighborList, displacements
from uf3_tpu_torch.ops.spline_jax import (build_pair_tables,
                                          build_trio_tables, deboor_taps,
                                          horner_cubic, tricubic_eval)

# the tables of ``PotentialParams``, in its order; the cutoffs are plain
# attributes
TABLES = ("z_to_species", "offsets_1b", "pair_type", "pair_poly_e",
          "pair_poly_f", "pair_breaks", "pair_knots", "pair_r_min",
          "pair_r_max", "trio_type", "trio_poly", "trio_breaks",
          "trio_knots", "trio_n_cells", "trio_leg_min", "trio_leg_max",
          "trio_grid", "trio_knot_seq")
INDEX_TABLES = ("z_to_species", "pair_type", "trio_type", "trio_n_cells")


def _pad_to(array, shape):
    return np.pad(array, [(0, s - d) for s, d in zip(shape, array.shape)])


def params_from_model(model):
    """Host tables (float64 numpy) of a fitted model (any object with
    ``bspline_config`` and ``coefficients``): (tables by name, number
    of pair types, trio specs (type, center, leg-1, leg-2 species, L,
    M, NC) per stored ordered trio type, r_cut_2b, r_cut_3b)."""
    config = model.bspline_config
    element_list = list(config.element_list)
    n_species = len(element_list)
    z_list = [elements.atomic_numbers[el] for el in element_list]
    z_to_species = np.zeros(max(z_list) + 1, dtype=np.int64)
    for s, z in enumerate(z_list):
        z_to_species[z] = s
    solutions = io.arrange_coefficients(model.coefficients, config)
    t = dict(z_to_species=z_to_species, offsets_1b=np.array(
        [float(np.asarray(solutions[el]).flat[0]) for el in element_list]))

    pairs = config.interactions_map[2]
    pair_type = np.zeros((n_species, n_species), dtype=np.int64)
    rows = []
    for p_idx, pair in enumerate(pairs):
        s_a, s_b = element_list.index(pair[0]), element_list.index(pair[1])
        pair_type[s_a, s_b] = pair_type[s_b, s_a] = p_idx
        knots = np.asarray(config.knots_map[pair], dtype=np.float64)
        rows.append(build_pair_tables(knots, solutions[pair])
                    + (knots[3:len(knots) - 3],
                       max(config.r_min_map[pair], 0.0),
                       config.r_max_map[pair]))
    max_i2 = max(row[0].shape[0] for row in rows)
    t.update(pair_type=pair_type,
             pair_poly_e=np.stack([_pad_to(row[0], (max_i2, 4))
                                   for row in rows]),
             pair_poly_f=np.stack([_pad_to(row[1], (max_i2, 4))
                                   for row in rows]),
             pair_breaks=np.stack([_pad_to(row[2], (max_i2, 2))
                                   for row in rows]),
             pair_knots=np.stack([np.pad(row[3], (0, max_i2 + 1 - len(row[3])),
                                         constant_values=np.inf)
                                  for row in rows]),
             pair_r_min=np.array([row[4] for row in rows]),
             pair_r_max=np.array([row[5] for row in rows]))
    r_cut_2b = float(np.max(t["pair_r_max"]))

    trio_type = -np.ones((n_species,) * 3, dtype=np.int64)
    trio_rows, trio_specs = [], []
    r_cut_3b = 0.0
    for trio in (config.interactions_map[3] if config.degree > 2 else []):
        s_c, s_m, s_n = (element_list.index(el) for el in trio)
        grid = config.decompress_3B(solutions[trio], trio)
        seqs = [np.asarray(s, dtype=np.float64)
                for s in config.knots_map[trio]]
        variants = [((s_c, s_m, s_n), grid, seqs)]
        if s_m != s_n:  # the other leg order, as its own ordered type
            variants.append(((s_c, s_n, s_m), grid.transpose(1, 0, 2),
                             [seqs[1], seqs[0], seqs[2]]))
        for key, g, sq in variants:
            trio_type[key] = len(trio_rows)
            poly, breaks = build_trio_tables(sq, g)
            trio_specs.append((len(trio_rows),) + key + g.shape)
            trio_rows.append((poly, breaks, [s[3:len(s) - 3] for s in sq],
                              [s[0] for s in sq], [s[-1] for s in sq], g,
                              sq))
        r_cut_3b = max(r_cut_3b, float(max(seqs[0][-1], seqs[1][-1])))
    t["trio_type"] = trio_type
    if trio_rows:
        cells = [max(row[0].shape[d] for row in trio_rows) for d in range(3)]
        max_i3 = max(cells)
        basis = [max(row[5].shape[d] for row in trio_rows) for d in range(3)]
        max_ks = max(len(s) for row in trio_rows for s in row[6])
        t.update(
            trio_poly=np.stack([_pad_to(row[0], tuple(cells) + (64,))
                                for row in trio_rows]),
            trio_breaks=np.stack([np.stack([_pad_to(b, (max_i3, 2))
                                            for b in row[1]])
                                  for row in trio_rows]),
            trio_knots=np.stack([np.stack([
                np.pad(e, (0, max_i3 + 1 - len(e)), constant_values=np.inf)
                for e in row[2]]) for row in trio_rows]),
            trio_n_cells=np.array([row[0].shape[:3] for row in trio_rows],
                                  dtype=np.int64),
            trio_leg_min=np.array([row[3] for row in trio_rows]),
            trio_leg_max=np.array([row[4] for row in trio_rows]),
            trio_grid=np.stack([_pad_to(row[5], tuple(basis))
                                for row in trio_rows]),
            # knot sequences padded past their last knot (never read:
            # each type slices its own length)
            trio_knot_seq=np.stack([np.stack([
                np.pad(s, (0, max_ks - len(s)), constant_values=s[-1] + 1e6)
                for s in row[6]]) for row in trio_rows]))
    else:
        t.update(trio_poly=np.zeros((1, 1, 1, 1, 64)),
                 trio_breaks=np.zeros((1, 3, 1, 2)),
                 trio_knots=np.full((1, 3, 2), np.inf),
                 trio_n_cells=np.ones((1, 3), dtype=np.int64),
                 trio_leg_min=np.zeros((1, 3)), trio_leg_max=np.zeros((1, 3)),
                 trio_grid=np.zeros((1, 1, 1, 1)),
                 trio_knot_seq=np.full((1, 3, 8), np.inf))
    return t, len(pairs), tuple(trio_specs), r_cut_2b, r_cut_3b


class FactorizedPotential(nn.Module):
    """The tables of ``PotentialParams`` as buffers (index tables int64,
    the others in ``dtype``), the ``PotentialStatic`` metadata
    (``n_pair_types``, ``trio_specs``) and the cutoffs as plain
    attributes."""

    def __init__(self, tables, n_pair_types: int, trio_specs,
                 r_cut_2b: float, r_cut_3b: float, dtype=torch.float64,
                 device=None):
        super().__init__()
        for name in TABLES:
            self.register_buffer(name, torch.tensor(
                np.asarray(tables[name]), device=device,
                dtype=torch.int64 if name in INDEX_TABLES else dtype))
        self.n_pair_types = int(n_pair_types)
        self.trio_specs = tuple(tuple(int(x) for x in spec)
                                for spec in trio_specs)
        self.r_cut_2b = float(r_cut_2b)
        self.r_cut_3b = float(r_cut_3b)

    @classmethod
    def from_model(cls, model, dtype=torch.float64, device=None):
        """From a fitted model (``io.load_model``'s, or any object with
        ``bspline_config`` and ``coefficients``)."""
        return cls(*params_from_model(model), dtype=dtype, device=device)

    @classmethod
    def from_jax_params(cls, params, static, dtype=torch.float64,
                        device=None):
        """Weights converter from the JAX package: ``params`` its
        ``PotentialParams`` (arrays as numpy), ``static`` its
        ``PotentialStatic`` (n_pair_types, trio_specs)."""
        tables = {name: np.asarray(getattr(params, name)) for name in TABLES}
        return cls(tables, static.n_pair_types, static.trio_specs,
                   float(np.asarray(params.r_cut_2b)),
                   float(np.asarray(params.r_cut_3b)), dtype=dtype,
                   device=device)


@contextlib.contextmanager
def _full_precision(device):
    """Float32 contractions on the card without TF32 (cuBLAS would
    otherwise round their inputs to 10 bits of mantissa when a caller
    allows it)."""
    if device.type != "cuda":
        yield
        return
    allowed = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allowed


def _safe_r(d):
    r2 = torch.sum(d * d, dim=-1)
    return torch.sqrt(torch.where(r2 > 0, r2, torch.ones_like(r2)))


def _interval_lookup(r, edges, n_intervals: int):
    """Branchless searchsorted: edges (..., I+1), r (...,)."""
    idx = torch.sum(edges < r[..., None], dim=-1) - 1
    return torch.clamp(idx, 0, n_intervals - 1)


def _pair_sums(d, r, energy, dvdr, mask):
    """Per-atom energies (ordered pairs: each bond twice), forces and
    virial from per-slot spline values."""
    zero = torch.zeros_like(r)
    energy = torch.where(mask, energy, zero)
    dvdr = torch.where(mask, dvdr, zero)
    unit = d / r[..., None]
    forces = 2.0 * torch.sum(dvdr[..., None] * unit, dim=1)
    with _full_precision(d.device):
        virial = torch.einsum("nk,nka,nkb->ab", dvdr / r, d, d)
    return torch.sum(energy, dim=1), forces, virial


def pair_contributions(pot: FactorizedPotential, species, positions, cell,
                       nbr: NeighborList, d=None):
    """Per-atom 2-body energies (N,), forces (N, 3) and the (3, 3)
    virial: the pair type, interval and polynomial row gathered per
    (N, K) slot.  ``d`` reuses a displacement gather of ``nbr``."""
    if d is None:
        d = displacements(positions, cell, nbr.idx, nbr.shift)
    r = _safe_r(d)
    ptype = pot.pair_type[species[:, None], species[nbr.idx]]
    mask = (nbr.mask & (r > pot.pair_r_min[ptype])
            & (r < pot.pair_r_max[ptype]))
    interval = _interval_lookup(r, pot.pair_knots[ptype],
                                pot.pair_poly_e.shape[1])
    breaks = pot.pair_breaks[ptype, interval]
    u = (r - breaks[..., 0]) * breaks[..., 1]
    energy = horner_cubic(pot.pair_poly_e[ptype, interval], u)
    dvdr = horner_cubic(pot.pair_poly_f[ptype, interval], u)
    return _pair_sums(d, r, energy, dvdr, mask)


def pair_contributions_fast(pot: FactorizedPotential, species, positions,
                            cell, nbr: NeighborList, d=None):
    """``pair_contributions`` looped over the pair types: each type's
    interval by a search of its own break points, its rows by a gather
    from its own tables."""
    if d is None:
        d = displacements(positions, cell, nbr.idx, nbr.shift)
    r = _safe_r(d)
    n_int = pot.pair_poly_e.shape[1]
    energy = torch.zeros_like(r)
    dvdr = torch.zeros_like(r)
    ptype = pot.pair_type[species[:, None], species[nbr.idx]] \
        if pot.n_pair_types > 1 else None
    for p in range(pot.n_pair_types):
        mask = (nbr.mask & (r > pot.pair_r_min[p]) & (r < pot.pair_r_max[p]))
        if ptype is not None:
            mask = mask & (ptype == p)
        # the reference's one-hot row: edges[i] <= r < edges[i + 1]
        interval = torch.clamp(torch.searchsorted(
            pot.pair_knots[p], r.contiguous(), right=True) - 1, 0, n_int - 1)
        breaks = pot.pair_breaks[p, interval]
        u = (r - breaks[..., 0]) * breaks[..., 1]
        zero = torch.zeros_like(r)
        energy = energy + torch.where(
            mask, horner_cubic(pot.pair_poly_e[p, interval], u), zero)
        dvdr = dvdr + torch.where(
            mask, horner_cubic(pot.pair_poly_f[p, interval], u), zero)
    return _pair_sums(d, r, energy, dvdr, nbr.mask)


def _dense_leg_basis(r, knot_seq, n_splines: int, valid):
    """The 4-tap de Boor values and derivatives scattered into dense
    (..., n_splines) basis matrices, zero where ``valid`` is False or r
    lies outside the sequence."""
    values, derivs, idx = deboor_taps(r, knot_seq)
    in_range = (valid & (r >= knot_seq[0]) & (r <= knot_seq[-1]))[..., None]
    cols = idx[..., None] + torch.arange(4, device=r.device)
    out = []
    for taps in (values, derivs):
        taps = torch.where(in_range, taps, 0.0)
        dense = torch.zeros(r.shape + (n_splines,), dtype=r.dtype,
                            device=r.device)
        out.append(dense.scatter_(-1, cols, taps))
    return out[0], out[1]


def _trio_rows(positions, cell, nbr3: NeighborList, d):
    """Displacements (N, K, 3), |d| (N, K), the neighbor-neighbor legs
    d_mn (N, K, K, 3) = d[n] - d[m] and |d_mn|."""
    if d is None:
        d = displacements(positions, cell, nbr3.idx, nbr3.shift)
    d_mn = d[:, None, :, :] - d[:, :, None, :]
    r_mn2 = torch.sum(d_mn * d_mn, dim=-1)
    r_mn = torch.sqrt(torch.where(r_mn2 > 0, r_mn2, torch.ones_like(r_mn2)))
    return d, _safe_r(d), d_mn, r_mn2, r_mn


def _trio_sums(nbr3: NeighborList, value, g1, g2, g3, d, r, d_mn, r_mn):
    """Per-atom energies, forces and virial from the per-lane value and
    leg derivatives g1 (d/d r_cm), g2 (d/d r_cn), g3 (d/d r_mn) of each
    center's ordered neighbor pairs.  The force a neighbor receives is
    gathered from the center's lanes through the reverse slots."""
    n_atoms, k = nbr3.idx.shape
    unit = d / r[..., None]
    forces = torch.sum(torch.sum(g1, dim=2)[..., None] * unit, dim=1)
    # atom a, neighbor c = idx[a, s] holding a at slot p = rev[a, s]:
    # f_a += sum_n g1[c, p, n] d_ac / r_ac + g3[c, p, n] d_an / r_an,
    # with d_an = d_ac + d_cn and r_an = r_mn[c, p, n]
    flat = nbr3.idx * k + nbr3.rev
    g1_rows = g1.reshape(-1, k)[flat]
    g3_rows = g3.reshape(-1, k)[flat]
    r_an = r_mn.reshape(-1, k)[flat]
    d_an = d[:, :, None, :] + d.reshape(n_atoms, -1)[nbr3.idx].reshape(
        n_atoms, k, k, 3)
    term1 = torch.sum(g1_rows, dim=2)[..., None] * unit
    term2 = torch.sum((g3_rows / r_an)[..., None] * d_an, dim=2)
    forces = forces + torch.sum(torch.where(
        nbr3.mask[..., None], term1 + term2, torch.zeros_like(term1)), dim=1)
    with _full_precision(d.device):
        virial = 0.5 * (
            torch.einsum("nm,nma,nmb->ab", torch.sum(g1, dim=2) / r, d, d)
            + torch.einsum("nm,nma,nmb->ab", torch.sum(g2, dim=1) / r, d, d)
            + torch.einsum("nmk,nmka,nmkb->ab", g3 / r_mn, d_mn, d_mn))
    return 0.5 * torch.sum(value, dim=(1, 2)), forces, virial


def trio_contributions_factorized(pot: FactorizedPotential, species,
                                  positions, cell, nbr3: NeighborList,
                                  d=None):
    """3-body energies, forces and virial as dense contractions per
    ordered trio type, T[m, n] = sum_abc A[m, a] B[n, b] C[m, n, c]
    G[a, b, c], the legs' dense bases gated by the center's and the
    neighbors' species."""
    n_atoms, k = nbr3.idx.shape
    d, r, d_mn, r_mn2, r_mn = _trio_rows(positions, cell, nbr3, d)
    s_nb = species[nbr3.idx]
    not_diag = ~torch.eye(k, dtype=torch.bool, device=d.device)[None]
    pair_ok = (nbr3.mask[:, :, None] & nbr3.mask[:, None, :] & not_diag
               & (r_mn2 > 1e-10))
    sums = [torch.zeros((n_atoms, k, k), dtype=d.dtype, device=d.device)
            for _ in range(4)]                       # value, g1, g2, g3
    gated = pot.offsets_1b.shape[0] > 1
    for (t, s_c, s_m, s_n, n_l, n_m, n_c) in pot.trio_specs:
        grid = pot.trio_grid[t, :n_l, :n_m, :n_c]
        m_ok = nbr3.mask & (s_nb == s_m) if gated else nbr3.mask
        n_ok = nbr3.mask & (s_nb == s_n) if gated else nbr3.mask
        a_mat, da_mat = _dense_leg_basis(
            r, pot.trio_knot_seq[t, 0, :n_l + 4], n_l, m_ok)   # (N, K, L)
        b_mat, db_mat = _dense_leg_basis(
            r, pot.trio_knot_seq[t, 1, :n_m + 4], n_m, n_ok)   # (N, K, M)
        c_mat, dc_mat = _dense_leg_basis(
            r_mn, pot.trio_knot_seq[t, 2, :n_c + 4], n_c, pair_ok)
        with _full_precision(d.device):
            h = torch.einsum("nia,abc->nibc", a_mat, grid)     # (N,K,M,NC)
            h1 = torch.einsum("nia,abc->nibc", da_mat, grid)
            dd = torch.einsum("nijc,nibc->nijb", c_mat, h)     # (N,K,K,M)
            d1 = torch.einsum("nijc,nibc->nijb", c_mat, h1)
            d3 = torch.einsum("nijc,nibc->nijb", dc_mat, h)
            terms = (torch.einsum("njb,nijb->nij", b_mat, dd),
                     torch.einsum("njb,nijb->nij", b_mat, d1),
                     torch.einsum("njb,nijb->nij", db_mat, dd),
                     torch.einsum("njb,nijb->nij", b_mat, d3))
        c_w = (species == s_c).to(d.dtype)[:, None, None] if gated else 1.0
        sums = [acc + term * c_w for acc, term in zip(sums, terms)]
    return _trio_sums(nbr3, *sums, d, r, d_mn, r_mn)


def trio_contributions(pot: FactorizedPotential, species, positions, cell,
                       nbr3: NeighborList, d=None):
    """3-body energies, forces and virial from the per-cell tricubic
    tables: one 64-coefficient polynomial per (center, m, n) lane of
    the ordered type G[s_c, s_m, s_n] (the reference's route without
    ``static``)."""
    k = nbr3.idx.shape[1]
    d, r, d_mn, r_mn2, r_mn = _trio_rows(positions, cell, nbr3, d)
    s_m = species[nbr3.idx]
    ttype = pot.trio_type[species[:, None, None], s_m[:, :, None],
                          s_m[:, None, :]]                   # (N, K, K)
    t = torch.clamp(ttype, min=0)
    r_cm, r_cn = r[:, :, None], r[:, None, :]
    leg_min, leg_max = pot.trio_leg_min[t], pot.trio_leg_max[t]
    eye = torch.eye(k, dtype=torch.bool, device=d.device)
    mask = (nbr3.mask[:, :, None] & nbr3.mask[:, None, :] & ~eye[None]
            & (ttype >= 0)
            & (r_cm >= leg_min[..., 0]) & (r_cm <= leg_max[..., 0])
            & (r_cn >= leg_min[..., 1]) & (r_cn <= leg_max[..., 1])
            & (r_mn >= leg_min[..., 2]) & (r_mn <= leg_max[..., 2]))
    n_cells = pot.trio_poly.shape[1:4]
    legs = []
    for leg, x in enumerate((r_cm.expand_as(r_mn), r_cn.expand_as(r_mn),
                             r_mn)):
        i = _interval_lookup(x, pot.trio_knots[t, leg], n_cells[leg])
        br = pot.trio_breaks[t, leg, i]
        legs.append((i, (x - br[..., 0]) * br[..., 1], br[..., 1]))
    (il, u, inv_l), (im, v, inv_m), (iw, w, inv_n) = legs
    value, d_du, d_dv, d_dw = tricubic_eval(pot.trio_poly[t, il, im, iw],
                                            u, v, w)
    zero = torch.zeros_like(value)
    return _trio_sums(nbr3, torch.where(mask, value, zero),
                      torch.where(mask, d_du * inv_l, zero),
                      torch.where(mask, d_dv * inv_m, zero),
                      torch.where(mask, d_dw * inv_n, zero),
                      d, r, d_mn, r_mn)


def compute_energy_forces(pot: FactorizedPotential, species, positions,
                          cell, nbr2: NeighborList,
                          nbr3: NeighborList = None, static: bool = True,
                          d2=None, d3=None):
    """Total energy, forces (N, 3) and the (3, 3) virial.  ``static``
    (the reference passes its ``PotentialStatic``) takes the per-type
    routes ``pair_contributions_fast`` and
    ``trio_contributions_factorized``; without it, ``pair_contributions``
    and the table route ``trio_contributions``.  ``d2`` / ``d3`` reuse
    displacement gathers of the lists."""
    pair = pair_contributions_fast if static else pair_contributions
    e2, forces, virial = pair(pot, species, positions, cell, nbr2, d=d2)
    energy = torch.sum(pot.offsets_1b[species]) + torch.sum(e2)
    if nbr3 is not None:
        trio = trio_contributions_factorized if static else trio_contributions
        e3, f3, w3 = trio(pot, species, positions, cell, nbr3, d=d3)
        energy = energy + torch.sum(e3)
        forces = forces + f3
        virial = virial + w3
    return energy, forces, virial
