"""
Closed-form 2-body forces on padded neighbor rows, split by the C^2
r-RESPA switch: the short range S(r) V(r) on the compact 3-body rows
and the tail (1 - S(r)) V(r) on the full pair rows.

Counterpart of ``_pair_chain``, ``pair_short_forces``,
``pair_tail_forces`` and the pair virial of ``pair_trio_forces_shared``
(``uf3_tpu/ops/pallas_trio.py``).  Rows are
computed alone: every pair appears in both endpoints' rows, so
f_i = sum_j 2 V'(r_ij) d_ij / r_ij needs no cross-atom assembly.
"""

import torch
import torch.nn.functional as F

from uf3_tpu_torch.ops.neighbors import (ListCache, NeighborList,
                                         cached_displacements, list_cache)
from uf3_tpu_torch.ops.potential import VOIGT_AB
from uf3_tpu_torch.ops.splines import (LegSpec, _cardinal4, _deboor4,
                                       _leg_interval, _switch_poly)


def _pair_chain(r, spec: LegSpec, coefficients, n_basis: int):
    """Spline value/derivative of the pair term, un-masked: 4-tap
    cardinal blends (uniform knots) or de Boor, each tap's coefficient
    gathered at interval + tap.  Basis functions >= ``n_basis`` count
    as zero (the short-range window).  Returns (v_sum, dv_sum)."""
    if spec.cardinal:
        values, derivs, idx = _cardinal4(r, spec)
    else:
        idx = _leg_interval(spec, r)
        values, derivs = _deboor4(r, idx, spec)
    table = F.pad(coefficients[:n_basis], (0, spec.n_int + 3 - n_basis))
    v_sum = torch.zeros_like(r)
    dv_sum = torch.zeros_like(r)
    for tap in range(4):
        c_tap = table[idx + tap]
        v_sum = v_sum + values[tap] * c_tap
        dv_sum = dv_sum + derivs[tap] * c_tap
    return v_sum, dv_sum


def pair_row_forces(coefficients, d, valid, spec: LegSpec,
                    n_basis: int, with_energy: bool = True,
                    side: str = None, r_lo: float = 0.0,
                    r_hi: float = 0.0, with_virial: bool = False,
                    center_weight=None):
    """Pair energy and forces from displacement rows ``d`` (N, K, 3)
    with float mask ``valid`` (N, K).  ``side`` = "short" or "tail"
    keeps one side of the switch (with its V dS/dr force term); None
    keeps the whole pair term.  ``center_weight`` (N,) multiplies each
    row's mask (the halo path's owner weight: a row counts only where
    its center is owned), so energy, forces and virial are
    owner-weighted.  Returns (energy, forces (N, 3)), and with
    ``with_virial`` also the Voigt virial (6,) 1/2 sum w d_a d_b (each
    pair sits in both endpoints' rows)."""
    r2 = torch.sum(d * d, dim=-1)
    r = torch.sqrt(torch.where(r2 > 0, r2, torch.ones_like(r2)))
    valid2 = (valid * (r > spec.t_min).to(r.dtype)
              * (r < spec.t_max).to(r.dtype))
    if center_weight is not None:
        valid2 = valid2 * center_weight.to(r.dtype)[:, None]
    # the value chain is needed either way: the switched force carries
    # the V dS/dr term
    v2, dv2 = _pair_chain(r, spec, coefficients, n_basis)
    if side is not None:
        s, ds = _switch_poly(r, r_lo, r_hi)
        if side == "short":
            v2, dv2 = v2 * s, dv2 * s + v2 * ds
        else:
            v2, dv2 = v2 * (1.0 - s), dv2 * (1.0 - s) - v2 * ds
    energy = torch.sum(v2 * valid2) if with_energy \
        else torch.zeros((), dtype=r.dtype, device=r.device)
    w_pair = 2.0 * dv2 * valid2 / r
    forces = torch.sum(w_pair[..., None] * d, dim=1)
    if not with_virial:
        return energy, forces
    w_v = 0.5 * w_pair
    return energy, forces, torch.stack(
        [torch.sum(w_v * d[..., a] * d[..., b]) for a, b in VOIGT_AB])


# flop per lane (an FMA is 2), counted from the code above.  _pair_chain:
# the cardinal interval and fraction with f^2, f^3 (5), 4 values (20)
# and 4 derivatives (15); or de Boor's interval (3), its 8 knots (16)
# and the recursion (90); then 4 taps of two FMAs (16).  pair_row_forces:
# r (6), the support mask (2), the switch polynomial and its derivative
# (20), the side's products (short 4, tail 6), the energy (2), the force
# weight (3) and its sum into the row's force (6)
CHAIN_FLOP = {True: 5 + 20 + 15 + 16, False: 3 + 16 + 90 + 16}
SIDE_FLOP = {None: 0, "short": 20 + 4, "tail": 20 + 6}
ROW_FLOP = 6 + 2 + 3 + 6


def pair_flop(d, valid, spec: LegSpec, with_energy: bool = False,
              side: str = None, r_lo: float = 0.0, r_hi: float = 0.0):
    """The flop ``pair_row_forces`` does on the lanes of the rows ``d``
    (N, K, 3) that this data needs: the slots of ``valid`` whose r lies
    inside the spline's support and, with ``side``, where that side of
    the switch is not zero (S vanishes from r_hi on, 1 - S up to r_lo).
    Returns (flop, live lanes)."""
    r = torch.sqrt(torch.sum(d.double() ** 2, dim=-1))
    live = (valid != 0) & (r > spec.t_min) & (r < spec.t_max)
    if side == "short":
        live &= r < r_hi
    elif side == "tail":
        live &= r > r_lo
    lanes = int(live.sum())
    per_lane = (CHAIN_FLOP[bool(spec.cardinal)] + SIDE_FLOP[side] + ROW_FLOP
                + 2 * int(with_energy))
    return float(per_lane * lanes), lanes


def pair_short_forces(pair_coefficients, positions, cell,
                      nbr3: NeighborList, spec_pair: LegSpec = None,
                      n_basis_pair: int = 0, with_energy: bool = True,
                      r_lo: float = 0.0, r_hi: float = 0.0,
                      cache3: ListCache = None, center_weight=None):
    """Innermost r-RESPA force: S(r) V(r) on the 3-body list's rows.
    Returns (e_short, forces (N, 3), d) with the displacement rows d
    (N, K3, 3), which the trio force at the same positions reuses."""
    if cache3 is None:
        cache3 = list_cache(nbr3, cell, positions.dtype)
    d = cached_displacements(positions, nbr3, cache3)
    e, f = pair_row_forces(pair_coefficients, d, cache3.valid, spec_pair,
                           n_basis_pair, with_energy, "short", r_lo, r_hi,
                           center_weight=center_weight)
    return e, f, d


def pair_tail_forces(pair_coefficients, positions, cell,
                     nbr2: NeighborList, spec_pair: LegSpec = None,
                     n_basis_pair: int = 0, with_energy: bool = True,
                     r_lo: float = 0.0, r_hi: float = 0.0,
                     cache2: ListCache = None, center_weight=None):
    """Outer r-RESPA force: (1 - S(r)) V(r) on the full pair rows.
    Returns (e_tail, forces (N, 3))."""
    if cache2 is None:
        cache2 = list_cache(nbr2, cell, positions.dtype)
    d = cached_displacements(positions, nbr2, cache2)
    return pair_row_forces(pair_coefficients, d, cache2.valid, spec_pair,
                           n_basis_pair, with_energy, "tail", r_lo, r_hi,
                           center_weight=center_weight)
