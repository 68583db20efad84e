"""
The fitted potential on device: ``UF3Potential`` holds the closed-form
pair spline, the dense 3-body coefficient grid with its static
sparsity, and the 1-body offsets as buffers of one ``nn.Module``.

Counterpart of ``build_pair_fast`` / ``build_trio_pallas``
(``uf3_tpu/ops/pallas_trio.py``) and of the offsets, species map and
cutoffs of ``params_from_model`` (``uf3_tpu/ops/potential.py``), for
unary models whose knots have a closed form -- the models the fused MD
path runs; with the Voigt helpers of the virial (``VOIGT_AB``,
``stress_voigt``, the engine's ``_voigt6_to_matrix``).
"""

from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch import nn

from uf3_tpu_torch import io
from uf3_tpu_torch.data import elements
from uf3_tpu_torch.ops.splines import (LINEAR, LegSpec,
                                       cardinal_coefficients, horner_table,
                                       leg_spec_from_knots)


# Voigt order (xx, yy, zz, yz, xz, xy) of the virial and stress
VOIGT_AB = ((0, 0), (1, 1), (2, 2), (1, 2), (0, 2), (0, 1))


def voigt6_to_matrix(v6):
    """Symmetric (3, 3) tensor from its Voigt 6-vector."""
    return torch.stack([torch.stack([v6[0], v6[5], v6[4]]),
                        torch.stack([v6[5], v6[1], v6[3]]),
                        torch.stack([v6[4], v6[3], v6[2]])])


def stress_voigt(virial, volume):
    """Voigt stress (xx, yy, zz, yz, xz, xy) from the (3, 3) virial."""
    sigma = virial / volume
    return torch.stack([sigma[a, b] for a, b in VOIGT_AB])


class TrioBundle(NamedTuple):
    """Closed-form leg specs, the dense grid and its static sparsity."""
    spec_l: LegSpec          # first two legs (shared)
    spec_n: LegSpec          # third leg
    grid: np.ndarray         # (L, L, NC) float64
    l_basis: int
    n_basis: int
    active_bc: Tuple         # ((b, (c, ...)), ...) live blocks
    window: Tuple            # (w_lo, w_hi, c_lo, c_hi) live span
    symmetric: bool          # grid[l, b, c] == grid[b, l, c]


def build_pair_fast(config, coefficients):
    """(LegSpec, coefficients) of the closed-form pair spline, in the
    cardinal basis for uniform knots; None for multi-pair models or
    knots with no closed form."""
    pairs = config.interactions_map[2]
    if len(pairs) != 1:
        return None
    pair = pairs[0]
    ok, spec = leg_spec_from_knots(config.knots_map[pair])
    if not ok:
        return None
    sizes, offsets = config.get_interaction_partitions()
    coefficients = np.asarray(
        coefficients[offsets[pair]:offsets[pair] + sizes[pair]],
        dtype=np.float64)
    if spec.kind == LINEAR:
        uc = cardinal_coefficients(config.knots_map[pair], coefficients)
        if uc is not None:
            return spec._replace(cardinal=True), uc
    return spec, coefficients


def build_trio_bundle(config, coefficients):
    """Leg specs + dense grid of the single symmetric trio, with the
    live (b, c) blocks and window; None when not eligible.  The legs
    stay in the clamped basis: a cardinal re-expression would densify
    the grid's zero pattern."""
    if config.degree <= 2:
        return None
    trios = config.interactions_map[3]
    if len(trios) != 1:
        return None
    trio = trios[0]
    seqs = [np.asarray(s, dtype=np.float64)
            for s in config.knots_map[trio]]
    if not np.array_equal(seqs[0], seqs[1]):
        return None
    ok_l, spec_l = leg_spec_from_knots(seqs[0])
    ok_n, spec_n = leg_spec_from_knots(seqs[2])
    if not (ok_l and ok_n):
        return None
    solutions = io.arrange_coefficients(coefficients, config)
    grid = np.asarray(config.decompress_3B(solutions[trio], trio),
                      dtype=np.float64)
    active_bc, window, symmetric = grid_sparsity(grid)
    return TrioBundle(spec_l=spec_l, spec_n=spec_n, grid=grid,
                      l_basis=grid.shape[0], n_basis=grid.shape[2],
                      active_bc=active_bc, window=window,
                      symmetric=symmetric)


def grid_sparsity(grid: np.ndarray):
    """Static sparsity of a dense (L, L, NC) grid: the (b, c) blocks
    with a non-zero G[:, b, c] column, the live window (w_lo, w_hi,
    c_lo, c_hi) and whether G[l, b, c] == G[b, l, c].  Trimmed and
    symmetry-dead coefficients are exact zeros, so skipping the dead
    blocks is exact."""
    alive = ~np.all(grid == 0.0, axis=0)           # (M, NC)
    active_bc = tuple(
        (b, tuple(int(c) for c in np.nonzero(alive[b])[0]))
        for b in range(grid.shape[1]) if alive[b].any())
    if active_bc:
        l_alive = np.nonzero(~np.all(grid == 0.0, axis=(1, 2)))[0]
        bs = [b for b, _ in active_bc]
        cs = [c for _, cl in active_bc for c in cl]
        w_lo = int(min(l_alive.min(), min(bs)))
        w_hi = int(max(l_alive.max(), max(bs))) + 1
        window = (w_lo, w_hi, int(min(cs)), int(max(cs)) + 1)
    else:
        window = (0, grid.shape[0], 0, grid.shape[2])
    symmetric = bool(np.array_equal(grid, grid.transpose(1, 0, 2)))
    return active_bc, window, symmetric


def _leg_spec(spec) -> LegSpec:
    """A LegSpec from any object with LegSpec's fields."""
    return LegSpec(*(getattr(spec, f) for f in LegSpec._fields))


class UF3Potential(nn.Module):
    """Unary 2+3-body UF3 potential with closed-form knots.

    Buffers: ``pair_coefficients`` (n_basis_pair,), ``grid`` (L, L, NC)
    with its live ``grid_window`` (Ww, Ww, Cw), the trio legs' Horner
    ``leg_tables`` (n_int_l + n_int_n, 20), ``offsets_1b`` (S,) and the
    int64 ``z_to_species`` map.
    Static attributes: ``pair_spec``, ``trio`` (a TrioBundle whose
    ``grid`` is the float64 numpy source), ``r_cut_2b``, ``r_cut_3b``."""

    def __init__(self, pair_spec: LegSpec, pair_coefficients,
                 trio: TrioBundle, offsets_1b, z_to_species,
                 r_cut_2b: float, r_cut_3b: float,
                 dtype=torch.float64, device=None):
        super().__init__()
        self.pair_spec = pair_spec
        self.trio = trio
        self.r_cut_2b = float(r_cut_2b)
        self.r_cut_3b = float(r_cut_3b)

        def buf(x, dt=dtype):
            return torch.tensor(np.asarray(x), dtype=dt, device=device)

        self.register_buffer("pair_coefficients", buf(pair_coefficients))
        self.register_buffer("grid", buf(trio.grid))
        # trio kernel operands: the live window of the grid (dead (b, c)
        # blocks in it are exact zeros) and the Horner tables of the
        # first leg's intervals, then the third leg's
        w_lo, w_hi, c_lo, c_hi = trio.window
        self.register_buffer("grid_window", buf(np.ascontiguousarray(
            trio.grid[w_lo:w_hi, w_lo:w_hi, c_lo:c_hi])))
        self.register_buffer("leg_tables", buf(np.concatenate(
            [horner_table(trio.spec_l), horner_table(trio.spec_n)])))
        self.register_buffer("offsets_1b", buf(offsets_1b))
        self.register_buffer("z_to_species",
                             buf(z_to_species, torch.int64))

    @classmethod
    def from_json(cls, filename: str, dtype=torch.float64, device=None):
        """Load a fitted model JSON (no pandas, no jax)."""
        model = io.load_model(filename)
        config = model.bspline_config
        element_list = list(config.element_list)
        if config.degree <= 2:
            raise NotImplementedError(
                "2-body-only models are not ported to uf3_tpu_torch yet "
                "(ROADMAP.md, modules still to port: 2-body-only models and "
                "a separately built 3-body list)")
        pair = build_pair_fast(config, model.coefficients)
        trio = build_trio_bundle(config, model.coefficients)
        if len(element_list) != 1 or pair is None or trio is None:
            raise NotImplementedError(
                "only unary 2+3-body models whose knots have a closed form "
                "are ported to uf3_tpu_torch yet (ROADMAP.md, modules still "
                "to port: multi-species and knots with no closed form)")
        z_list = [elements.atomic_numbers[el] for el in element_list]
        z_to_species = np.zeros(max(z_list) + 1, dtype=np.int64)
        for s, z in enumerate(z_list):
            z_to_species[z] = s
        solutions = io.arrange_coefficients(model.coefficients, config)
        offsets_1b = np.array([float(np.asarray(solutions[el]).flat[0])
                               for el in element_list])
        r_cut_2b = max(float(config.r_max_map[p])
                       for p in config.interactions_map[2])
        seqs = config.knots_map[config.interactions_map[3][0]]
        r_cut_3b = float(max(seqs[0][-1], seqs[1][-1]))
        return cls(pair[0], pair[1], trio, offsets_1b, z_to_species,
                   r_cut_2b, r_cut_3b, dtype=dtype, device=device)

    @classmethod
    def from_jax_arrays(cls, trio, pair, offsets_1b, z_to_species,
                        r_cut_2b: float, r_cut_3b: float,
                        dtype=torch.float64, device=None):
        """Weights converter from the JAX package's bundle: ``trio`` a
        ``TrioPallas`` (or any object with its fields), ``pair`` the
        ``build_pair_fast`` tuple, ``offsets_1b`` / ``z_to_species``
        from ``PotentialParams``; arrays as numpy."""
        bundle = TrioBundle(
            spec_l=_leg_spec(trio.spec_l), spec_n=_leg_spec(trio.spec_n),
            grid=np.asarray(trio.grid, dtype=np.float64),
            l_basis=int(trio.l_basis), n_basis=int(trio.n_basis),
            active_bc=tuple(trio.active_bc), window=tuple(trio.window),
            symmetric=bool(trio.symmetric))
        return cls(_leg_spec(pair[0]), np.asarray(pair[1]), bundle,
                   np.asarray(offsets_1b), np.asarray(z_to_species),
                   r_cut_2b, r_cut_3b, dtype=dtype, device=device)
