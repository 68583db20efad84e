"""
The fitted potential on device: ``UF3Potential`` holds the factorized
tables of any model (``ops/factorized.py``) and, where the model has
them, the closed-form pair spline and the dense 3-body coefficient
grid with its static sparsity that the fused kernels read, or the
per-type tables of the fused multi-species route (``ops/multi.py``),
with the 1-body offsets, as buffers of one ``nn.Module``.

Counterpart of ``build_pair_fast`` / ``build_trio_pallas`` /
``build_trio_multi`` / ``build_pair_multi``
(``uf3_tpu/ops/pallas_trio.py``) and of the engine's
``build_potential`` call (``uf3_tpu/forcefield/md.py``); with the Voigt
helpers of the virial (``VOIGT_AB``, ``stress_voigt``, the engine's
``_voigt6_to_matrix``).
"""

from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch import nn

from uf3_tpu_torch import io
from uf3_tpu_torch.ops.factorized import FactorizedPotential, params_from_model
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
    ok, spec = leg_spec_from_knots(config.knots_map[pair], exact=True)
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
    ok_l, spec_l = leg_spec_from_knots(seqs[0], exact=True)
    ok_n, spec_n = leg_spec_from_knots(seqs[2], exact=True)
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


def type_sparsity(grid: np.ndarray):
    """(active_bc, window) of a dense (L, M, NC) grid: the (b, c) blocks
    with a non-zero G[:, b, c] column and the live spans (l_lo, l_hi,
    b_lo, b_hi, c_lo, c_hi); the whole grid when nothing is live."""
    alive = ~np.all(grid == 0.0, axis=0)           # (M, NC)
    active_bc = tuple(
        (b, tuple(int(c) for c in np.nonzero(alive[b])[0]))
        for b in range(grid.shape[1]) if alive[b].any())
    if not active_bc:
        return active_bc, (0, grid.shape[0], 0, grid.shape[1], 0,
                           grid.shape[2])
    l_alive = np.nonzero(~np.all(grid == 0.0, axis=(1, 2)))[0]
    bs = [b for b, _ in active_bc]
    cs = [c for _, cl in active_bc for c in cl]
    return active_bc, (int(l_alive.min()), int(l_alive.max()) + 1,
                       int(min(bs)), int(max(bs)) + 1,
                       int(min(cs)), int(max(cs)) + 1)


def grid_sparsity(grid: np.ndarray):
    """Static sparsity of a dense (L, L, NC) grid: the (b, c) blocks
    with a non-zero G[:, b, c] column, the live window (w_lo, w_hi,
    c_lo, c_hi) of the first two legs together and whether G[l, b, c]
    == G[b, l, c].  Trimmed and symmetry-dead coefficients are exact
    zeros, so skipping the dead blocks is exact."""
    active_bc, (l_lo, l_hi, b_lo, b_hi, c_lo, c_hi) = type_sparsity(grid)
    window = (min(l_lo, b_lo), max(l_hi, b_hi), c_lo, c_hi)
    symmetric = bool(np.array_equal(grid, grid.transpose(1, 0, 2)))
    return active_bc, window, symmetric


def _leg_spec(spec) -> LegSpec:
    """A LegSpec from any object with LegSpec's fields."""
    return LegSpec(*(getattr(spec, f) for f in LegSpec._fields))


class _Tables(nn.Module):
    """Buffers of the multi-species route: of one trio or pair type, or
    the trio kernel's packed metadata."""

    def __init__(self, **tensors):
        super().__init__()
        for name, tensor in tensors.items():
            self.register_buffer(name, tensor)


class UF3Potential(nn.Module):
    """The fitted potential on device: ``factorized``, the reference's
    general tables of any model (a ``FactorizedPotential``, or None
    where only the closed-form pieces were given), and the pieces of the
    fused kernels where the model has them.

    Closed-form pieces: ``pair_spec`` with the ``pair_coefficients``
    buffer (n_basis_pair,) for a single pair spline with closed-form
    knots, and for the single symmetric-leg trio of a unary 2+3-body
    model ``trio`` (a TrioBundle whose ``grid`` is the float64 numpy
    source) with the buffers ``grid`` (L, L, NC), its live
    ``grid_window`` (Ww, Ww, Cw) and the legs' Horner ``leg_tables``
    (n_int_l + n_int_n, 20); each None where the model has no such
    piece.  The fused multi-species route (a model with no such pieces
    whose knots all have a closed form): ``trio_multi`` (a ``TrioMulti``
    of host descs and float64 grids) with ``trio_types``, per ordered
    type the buffer ``grid`` (L, M, NC) of the plain version, the
    multi-species trio kernel's metadata ``trio_packed`` (buffers ``ints``, ``reals``,
    ``tables``, ``grids`` of ``ops.multi.pack_trio_multi``) with
    ``trio_multi_plan`` (S, widest Bw * Cw), and ``pair_multi`` (a
    ``PairMulti``) with ``pair_types``, per pair type its
    ``coefficients``, and the int64 (S, S) ``pair_type`` table; None and
    empty where the model has no such route.  Always: ``offsets_1b``
    (S,), the int64 ``z_to_species`` map, ``r_cut_2b`` and ``r_cut_3b``
    (0 without a 3-body term)."""

    def __init__(self, pair_spec: LegSpec, pair_coefficients,
                 trio: TrioBundle, offsets_1b, z_to_species,
                 r_cut_2b: float, r_cut_3b: float,
                 dtype=torch.float64, device=None, factorized=None,
                 trio_multi=None, pair_multi=None):
        super().__init__()
        self.pair_spec = pair_spec
        self.trio = trio
        self.r_cut_2b = float(r_cut_2b)
        self.r_cut_3b = float(r_cut_3b)

        def buf(x, dt=dtype):
            return torch.tensor(np.asarray(x), dtype=dt, device=device)

        self._multi_buffers(trio_multi, pair_multi, buf,
                            len(np.asarray(offsets_1b)))

        self.register_buffer("pair_coefficients", None if pair_spec is None
                             else buf(pair_coefficients))
        if trio is None:
            for name in ("grid", "grid_window", "leg_tables"):
                self.register_buffer(name, None)
        else:
            self.register_buffer("grid", buf(trio.grid))
            # trio kernel operands: the live window of the grid (dead
            # (b, c) blocks in it are exact zeros) and the Horner tables
            # of the first leg's intervals, then the third leg's
            w_lo, w_hi, c_lo, c_hi = trio.window
            self.register_buffer("grid_window", buf(np.ascontiguousarray(
                trio.grid[w_lo:w_hi, w_lo:w_hi, c_lo:c_hi])))
            self.register_buffer("leg_tables", buf(np.concatenate(
                [horner_table(trio.spec_l), horner_table(trio.spec_n)])))
        self.register_buffer("offsets_1b", buf(offsets_1b))
        self.register_buffer("z_to_species",
                             buf(z_to_species, torch.int64))
        self.factorized = None if factorized is None \
            else factorized.to(device=device, dtype=dtype)

    def _multi_buffers(self, trio_multi, pair_multi, buf, n_species):
        """The multi-species route's host bundles and device tables: per
        type and, for the trio kernel, packed once over all types."""
        from uf3_tpu_torch.ops.multi import mirrored, pack_trio_multi
        self.trio_multi = trio_multi
        self.trio_packed = None
        self.trio_multi_plan = None
        if trio_multi is not None:
            pack = pack_trio_multi(trio_multi.descs, trio_multi.grids,
                                   n_species)
            self.trio_packed = _Tables(
                ints=buf(pack.ints, torch.int32), reals=buf(pack.reals),
                tables=buf(pack.tables), grids=buf(pack.grids))
            self.trio_multi_plan = (pack.n_species, pack.max_cols)
        self.pair_multi = pair_multi
        self.trio_multi_mirrored = trio_multi is not None and mirrored(
            trio_multi.descs, trio_multi.grids)
        self.trio_types = nn.ModuleList(
            _Tables(grid=buf(grid)) for grid in
            (trio_multi.grids if trio_multi is not None else ()))
        self.pair_types = nn.ModuleList(
            _Tables(coefficients=buf(c)) for c in
            (pair_multi.coefficients if pair_multi is not None else ()))
        self.register_buffer("pair_type", None if pair_multi is None
                             else buf(pair_multi.pair_type, torch.int64))

    @property
    def degree(self) -> int:
        """3 with a 3-body term, else 2."""
        return 3 if self.r_cut_3b > 0 else 2

    @classmethod
    def from_json(cls, filename: str, dtype=torch.float64, device=None):
        """Load a fitted model JSON (no pandas, no jax)."""
        return cls.from_model(io.load_model(filename), dtype=dtype,
                              device=device)

    @classmethod
    def from_model(cls, model, dtype=torch.float64, device=None):
        """From a fitted model (``io.load_model``'s, or any object with
        ``bspline_config`` and ``coefficients``): the factorized tables
        always, the closed-form pieces where the model has them, and
        where it has none of them (a multi-species model, or one whose
        pair or trio misses the unary fused form) the multi-species
        route's, where its knots have a closed form."""
        # imported here: ops/multi.py imports the force modules, which
        # import this one
        from uf3_tpu_torch.ops.multi import build_pair_multi, \
            build_trio_multi
        tables, n_pairs, trio_specs, r_cut_2b, r_cut_3b = \
            params_from_model(model)
        factorized = FactorizedPotential(tables, n_pairs, trio_specs,
                                         r_cut_2b, r_cut_3b)
        config = model.bspline_config
        coefficients = model.coefficients
        pair = build_pair_fast(config, coefficients)
        trio = build_trio_bundle(config, coefficients)
        trio_multi = pair_multi = None
        if trio is None or pair is None:
            trio_multi = build_trio_multi(config, coefficients)
            pair_multi = build_pair_multi(config, coefficients)
        return cls(*(pair or (None, None)), trio, tables["offsets_1b"],
                   tables["z_to_species"], r_cut_2b, r_cut_3b, dtype=dtype,
                   device=device, factorized=factorized,
                   trio_multi=trio_multi, pair_multi=pair_multi)

    @classmethod
    def from_factorized(cls, factorized: FactorizedPotential):
        """The factorized tables alone, in their dtype and on their
        device: no closed-form pieces."""
        return cls(None, None, None, factorized.offsets_1b.cpu().numpy(),
                   factorized.z_to_species.cpu().numpy(),
                   factorized.r_cut_2b, factorized.r_cut_3b,
                   dtype=factorized.offsets_1b.dtype,
                   device=factorized.offsets_1b.device,
                   factorized=factorized)

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

    @classmethod
    def from_jax_multi(cls, descs, grids, pair_multi, offsets_1b,
                       z_to_species, r_cut_2b: float, r_cut_3b: float,
                       dtype=torch.float64, device=None):
        """Weights converter of the JAX package's multi-species route:
        ``descs`` its ``TrioMulti.descs`` (or objects with
        ``TrioTypeDesc``'s fields), ``grids`` its ``TrioMulti.grids``,
        ``pair_multi`` its ``build_pair_multi`` tuple (specs,
        coefficients, pair-type table, ...), ``offsets_1b`` /
        ``z_to_species`` from ``PotentialParams``; arrays as numpy.
        Carries no factorized tables."""
        from uf3_tpu_torch.ops.multi import PairMulti, TrioMulti, \
            TrioTypeDesc
        trio_multi = TrioMulti(
            descs=tuple(TrioTypeDesc(
                spec_l1=_leg_spec(d.spec_l1), spec_l2=_leg_spec(d.spec_l2),
                spec_n=_leg_spec(d.spec_n), s_c=int(d.s_c), s_m=int(d.s_m),
                s_n=int(d.s_n), window=tuple(int(w) for w in d.window),
                active_bc=tuple((int(b), tuple(int(c) for c in cl))
                                for b, cl in d.active_bc))
                        for d in descs),
            grids=tuple(np.asarray(g, dtype=np.float64) for g in grids))
        specs, coefficients, pair_type = pair_multi[:3]
        pair = PairMulti(
            specs=tuple(_leg_spec(s) for s in specs),
            coefficients=tuple(np.asarray(c, dtype=np.float64)
                               for c in coefficients),
            pair_type=np.asarray(pair_type, dtype=np.int64))
        return cls(None, None, None, np.asarray(offsets_1b),
                   np.asarray(z_to_species, dtype=np.int64),
                   r_cut_2b, r_cut_3b, dtype=dtype, device=device,
                   trio_multi=trio_multi, pair_multi=pair)
