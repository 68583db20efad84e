"""
Molecular dynamics of a fitted UF3 potential in torch: plain velocity
Verlet, 2-level or 3-level r-RESPA, with one-tier or two-tier Verlet
skins, NVE, Langevin or Nose-Hoover; NPT on plain Verlet under Langevin
with the stochastic cell-rescaling or the Berendsen barostat, from the
analytic virial; neighbor capacities that regrow on overflow.

Counterpart of ``uf3_tpu/forcefield/md.py`` (``MDSystem.run`` and
``npt_run`` -> ``_run_chunk`` / ``_run_chunk_respa`` -> ``_verlet_step``,
``_respa_cycle``, ``_respa_cycle_3l``; ``energy_forces``,
``energy_forces_virial``, ``stress``).  The force takes the reference's
routes, in its order: a 2+3-body model without the unary fused pieces
whose knots all have a closed form (more than one species, as a rule)
runs the fused multi-species route (``ops/multi.py``: a pair chain per
pair type on one (N, K2) gather, the species-gated trio kernel once
per ordered trio type); a unary 2+3-body model with closed-form knots
runs the fused kernels, from one shared (N, K2) gather when its 3-body
list was filtered from the 2-body list, else ("separate") the pair
force and the trio kernel on their own gathers; every other model
(2-body only, knots with no closed form) runs the factorized path
(``ops/factorized.py``).  A model whose 3-body cutoff passes the 2-body
cutoff gets its own 3-body list, with reverse slots.

Three choices depart from the reference on purpose:
- every kinetic energy that feeds a thermostat or a barostat
  (Nose-Hoover, SCR and Berendsen) sums over mobile atoms only, where
  the reference's Nose-Hoover and Berendsen sums also count pinned
  atoms (ROADMAP.md section 3); without pinned atoms the two agree;
- a 3-body list built on its own carries reverse slots, which the
  reference's (``with_rev=False``) lacks, so that its neighbor forces
  are gathered from the right rows;
- each list's builder is checked against the cell at every full
  rebuild in a new cell (NPT), and chosen again where it would drop
  pairs (the reference fixes it at construction).

The neighbor builder follows the cell: a cell list for periodic boxes
of 512 atoms and 16 bins or more, explicit images for periodic cells
narrower than twice the cutoff, otherwise the O(N^2) minimum-image
search (non-periodic clusters included).  Per rebuild cycle the lists
are refreshed on one of the reference's schedules: by default on the
host's decision (one sync), a full rebuild once half the 2-body skin
is used, else, with two-tier skins, a refilter of the 3-body list from
the 2-body list; with ``eager_refilter=False`` the refilter only once
0.4 of the 3-body skin is used (keep / refilter / full, one sync); with
``static_rebuild`` a full rebuild every cycle, with no decision.  Each
launch's overflow flag goes to the host without a wait
(``run(sync=False)``).  The 3-body force of the fused routes runs
through the trio kernel on the card; ``trio_triangle`` takes its
triangle lanes where the model's grid is symmetric in its first two
legs, as the reference's option does.
"""

import copy
import math
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from uf3_tpu_torch.data import elements
from uf3_tpu_torch.data.atoms import Atoms
from uf3_tpu_torch.forcefield import units
from uf3_tpu_torch.ops import neighbors as nb
from uf3_tpu_torch.ops.factorized import (FactorizedPotential,
                                          compute_energy_forces,
                                          pair_contributions_fast)
from uf3_tpu_torch.ops.multi import pair_forces_multi, trio_forces_multi
from uf3_tpu_torch.ops.pair import (pair_row_forces, pair_short_forces,
                                    pair_tail_forces)
from uf3_tpu_torch.ops.potential import (UF3Potential, stress_voigt,
                                         voigt6_to_matrix)
from uf3_tpu_torch.ops.splines import basis_window_hi
from uf3_tpu_torch.ops.trio import (pair_trio_forces_shared, trio_forces,
                                    trio_short_forces)

NPT_EXTRA = "barostats on r-RESPA and Nose-Hoover NPT"
MULTI_RESPA = "r-RESPA on the multi-species route"
MAX_NPT_REGROWS = 4


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to uf3_tpu_torch yet (ROADMAP.md, modules "
        f"still to port: {item})")


def _no_reference(what: str, item: str = NPT_EXTRA):
    return NotImplementedError(
        f"{what}: uf3_tpu has no such path to port (ROADMAP.md, modules "
        f"still to port: {item})")


def _resolve_device(device) -> torch.device:
    """The requested device, or the current CUDA card when none is
    named; never the CPU unless asked for."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("uf3_tpu_torch runs on the CUDA card by default "
                           "and this host has none; pass device=\"cpu\" to "
                           "run the plain torch version on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def _load(model) -> UF3Potential:
    """A private UF3Potential from a model JSON's path, a fitted model
    (``bspline_config`` and ``coefficients``), a UF3Potential or a
    FactorizedPotential."""
    if isinstance(model, UF3Potential):
        return copy.deepcopy(model)
    if isinstance(model, FactorizedPotential):
        return UF3Potential.from_factorized(copy.deepcopy(model))
    if hasattr(model, "bspline_config"):
        return UF3Potential.from_model(model)
    return UF3Potential.from_json(model)


def _volume(cell):
    """|det cell| as the triple product a . (b x c)."""
    return torch.abs(torch.dot(cell[0], torch.linalg.cross(cell[1], cell[2])))


# -- overflow flags on their way to the host ---------------------------------
def _queue_flag(flag):
    """A launch's overflow flag in flight to the host: on the card a
    non-blocking copy into pinned memory and an event recorded after it;
    on the CPU the flag itself."""
    if flag.device.type != "cuda":
        return flag, None
    host = torch.empty((), dtype=torch.bool, pin_memory=True)
    host.copy_(flag, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(flag.device))
    return host, event


def _flag_ready(entry) -> bool:
    """Whether a queued flag has reached the host (no wait)."""
    return entry[1] is None or entry[1].query()


def _flag_value(entry) -> bool:
    """A queued flag's value, waiting for its copy if it is in flight."""
    if entry[1] is not None:
        entry[1].synchronize()
    return bool(entry[0])


def _report_overflow(on_overflow: str):
    message = ("neighbor capacity exceeded during MD: pairs were dropped "
               "at a rebuild (farthest-first for the O(N^2) builders, "
               "stencil order for the cell list); increase "
               "capacity_2b/capacity_3b (or use on_overflow='regrow')")
    if on_overflow == "warn":
        warnings.warn(message)
    else:
        raise RuntimeError(message)


class SCR(NamedTuple):
    """Constants of the stochastic cell-rescaling barostat [Bernetti &
    Bussi, J. Chem. Phys. 153, 114107 (2020)]."""
    pressure: float  # target, eV / A^3
    tau_p: float     # coupling time, internal units
    beta_t: float    # isothermal compressibility, A^3 / eV


class MDState(NamedTuple):
    positions: torch.Tensor   # (N, 3)
    velocities: torch.Tensor  # (N, 3) internal units
    forces: torch.Tensor      # (N, 3) eV / A
    energy: torch.Tensor      # () potential energy, eV
    nbr2: nb.NeighborList
    nbr3: Optional[nb.NeighborList]  # None for a 2-body-only model
    generator: torch.Generator  # Langevin and SCR noise stream
    xi: torch.Tensor          # () Nose-Hoover thermostat momentum
    stale: torch.Tensor       # () bool: a skin was exceeded
    cell: torch.Tensor        # (3, 3)
    f_short: torch.Tensor = None  # r-RESPA split forces at `positions`,
    f_tail: torch.Tensor = None   # carried across cycles: short range
    f_mid: torch.Tensor = None    # (pair + 3-body, or pair only with a
    #   mid level), pair tail, 3-body (3-level only); None after plain
    #   Verlet steps, so that the next r-RESPA launch recomputes them


class MDSystem:
    """Binds a fitted potential to a configuration for device MD.

    ``model`` is the path of a model JSON, a fitted model (an object
    with ``bspline_config`` and ``coefficients``, as ``io.load_model``
    returns), a ``UF3Potential`` or a ``FactorizedPotential`` (which
    runs the factorized route alone); ``atoms`` any object with the
    reader methods of ``uf3_tpu_torch.data.atoms.Atoms``.  ``fused``
    chooses the route of a model with fused kernels: "shared" (one
    (N, K2) gather) or "separate"; ``trio_triangle`` runs the trio
    kernel's triangle lanes where the grid is symmetric in its first two
    legs (opt-in, as in the reference).  ``static_rebuild`` rebuilds the
    lists in full every cycle; ``eager_refilter=False`` refilters the
    3-body list of two-tier skins only once 0.4 of its skin is used.
    ``device`` defaults to the CUDA card and raises where there is
    none: a CPU run (the plain torch twins of the kernels) passes
    ``device="cpu"``.  ``rebuild_branches`` counts the cycles that kept
    the lists, refiltered the 3-body list or rebuilt them in full."""

    def __init__(self, model, atoms: Atoms, dtype=torch.float32,
                 capacity_2b: int = None, capacity_3b: int = None,
                 skin: float = 0.5, skin_2b: float = None,
                 rebuild_every: int = 20, n_respa: int = 1,
                 respa_mid: int = 1, respa_switch: tuple = None,
                 fused: str = "shared", trio_triangle: bool = False,
                 eager_refilter: bool = True,
                 static_rebuild: bool = False,
                 masses: np.ndarray = None, device=None):
        self.device = _resolve_device(device)
        self.dtype = dtype
        self.potential = _load(model).to(device=self.device, dtype=dtype)
        if fused not in ("shared", "separate"):
            raise ValueError("fused must be 'separate' or 'shared'")
        self.fused = fused
        # the triangle-lane trio layout: on a symmetric unary grid only,
        # as in the reference (the other routes ignore it)
        self.triangle = (bool(trio_triangle)
                         and self.potential.trio is not None
                         and self.potential.trio.symmetric)
        self.static_rebuild = bool(static_rebuild)
        self.eager_refilter = bool(eager_refilter)
        self.rebuild_branches = dict(keep=0, refilter=0, full=0)
        self.skin = float(skin)
        self.skin_2b = float(skin_2b) if skin_2b is not None else self.skin
        self.rebuild_every = int(rebuild_every)
        self.degree = self.potential.degree
        self.r_cut_2b = self.potential.r_cut_2b
        self.r_cut_3b = self.potential.r_cut_3b
        # a 3-body cutoff beyond the 2-body one: the 3-body list is built
        # on its own, at the same positions as the 2-body list
        self.separate_3b = self.degree > 2 and self.r_cut_3b > self.r_cut_2b
        # two-tier skins: a larger 2-body skin makes full rebuilds rare,
        # and the 3-body list is refiltered from it every cycle
        self.two_tier = (self.skin_2b > self.skin and self.degree > 2
                         and not self.separate_3b)
        # the skin the rebuild trigger and the staleness flag read: a
        # separately built 3-body list shares the 2-body list's build
        # positions, so the smaller of the two skins binds
        self._list_skin = min(self.skin, self.skin_2b) if self.separate_3b \
            else self.skin_2b
        self.n_respa = int(n_respa)
        self.respa_mid = int(respa_mid)
        if self.respa_mid > 1 and self.n_respa <= 1:
            raise ValueError("respa_mid > 1 requires n_respa > 1")
        self.respa_switch = None
        self.n_basis_short = None
        if self.n_respa > 1:
            self._respa_setup(respa_switch)
        numbers = np.asarray(atoms.get_atomic_numbers())
        self.atomic_numbers = numbers
        z_map = self.potential.z_to_species.cpu().numpy()
        self.species = torch.as_tensor(z_map[numbers], device=self.device)
        m_host = np.asarray(elements.atomic_masses[numbers] if masses is None
                            else masses, dtype=np.float64)
        self.masses = torch.as_tensor(m_host, dtype=dtype,
                                      device=self.device)
        # effectively-infinite masses pin atoms: temperature counts only
        # mobile degrees of freedom
        self.n_mobile = int(np.sum(m_host < 1e9))
        self.dof = max(1, 3 * self.n_mobile
                       - (3 if self.n_mobile == len(atoms) else 0))
        self.mobile_mask = None if self.n_mobile == len(atoms) \
            else torch.as_tensor(m_host < 1e9, device=self.device)
        self.cell = torch.as_tensor(np.asarray(atoms.get_cell()),
                                    dtype=dtype, device=self.device)
        self.pbc = tuple(bool(p) for p in atoms.get_pbc())
        n_atoms = len(atoms)
        # a cluster's capacity is sized as if it sat in 1e6 A^3
        volume = atoms.get_volume() if any(self.pbc) else 1e6
        self.capacity_2b = capacity_2b or nb.estimate_capacity(
            n_atoms, volume, self.r_cut_2b + self.skin_2b)
        self.capacity_3b = (capacity_3b or nb.estimate_capacity(
            n_atoms, volume, self.r_cut_3b + self.skin)) \
            if self.degree > 2 else 0
        self._positions0 = torch.as_tensor(atoms.get_positions(),
                                           dtype=dtype, device=self.device)
        # each list's builder (images per axis, cell-list geometry), for
        # the cell it was chosen in
        positions, cell = atoms.get_positions(), atoms.get_cell()
        self._images_2b, self._cells_2b = self._list_geometry(
            positions, cell, self.r_cut_2b + self.skin_2b)
        self._images_3b = self._cells_3b = None
        if self.separate_3b:
            self._images_3b, self._cells_3b = self._list_geometry(
                positions, cell, self.r_cut_3b + self.skin)
        self._geometry_cell = self.cell
        # per-launch overflow flags not yet read on the host
        self._pending_overflow = []

    def _respa_setup(self, respa_switch):
        """Validate the r-RESPA cadence and switch band; set the short
        force's basis window."""
        if not (self.degree > 2 and self.r_cut_3b <= self.r_cut_2b):
            raise ValueError("n_respa > 1 requires a 2+3-body model with "
                             "r_cut_3b <= r_cut_2b")
        if self._multi_route():
            # the reference's r-RESPA split unpacks the unary pair spline
            # (pair_fast), which a multi-species model does not have
            raise _no_reference("n_respa > 1 on a multi-species model",
                                MULTI_RESPA)
        if self.potential.trio is None or self.potential.pair_spec is None:
            raise ValueError("n_respa > 1 runs on the fused kernels, as in "
                             "uf3_tpu: it requires a unary 2+3-body model "
                             "whose knots have a closed form")
        if respa_switch is None:
            respa_switch = (self.r_cut_3b - 0.5, self.r_cut_3b)
        if respa_switch[1] > self.r_cut_3b + 1e-9:
            raise ValueError("respa_switch upper radius must not exceed "
                             "r_cut_3b")
        if not respa_switch[0] < respa_switch[1]:
            raise ValueError("respa_switch must satisfy r_lo < r_hi (got "
                             f"{respa_switch})")
        if self.n_respa > self.rebuild_every:
            raise ValueError("n_respa must not exceed rebuild_every "
                             f"(n_respa={self.n_respa}, "
                             f"rebuild_every={self.rebuild_every})")
        if self.n_respa % self.respa_mid != 0:
            raise ValueError("n_respa must be a multiple of respa_mid "
                             f"(got n_respa={self.n_respa}, "
                             f"respa_mid={self.respa_mid})")
        self.respa_switch = tuple(float(r) for r in respa_switch)
        # S(r) V(r) vanishes for r >= r_hi: the short-range coefficient
        # selection stops at interval(r_hi) + 4 basis functions
        self.n_basis_short = basis_window_hi(self.potential.pair_spec,
                                             self.respa_switch[1])

    # -- neighbor geometry ----------------------------------------------------
    @staticmethod
    def _cell_list_geometry(positions, cell, pbc, r_cut):
        """(grid shape, bin capacity, bin topology) of a cell list at
        ``r_cut`` for these numpy positions and cell, or None where the
        O(N^2) or images builders serve (no periodic axis, fewer than
        512 atoms or 16 bins)."""
        if not np.any(pbc) or len(positions) < 512:
            return None
        grid_shape = nb.grid_shape_for(cell, r_cut, pbc)
        n_bins = int(np.prod(grid_shape))
        if n_bins < 16:
            return None
        # size bins from the measured occupancy, not the mean: lattice
        # planes aligned with bin boundaries put up to ~1.8x the mean in
        # one bin.  An atom on a bin face may fall on either side of it
        # once the builder recomputes its fractional coordinate in
        # float32 (bcc W at 8^3 or 10^3 overflowed so), so it counts in
        # every bin within 1e-5 of it
        frac = np.asarray(positions) @ np.linalg.inv(cell)
        frac = frac - np.floor(frac)
        dims = np.asarray(grid_shape)
        sides = [np.floor((frac + eps) * dims).astype(int) % dims
                 for eps in (-1e-5, 1e-5)]
        ids = np.stack([(sides[i][:, 0] * dims[1] + sides[j][:, 1])
                        * dims[2] + sides[k][:, 2]
                        for i in (0, 1) for j in (0, 1) for k in (0, 1)],
                       axis=1)
        ids = np.sort(ids, axis=1)
        first = np.concatenate([np.ones((len(ids), 1), dtype=bool),
                                ids[:, 1:] != ids[:, :-1]], axis=1)
        occ = np.bincount(ids[first], minlength=n_bins).max()
        bin_capacity = max(8, int(np.ceil(occ * 1.3)) + 2)
        topology = nb.bin_topology(grid_shape, pbc)
        return grid_shape, bin_capacity, topology

    def _list_geometry(self, positions, cell, r_cut):
        """(images, cells) of one list's builder in this cell: explicit
        images per axis where a periodic width is below 2 ``r_cut`` (else
        None), and the cell-list geometry (or None); the builder takes
        the cell list where there is one."""
        images = None
        if any(self.pbc):
            req = nb.images_required(cell, self.pbc, r_cut)
            if max(req) > 0:
                images = tuple(max(1, r) if p else 0
                               for r, p in zip(req, self.pbc))
        return images, self._cell_list_geometry(positions, cell, self.pbc,
                                                r_cut)

    def _builder_exact(self, cell, r_cut, images, cells) -> bool:
        """Whether a list's builder finds every pair within ``r_cut`` in
        this (numpy) cell: cell-list bins at least ``r_cut`` wide, or
        enough periodic images."""
        if cells is not None:
            return all(now >= was for now, was in zip(
                nb.grid_shape_for(cell, r_cut, self.pbc), cells[0]))
        have = images or (0, 0, 0)
        return all(need <= h for need, h in
                   zip(nb.images_required(cell, self.pbc, r_cut), have))

    def _fit_geometry(self, positions, cell):
        """Port-only guard at a full rebuild in a cell the builders were
        not chosen for (NPT): keep each list's builder while it stays
        exact, and choose it again from this cell and these positions,
        as at construction, where it would drop pairs.  A cell with no
        finite positive volume raises (one host read of the cell)."""
        if cell is self._geometry_cell or not any(self.pbc):
            return
        self._geometry_cell = cell
        cell_np = cell.detach().double().cpu().numpy()
        if not (np.isfinite(cell_np).all()
                and abs(np.linalg.det(cell_np)) > 0):
            raise RuntimeError(f"no neighbor list fits the cell {cell_np}: "
                               "it has no finite positive volume")
        lists = [("_2b", self.r_cut_2b + self.skin_2b)]
        if self.separate_3b:
            lists.append(("_3b", self.r_cut_3b + self.skin))
        positions_np = None
        for tag, r_cut in lists:
            images = getattr(self, "_images" + tag)
            cells = getattr(self, "_cells" + tag)
            if self._builder_exact(cell_np, r_cut, images, cells):
                continue
            if positions_np is None:
                positions_np = positions.detach().double().cpu().numpy()
            images, cells = self._list_geometry(positions_np, cell_np, r_cut)
            setattr(self, "_images" + tag, images)
            setattr(self, "_cells" + tag, cells)

    # -- neighbor construction ---------------------------------------------
    def _build(self, positions, cell, r_cut, capacity, images, cells):
        """One list by the builder this cell takes."""
        if cells is not None:
            grid_shape, bin_capacity, topology = cells
            return nb.build_neighbor_list_cells(
                positions, cell, self.pbc, r_cut, capacity, grid_shape,
                bin_capacity, topology)
        if images is not None:
            return nb.build_neighbor_list_images(
                positions, cell, self.pbc, r_cut, capacity, images=images)
        return nb.build_neighbor_list(positions, cell, self.pbc, r_cut,
                                      capacity)

    def build_lists(self, positions, cell=None):
        """(2-body list, 3-body list) for positions wrapped into the
        primary cell: the 3-body list filtered from the 2-body list, or
        built on its own (with reverse slots) when its cutoff is the
        larger; None for a 2-body-only model."""
        cell = self.cell if cell is None else cell
        self._fit_geometry(positions, cell)
        nbr2 = self._build(positions, cell, self.r_cut_2b + self.skin_2b,
                           self.capacity_2b, self._images_2b, self._cells_2b)
        if self.degree <= 2:
            return nbr2, None
        r_cut_3 = self.r_cut_3b + self.skin
        if self.separate_3b:
            return nbr2, nb.with_reverse_slots(self._build(
                positions, cell, r_cut_3, self.capacity_3b,
                self._images_3b, self._cells_3b))
        return nbr2, nb.filter_neighbor_list(nbr2, positions, cell, r_cut_3,
                                             self.capacity_3b)

    def _wrap(self, positions, cell):
        """Wrap into the primary cell (an exact lattice translation);
        a cluster stays as it is."""
        if not any(self.pbc):
            return positions
        return nb.wrap_positions(positions, cell, self.pbc)

    def _e1(self):
        return torch.sum(self.potential.offsets_1b[self.species])

    def _multi_route(self) -> bool:
        """Whether the model takes the fused multi-species route."""
        pot = self.potential
        return pot.trio_multi is not None and pot.pair_multi is not None \
            and self.degree > 2

    def list_caches(self, nbr2, nbr3, cell):
        """The lists' per-cycle invariants (``nb.list_cache``), with the
        species columns on the multi-species route."""
        species = pair_type = None
        if self._multi_route():
            species, pair_type = self.species, self.potential.pair_type
        cache2 = nb.list_cache(nbr2, cell, self.dtype, species, pair_type)
        cache3 = None if nbr3 is None \
            else nb.list_cache(nbr3, cell, self.dtype, species)
        return cache2, cache3

    def energy_forces(self, positions, nbr2, nbr3, cell=None,
                      with_energy: bool = True, with_virial: bool = False,
                      cache2=None, cache3=None):
        """Total energy, forces and, with ``with_virial``, the analytic
        (3, 3) virial (else None), by the model's route: the fused
        multi-species route or the shared gather (``with_energy=False``
        then skips the energy sums and the 1-body energy alone comes
        back), the separate gathers, or the factorized path (which
        always computes the energy).  ``cache2`` / ``cache3`` carry the
        lists' per-cycle invariants (``list_caches``)."""
        cell = self.cell if cell is None else cell
        pot = self.potential
        if self._multi_route() and nbr3 is not None:
            return self._multi_forces(positions, cell, nbr2, nbr3,
                                      with_energy, with_virial, cache2,
                                      cache3)
        if pot.trio is not None and nbr3 is not None:
            if pot.pair_spec is not None and nbr3.sel is not None \
                    and self.fused == "shared":
                e2, e3, forces, v6 = pair_trio_forces_shared(
                    pot, positions, cell, nbr2, nbr3, with_energy, cache2,
                    cache3, with_virial, self.triangle)
                virial = voigt6_to_matrix(v6) if with_virial else None
                return self._e1() + e2 + torch.sum(e3), forces, virial
            return self._separate_forces(positions, cell, nbr2, nbr3,
                                         with_energy, with_virial, cache2,
                                         cache3)
        d2 = None if cache2 is None \
            else nb.cached_displacements(positions, nbr2, cache2)
        d3 = None if cache3 is None or nbr3 is None \
            else nb.cached_displacements(positions, nbr3, cache3)
        energy, forces, virial = compute_energy_forces(
            self._factorized(), self.species, positions, cell, nbr2, nbr3,
            d2=d2, d3=d3)
        return energy, forces, virial if with_virial else None

    def _separate_forces(self, positions, cell, nbr2, nbr3, with_energy,
                         with_virial, cache2, cache3):
        """The pair force on its own (N, K2) gather (closed form, else
        the factorized pair path) and the trio kernel on its own (N, K3)
        gather of the 3-body list."""
        pot = self.potential
        if cache2 is None:
            cache2 = nb.list_cache(nbr2, cell, positions.dtype)
        d2 = nb.cached_displacements(positions, nbr2, cache2)
        if pot.pair_spec is not None:
            out2 = pair_row_forces(pot.pair_coefficients, d2, cache2.valid,
                                   pot.pair_spec, pot.pair_spec.n_basis,
                                   with_energy, with_virial=with_virial)
            e2, f2 = out2[0], out2[1]
            v2 = voigt6_to_matrix(out2[2]) if with_virial else None
        else:
            e2, f2, v2 = pair_contributions_fast(
                self._factorized(), self.species, positions, cell, nbr2,
                d=d2)
            e2 = torch.sum(e2)
        out3 = trio_forces(pot, positions, cell, nbr3, with_energy,
                           cache3=cache3, with_virial=with_virial,
                           triangle=self.triangle)
        virial = v2 + voigt6_to_matrix(out3[2]) if with_virial else None
        return self._e1() + e2 + torch.sum(out3[0]), f2 + out3[1], virial

    def _multi_forces(self, positions, cell, nbr2, nbr3, with_energy,
                      with_virial, cache2, cache3):
        """The fused multi-species route: the pair chain per pair type
        on one (N, K2) gather, the species-gated trio kernel per ordered
        trio type on the 3-body rows, one assembly."""
        pot = self.potential
        if cache2 is None or cache3 is None:
            cache2, cache3 = self.list_caches(nbr2, nbr3, cell)
        d2 = nb.cached_displacements(positions, nbr2, cache2)
        out2 = pair_forces_multi(
            [t.coefficients for t in pot.pair_types], pot.pair_multi.specs,
            d2, cache2, with_energy, with_virial)
        out3 = trio_forces_multi(pot, self.species, positions, nbr3, cache3,
                                 with_energy, with_virial)
        virial = voigt6_to_matrix(out2[2] + out3[2]) if with_virial \
            else None
        return (self._e1() + out2[0] + torch.sum(out3[0]),
                out2[1] + out3[1], virial)

    def _factorized(self) -> FactorizedPotential:
        if self.potential.factorized is None:
            raise ValueError("this potential carries no factorized tables "
                             "(built from the fused pieces alone)")
        return self.potential.factorized

    def energy_forces_virial(self, positions, nbr2, nbr3, cell=None):
        """Energy, forces and (3, 3) virial by the factorized path,
        whatever the model's route (the reference's oracle)."""
        cell = self.cell if cell is None else cell
        return compute_energy_forces(self._factorized(), self.species,
                                     positions, cell, nbr2, nbr3)

    # -- state setup --------------------------------------------------------
    def init_state(self, velocities: np.ndarray = None,
                   temperature: float = None, seed: int = 0) -> MDState:
        """Initial state: given velocities (an array or a tensor),
        Maxwell-Boltzmann velocities at ``temperature`` (zero total
        momentum) drawn from a generator seeded with ``seed`` -- which
        then drives the Langevin and SCR noise -- or zero velocities;
        the Nose-Hoover momentum starts at zero."""
        positions = self._wrap(self._positions0, self.cell)
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed)
        if velocities is None:
            if temperature is None:
                velocities = torch.zeros_like(positions)
            else:
                sigma = torch.sqrt(units.kB * temperature
                                   / self.masses)[:, None]
                velocities = sigma * torch.randn(
                    positions.shape, generator=generator, dtype=self.dtype,
                    device=self.device)
                velocities = velocities - torch.mean(velocities, dim=0)
        else:
            velocities = torch.as_tensor(velocities, dtype=self.dtype,
                                         device=self.device)
        nbr2, nbr3 = self.build_lists(positions)
        state = MDState(positions=positions, velocities=velocities,
                        forces=None, energy=None, nbr2=nbr2, nbr3=nbr3,
                        generator=generator,
                        xi=torch.zeros((), dtype=self.dtype,
                                       device=self.device),
                        stale=torch.zeros((), dtype=torch.bool,
                                          device=self.device),
                        cell=self.cell)
        if bool(self._overflow_flag(state)):
            raise ValueError(
                "neighbor capacity exceeded at initialization "
                f"(capacity_2b={self.capacity_2b}, "
                f"capacity_3b={self.capacity_3b}); increase capacities")
        energy, forces, _ = self.energy_forces(positions, nbr2, nbr3)
        return state._replace(forces=forces, energy=energy)

    # -- integrator ---------------------------------------------------------
    def _rebuild_switch(self, state: MDState):
        """Neighbor refresh at a cycle boundary.  With
        ``static_rebuild``: a full rebuild, no decision.  Otherwise a
        full rebuild once the two largest drifts since the 2-body build
        pass half its skin; else, with two-tier skins, a refilter of the
        3-body list from the 2-body list at the current positions (which
        resets the 3-body staleness reference) every cycle, or with
        ``eager_refilter=False`` only once its two largest drifts pass
        0.4 of the 3-body skin; with one tier the lists as they are.
        One host read of the decision.  Counts the branch in
        ``rebuild_branches``.  Returns (positions, nbr2, nbr3)."""
        cell = state.cell
        x = state.positions
        if self.static_rebuild:
            branch = "full"
        else:
            trigger = nb.needs_rebuild(state.nbr2, x, 0.5 * self._list_skin)
            if self.two_tier and not self.eager_refilter:
                lazy = nb.needs_rebuild(state.nbr3, x, 0.4 * self.skin)
                code = int(torch.where(trigger, 2, lazy.to(torch.int64)))
                branch = ("keep", "refilter", "full")[code]
            elif bool(trigger):
                branch = "full"
            else:
                branch = "refilter" if self.two_tier else "keep"
        self.rebuild_branches[branch] += 1
        if branch == "full":
            x_w = self._wrap(x, cell)
            nbr2, nbr3 = self.build_lists(x_w, cell)
            return x_w, nbr2, nbr3
        if branch == "keep":
            return x, state.nbr2, state.nbr3
        nbr3 = nb.filter_neighbor_list(
            state.nbr2, x, cell, self.r_cut_3b + self.skin,
            self.capacity_3b, reference_positions=x)
        return x, state.nbr2, nbr3

    def _cycle_lists(self, state: MDState):
        """``_rebuild_switch`` with the overflow flags accumulated
        across the cycles of one launch."""
        x, nbr2, nbr3 = self._rebuild_switch(state)
        nbr2 = nbr2._replace(overflow=nbr2.overflow | state.nbr2.overflow)
        if nbr3 is not None:
            nbr3 = nbr3._replace(overflow=nbr3.overflow
                                 | state.nbr3.overflow)
        return x, nbr2, nbr3

    def _stale(self, stale, nbr2, nbr3, x):
        """Sticky flag: a skin was outrun at positions ``x``."""
        stale = stale | nb.needs_rebuild(nbr2, x, self._list_skin)
        if self.two_tier:
            stale = stale | nb.needs_rebuild(nbr3, x, self.skin)
        return stale

    def _mobile_ke(self, v):
        """Kinetic energy (a 0-d tensor) of the mobile atoms: pinned
        atoms (effectively infinite masses) carry kT/2 per degree of
        freedom under Langevin at ~zero velocity and are left out."""
        if self.mobile_mask is not None:
            v = v * self.mobile_mask[:, None]
        return 0.5 * torch.sum(self.masses[:, None] * v * v)

    def _thermostat_fn(self, thermostat: Optional[str], dt: float,
                       temperature: float, friction_ps: float,
                       tau_fs: float):
        """The per-step thermostat of one cycle, (v, generator, xi) ->
        (v, xi): the Langevin c1/cn kick, the Nose-Hoover update of xi
        (thermostat mass q = dof kB T tau^2, the kinetic energy of the
        mobile atoms) and its velocity scaling, or nothing (NVE)."""
        if thermostat == "langevin":
            c1 = math.exp(-(friction_ps / units.ps) * dt)
            cn = torch.sqrt((1 - c1 ** 2) * units.kB * temperature
                            / self.masses[:, None])

            def langevin(v, generator, xi):
                noise = torch.randn(v.shape, generator=generator,
                                    dtype=v.dtype, device=v.device)
                return c1 * v + cn * noise, xi
            return langevin
        if thermostat == "nose_hoover":
            kt = self.dof * units.kB * temperature
            q = kt * (tau_fs * units.fs) ** 2

            def nose_hoover(v, generator, xi):
                xi = xi + dt * (2.0 * self._mobile_ke(v) - kt) / q
                return v * torch.exp(-xi * dt), xi
            return nose_hoover
        return lambda v, generator, xi: (v, xi)

    def _verlet_step(self, state: MDState, dt: float, thermostat,
                     with_energy: bool, cache2, cache3, scr: SCR = None,
                     temperature: float = 0.0, scale=None):
        """One velocity-Verlet step on the full force, then
        ``thermostat`` and, with ``scr``, one stochastic cell-rescaling
        step: d(ln V) = -beta_T / tau_p (P0 - P_int) dt + sqrt(2 kB T
        beta_T dt / (V tau_p)) dW, P_int from the mobile atoms' kinetic
        energy and the analytic virial.  ``scale`` is the cell's
        cumulative isotropic factor since the cycle's lists were cached:
        the force sees cell * scale, and the caches' shift products
        (linear in the cell) times scale.  The energy is computed when
        ``with_energy``, else carried over.  Returns (state, scale)."""
        m = self.masses[:, None]
        cell = state.cell
        if scr is not None:
            cell = cell * scale
            cache2 = cache2._replace(sd=cache2.sd * scale)
            if cache3 is not None:
                cache3 = cache3._replace(sd=cache3.sd * scale)
        v = state.velocities + 0.5 * dt * state.forces / m
        x = state.positions + dt * v
        energy, forces, virial = self.energy_forces(
            x, state.nbr2, state.nbr3, cell=cell, with_energy=with_energy,
            with_virial=scr is not None, cache2=cache2, cache3=cache3)
        v = v + 0.5 * dt * forces / m
        v, xi = thermostat(v, state.generator, state.xi)
        if scr is not None:
            volume = _volume(cell)
            p_int = (2.0 * self._mobile_ke(v) - torch.trace(virial)) \
                / (3.0 * volume)
            noise = torch.randn((), generator=state.generator,
                                dtype=x.dtype, device=x.device)
            d_eps = (-(scr.beta_t / scr.tau_p) * (scr.pressure - p_int) * dt
                     + torch.sqrt(2.0 * units.kB * temperature * scr.beta_t
                                  * dt / (volume * scr.tau_p)) * noise)
            lam = torch.exp(d_eps / 3.0)
            x = x * lam
            v = v / lam
            scale = scale * lam
        return MDState(positions=x, velocities=v, forces=forces,
                       energy=energy if with_energy else state.energy,
                       nbr2=state.nbr2, nbr3=state.nbr3,
                       generator=state.generator, xi=xi,
                       stale=self._stale(state.stale, state.nbr2,
                                         state.nbr3, x),
                       cell=state.cell), scale

    def _verlet_cycle(self, state: MDState, n_steps: int, dt_fs: float,
                      thermostat: Optional[str], temperature: float,
                      friction_ps: float, compute_energy: bool,
                      tau_fs: float = 100.0, scr: SCR = None) -> MDState:
        """One rebuild cycle of plain velocity Verlet: the neighbor
        refresh, then ``n_steps`` steps; the energy on the last step
        when ``compute_energy``, else the cycle's entry energy stays.
        With ``scr`` the cell takes the cycle's cumulative scale at its
        end."""
        x, nbr2, nbr3 = self._cycle_lists(state)
        cell = state.cell
        cache2, cache3 = self.list_caches(nbr2, nbr3, cell)
        dt = dt_fs * units.fs
        step_thermostat = self._thermostat_fn(thermostat, dt, temperature,
                                              friction_ps, tau_fs)
        state = state._replace(positions=x, nbr2=nbr2, nbr3=nbr3)
        scale = torch.ones((), dtype=self.dtype, device=self.device)
        for step in range(n_steps):
            state, scale = self._verlet_step(
                state, dt, step_thermostat,
                compute_energy and step == n_steps - 1, cache2, cache3,
                scr, temperature, scale)
        if scr is not None:
            state = state._replace(cell=cell * scale)
        return state

    def _run_chunk(self, state: MDState, n_steps: int, dt_fs: float,
                   thermostat: Optional[str] = None,
                   temperature: float = 300.0, friction_ps: float = 2.0,
                   n_chunks: int = 1, tau_fs: float = 100.0,
                   scr: SCR = None) -> MDState:
        """One launch of plain velocity Verlet: ``n_chunks`` rebuild
        cycles of ``n_steps`` steps each, the energy on the launch's
        last step.  The returned state carries no r-RESPA split forces.
        Staleness resets per launch."""
        state = state._replace(stale=torch.zeros_like(state.stale))
        for chunk in range(n_chunks):
            state = self._verlet_cycle(state, n_steps, dt_fs, thermostat,
                                       temperature, friction_ps,
                                       chunk == n_chunks - 1, tau_fs, scr)
        return state

    def _respa_split_forces(self, state: MDState):
        """(f_short, f_tail) of 2-level r-RESPA at ``state``'s
        positions: the switched short pair and 3-body force on the
        3-body rows, and the pair tail."""
        r_lo, r_hi = self.respa_switch
        _, _, f_short = trio_short_forces(
            self.potential, state.positions, state.cell, state.nbr3,
            self.n_basis_short, with_energy=False, r_lo=r_lo, r_hi=r_hi,
            triangle=self.triangle)
        spec = self.potential.pair_spec
        _, f_tail = pair_tail_forces(
            self.potential.pair_coefficients, state.positions, state.cell,
            state.nbr2, spec_pair=spec, n_basis_pair=spec.n_basis,
            with_energy=False, r_lo=r_lo, r_hi=r_hi)
        return f_short, f_tail

    def _respa_cycle(self, state: MDState, n_outer: int, dt_fs: float,
                     thermostat: Optional[str], temperature: float,
                     friction_ps: float, compute_energy: bool,
                     tau_fs: float = 100.0) -> MDState:
        """One rebuild cycle of 2-level r-RESPA: per outer step [tail
        half-kick, n_respa inner velocity-Verlet steps on the short
        force (switched short pair + 3-body, on the 3-body rows), each
        followed by the thermostat, tail half-kick]."""
        pot = self.potential
        dt = dt_fs * units.fs
        dt_out = dt * self.n_respa
        x, nbr2, nbr3 = self._cycle_lists(state)
        cell = state.cell
        cache2 = nb.list_cache(nbr2, cell, self.dtype)
        cache3 = nb.list_cache(nbr3, cell, self.dtype)
        spec = pot.pair_spec
        r_lo, r_hi = self.respa_switch
        m = self.masses[:, None]
        step_thermostat = self._thermostat_fn(thermostat, dt, temperature,
                                              friction_ps, tau_fs)

        def short_forces(xx, with_energy=False):
            return trio_short_forces(pot, xx, cell, nbr3,
                                     self.n_basis_short, with_energy,
                                     r_lo, r_hi, cache3, self.triangle)

        def tail_forces(xx, with_energy=False):
            return pair_tail_forces(
                pot.pair_coefficients, xx, cell, nbr2, spec_pair=spec,
                n_basis_pair=spec.n_basis, with_energy=with_energy,
                r_lo=r_lo, r_hi=r_hi, cache2=cache2)

        v, xi = state.velocities, state.xi
        f_short, f_tail = state.f_short, state.f_tail
        stale = state.stale
        for _ in range(n_outer):
            v = v + 0.5 * dt_out * f_tail / m
            for _ in range(self.n_respa):
                v = v + 0.5 * dt * f_short / m
                x = x + dt * v
                _, _, f_short = short_forces(x)
                v = v + 0.5 * dt * f_short / m
                v, xi = step_thermostat(v, state.generator, xi)
                stale = self._stale(stale, nbr2, nbr3, x)
            _, f_tail = tail_forces(x)
            v = v + 0.5 * dt_out * f_tail / m
        energy = state.energy
        if compute_energy:
            e_s, e3, f_short = short_forces(x, with_energy=True)
            e_t, f_tail = tail_forces(x, with_energy=True)
            energy = self._e1() + e_s + e_t + torch.sum(e3)
        return MDState(positions=x, velocities=v, forces=f_short + f_tail,
                       energy=energy, nbr2=nbr2, nbr3=nbr3,
                       generator=state.generator, xi=xi, stale=stale,
                       cell=cell, f_short=f_short, f_tail=f_tail)

    def _respa_split_forces_3l(self, state: MDState):
        """(f_pair_short, f_trio, f_tail) at ``state``'s positions."""
        pot = self.potential
        r_lo, r_hi = self.respa_switch
        cache3 = nb.list_cache(state.nbr3, state.cell, self.dtype)
        _, f_ps, d3 = pair_short_forces(
            pot.pair_coefficients, state.positions, state.cell, state.nbr3,
            spec_pair=pot.pair_spec, n_basis_pair=self.n_basis_short,
            with_energy=False, r_lo=r_lo, r_hi=r_hi, cache3=cache3)
        _, f_mid = trio_forces(pot, state.positions, state.cell,
                               state.nbr3, with_energy=False,
                               cache3=cache3, d=d3, triangle=self.triangle)
        _, f_tail = pair_tail_forces(
            pot.pair_coefficients, state.positions, state.cell, state.nbr2,
            spec_pair=pot.pair_spec, n_basis_pair=pot.pair_spec.n_basis,
            with_energy=False, r_lo=r_lo, r_hi=r_hi)
        return f_ps, f_mid, f_tail

    def _respa_cycle_3l(self, state: MDState, n_outer: int, dt_fs: float,
                        thermostat: Optional[str], temperature: float,
                        friction_ps: float, compute_energy: bool,
                        tau_fs: float = 100.0) -> MDState:
        """One rebuild cycle of 3-level r-RESPA: per outer step [tail
        half-kick, n_respa / respa_mid mid steps, tail half-kick]; per
        mid step [trio half-kick, respa_mid inner velocity-Verlet steps
        on the switched short pair force, each followed by the
        thermostat, trio refresh on the last inner step's displacement
        rows, trio half-kick]."""
        pot = self.potential
        dt = dt_fs * units.fs
        n_mid = self.respa_mid
        dt_mid = dt * n_mid
        dt_out = dt * self.n_respa
        x, nbr2, nbr3 = self._cycle_lists(state)
        cell = state.cell
        cache2 = nb.list_cache(nbr2, cell, self.dtype)
        cache3 = nb.list_cache(nbr3, cell, self.dtype)
        spec = pot.pair_spec
        r_lo, r_hi = self.respa_switch
        m = self.masses[:, None]
        step_thermostat = self._thermostat_fn(thermostat, dt, temperature,
                                              friction_ps, tau_fs)

        def ps_forces(xx, with_energy=False):
            return pair_short_forces(
                pot.pair_coefficients, xx, cell, nbr3, spec_pair=spec,
                n_basis_pair=self.n_basis_short, with_energy=with_energy,
                r_lo=r_lo, r_hi=r_hi, cache3=cache3)

        def tail_forces(xx, with_energy=False):
            return pair_tail_forces(
                pot.pair_coefficients, xx, cell, nbr2, spec_pair=spec,
                n_basis_pair=spec.n_basis, with_energy=with_energy,
                r_lo=r_lo, r_hi=r_hi, cache2=cache2)

        v, xi = state.velocities, state.xi
        f_ps, f_mid, f_tail = state.f_short, state.f_mid, state.f_tail
        stale = state.stale
        for _ in range(n_outer):
            v = v + 0.5 * dt_out * f_tail / m
            for _ in range(self.n_respa // n_mid):
                v = v + 0.5 * dt_mid * f_mid / m
                for _ in range(n_mid):
                    v = v + 0.5 * dt * f_ps / m
                    x = x + dt * v
                    _, f_ps, d3 = ps_forces(x)
                    v = v + 0.5 * dt * f_ps / m
                    v, xi = step_thermostat(v, state.generator, xi)
                    stale = self._stale(stale, nbr2, nbr3, x)
                # the last inner step's rows feed the trio refresh
                _, f_mid = trio_forces(pot, x, cell, nbr3,
                                       with_energy=False, cache3=cache3,
                                       d=d3, triangle=self.triangle)
                v = v + 0.5 * dt_mid * f_mid / m
            _, f_tail = tail_forces(x)
            v = v + 0.5 * dt_out * f_tail / m
        energy = state.energy
        if compute_energy:
            e_ps, f_ps, d3 = ps_forces(x, with_energy=True)
            e3, f_mid = trio_forces(pot, x, cell, nbr3, with_energy=True,
                                    cache3=cache3, d=d3,
                                    triangle=self.triangle)
            e_t, f_tail = tail_forces(x, with_energy=True)
            energy = self._e1() + e_ps + e_t + torch.sum(e3)
        return MDState(positions=x, velocities=v,
                       forces=f_ps + f_mid + f_tail, energy=energy,
                       nbr2=nbr2, nbr3=nbr3, generator=state.generator,
                       xi=xi, stale=stale, cell=cell, f_short=f_ps,
                       f_tail=f_tail, f_mid=f_mid)

    def _run_chunk_respa(self, state: MDState, n_outer: int, dt_fs: float,
                         thermostat: Optional[str] = None,
                         temperature: float = 300.0,
                         friction_ps: float = 2.0,
                         compute_energy: bool = True,
                         n_chunks: int = 1,
                         tau_fs: float = 100.0) -> MDState:
        """One launch: ``n_chunks`` rebuild cycles of ``n_outer`` outer
        steps each; the energy is computed at the launch's end when
        ``compute_energy``.  Staleness resets per launch."""
        three_level = self.respa_mid > 1
        if state.f_short is None or state.f_tail is None \
                or (three_level and state.f_mid is None):
            # split forces depend on positions only, and the entry
            # lists are complete within their cutoffs; a state from
            # plain Verlet steps carries none
            if three_level:
                f_ps, f_mid, f_tail = self._respa_split_forces_3l(state)
                state = state._replace(f_short=f_ps, f_mid=f_mid,
                                       f_tail=f_tail)
            else:
                f_short, f_tail = self._respa_split_forces(state)
                state = state._replace(f_short=f_short, f_tail=f_tail)
        state = state._replace(stale=torch.zeros_like(state.stale))
        cycle = self._respa_cycle_3l if three_level else self._respa_cycle
        for chunk in range(n_chunks):
            state = cycle(state, n_outer, dt_fs, thermostat, temperature,
                          friction_ps,
                          compute_energy and chunk == n_chunks - 1, tau_fs)
        return state

    # -- capacity regrowth ----------------------------------------------------
    def _grow_capacity(self, factor: float = 1.5):
        """Grow the neighbor-row and cell-bin capacities."""
        self.capacity_2b = int(np.ceil(self.capacity_2b * factor)) + 1
        if self.degree > 2:
            self.capacity_3b = int(np.ceil(self.capacity_3b * factor)) + 1
        for tag in ("_cells_2b", "_cells_3b"):
            cells = getattr(self, tag)
            if cells is not None:
                grid_shape, bin_capacity, topology = cells
                setattr(self, tag, (grid_shape,
                                    int(np.ceil(bin_capacity * factor)) + 1,
                                    topology))

    def _rebuild_state_lists(self, state: MDState) -> MDState:
        """Fresh neighbor lists for ``state`` at the current capacities."""
        positions = self._wrap(state.positions, state.cell)
        nbr2, nbr3 = self.build_lists(positions, state.cell)
        return state._replace(positions=positions, nbr2=nbr2, nbr3=nbr3)

    def _snapshot(self, state: MDState):
        """What a launch that overflows is retried from: the state and
        the position of its noise stream (a torch generator, unlike a
        JAX key, advances in place)."""
        return state, state.generator.get_state()

    def _regrow(self, snapshot, regrows: int, max_regrows: int) -> MDState:
        """Grow the capacities and return the snapshot with fresh lists
        and its noise stream rewound, to run the launch that overflowed
        again; raise after ``max_regrows``."""
        if regrows >= max_regrows:
            raise RuntimeError("neighbor capacity still overflowing after "
                               f"{regrows} regrows (a collapsing cell or "
                               "diverging positions?)")
        state, rng_state = snapshot
        self._grow_capacity()
        state.generator.set_state(rng_state)
        return self._rebuild_state_lists(state)

    def run(self, state: MDState, n_steps: int, dt_fs: float,
            thermostat: Optional[str] = None, temperature: float = 300.0,
            tau_fs: float = 100.0, friction_ps: float = 2.0,
            on_overflow: str = "raise", check_every: int = 50,
            max_regrows: int = 4, callback=None, launch_chunks: int = 1,
            sync: bool = True) -> MDState:
        """Run ``n_steps`` of MD, NVE (``thermostat=None``), Langevin
        (``friction_ps``) or Nose-Hoover (``tau_fs``), in launches of up
        to ``launch_chunks`` rebuild cycles of ``rebuild_every`` steps;
        the trajectory does not depend on ``launch_chunks``.  With
        r-RESPA, steps left after the last whole outer step run as plain
        velocity Verlet.  ``callback(state, steps_done)`` fires after
        each launch.  The returned state's ``stale`` says whether any
        launch outran a skin.

        Neighbor overflow: each launch's flag is queued on its way to the
        host and read without a wait once it has arrived; the oldest is
        waited for only when ``check_every`` are in flight.  With
        ``sync`` every flag this call queued is read before it returns;
        with ``sync=False`` an overflow may surface in a later call or
        in ``overflowed``.  ``on_overflow``: "raise" (RuntimeError once a
        flag reads True), "warn" (a warning per launch that overflowed),
        or "regrow": check each launch at once and rerun it from its
        start with capacities grown 1.5x, at most ``max_regrows`` times
        in the run (flags an earlier asynchronous call left in flight
        grow the capacities first)."""
        if thermostat not in (None, "langevin", "nose_hoover"):
            raise ValueError(f"thermostat={thermostat!r}")
        if on_overflow not in ("raise", "warn", "regrow"):
            raise ValueError(f"on_overflow={on_overflow!r}")
        inner = min(self.rebuild_every, n_steps)
        any_stale = torch.zeros((), dtype=torch.bool, device=self.device)
        kw = dict(dt_fs=dt_fs, thermostat=thermostat,
                  temperature=temperature, friction_ps=friction_ps,
                  tau_fs=tau_fs)
        remaining = n_steps
        regrows = 0
        if on_overflow == "regrow":
            if self._drain_pending():
                self._grow_capacity()
                state = self._rebuild_state_lists(state)
        else:
            self._poll_overflow(on_overflow, check_every)
        while remaining > 0:
            snapshot = self._snapshot(state) if on_overflow == "regrow" \
                else None
            if self.n_respa > 1 and remaining >= self.n_respa:
                n_outer = max(1, min(inner, remaining) // self.n_respa)
                chunk_steps = n_outer * self.n_respa
                n_chunks = max(1, min(launch_chunks,
                                      remaining // chunk_steps))
                steps = n_chunks * chunk_steps
                state = self._run_chunk_respa(
                    state, n_outer=n_outer,
                    compute_energy=remaining - steps < self.n_respa,
                    n_chunks=n_chunks, **kw)
            else:
                chunk_steps = min(inner, remaining)
                n_chunks = max(1, min(launch_chunks,
                                      remaining // chunk_steps))
                steps = n_chunks * chunk_steps
                state = self._run_chunk(state, n_steps=chunk_steps,
                                        n_chunks=n_chunks, **kw)
            if on_overflow == "regrow":
                if self.overflowed(state):
                    state = self._regrow(snapshot, regrows, max_regrows)
                    regrows += 1
                    continue
            else:
                self._pending_overflow.append(
                    _queue_flag(self._overflow_flag(state)))
            # each launch's flag covers that launch only
            false_flag = torch.zeros_like(state.stale)
            state = state._replace(
                nbr2=state.nbr2._replace(overflow=false_flag),
                nbr3=None if state.nbr3 is None
                else state.nbr3._replace(overflow=false_flag))
            if on_overflow != "regrow":
                self._poll_overflow(on_overflow, check_every)
            any_stale = any_stale | state.stale
            remaining -= steps
            if callback is not None:
                callback(state, n_steps - remaining)
        if on_overflow != "regrow":
            if sync:
                hit = self._drain_pending(warn=on_overflow == "warn")
                if hit and on_overflow == "raise":
                    _report_overflow(on_overflow)
            else:
                self._poll_overflow(on_overflow, check_every)
        return state._replace(stale=any_stale)

    def _drain_pending(self, warn: bool = False) -> bool:
        """Read every queued overflow flag, waiting where one is in
        flight; whether any was set.  With ``warn`` each set flag
        warns."""
        hit = False
        for entry in self._pending_overflow:
            if _flag_value(entry):
                hit = True
                if warn:
                    _report_overflow("warn")
        self._pending_overflow.clear()
        return hit

    def _poll_overflow(self, on_overflow: str, check_every: int):
        """Read the queued flags that have reached the host, oldest
        first, without a wait; wait for the oldest only while
        ``check_every`` or more are queued.  Launches run in order, so
        no finished launch goes unread behind an unfinished one.  A set
        flag warns and the reading goes on ("warn"), or the queue is
        dropped and it raises."""
        pending = self._pending_overflow
        while pending and (_flag_ready(pending[0])
                           or len(pending) >= max(1, check_every)):
            if _flag_value(pending.pop(0)):
                if on_overflow != "warn":
                    pending.clear()
                _report_overflow(on_overflow)

    # -- pressure coupling --------------------------------------------------
    def npt_run(self, state: MDState, n_steps: int, dt_fs: float,
                temperature: float = 300.0, pressure: float = 0.0,
                tau_p_fs: float = 1000.0, compressibility: float = 5e-3,
                friction_ps: float = 2.0, barostat: str = "scr",
                thermostat: str = "langevin", callback=None,
                launch_chunks: int = 1):
        """NPT MD on plain velocity Verlet under the Langevin
        thermostat.  Barostats:

        - "scr" (default): stochastic cell rescaling every step inside
          the launch, from the analytic virial (``_verlet_step``);
          ``launch_chunks`` groups rebuild cycles per launch as in
          ``run``;
        - "berendsen": after each rebuild cycle, positions and cell
          scaled by (1 - t / tau_p beta (P0 - P))^(1/3), P from
          ``stress`` and the mobile atoms' kinetic energy (approximate:
          it does not sample the NPT ensemble).

        A launch whose lists overflow runs again from its start with
        grown capacities (at most 4 times in the run).  Returns (state,
        the cell after each launch as numpy (3, 3) arrays).  The
        reference has no barostat on r-RESPA and no Nose-Hoover NPT:
        both raise."""
        if thermostat != "langevin":
            raise _no_reference(f"npt_run(thermostat={thermostat!r})")
        if self.n_respa > 1:
            raise _no_reference("a barostat on r-RESPA (n_respa > 1)")
        if barostat not in ("scr", "berendsen"):
            raise ValueError(f"barostat={barostat!r}")
        scr = SCR(pressure, tau_p_fs * units.fs, compressibility) \
            if barostat == "scr" else None
        cells = []
        inner = min(self.rebuild_every, n_steps)
        done = regrows = 0
        while done < n_steps:
            steps = min(inner, n_steps - done)
            n_chunks = max(1, min(launch_chunks, (n_steps - done) // steps)) \
                if scr is not None else 1
            snapshot = self._snapshot(state)
            state = self._run_chunk(state, n_steps=steps, dt_fs=dt_fs,
                                    thermostat="langevin",
                                    temperature=temperature,
                                    friction_ps=friction_ps,
                                    n_chunks=n_chunks, scr=scr)
            if self.overflowed(state):
                state = self._regrow(snapshot, regrows, MAX_NPT_REGROWS)
                regrows += 1
                continue
            done += n_chunks * steps
            if scr is None:
                scale = self._berendsen_scale(state, dt_fs * steps, pressure,
                                              tau_p_fs, compressibility)
                state = state._replace(positions=state.positions * scale,
                                       cell=state.cell * scale)
            cells.append(state.cell.cpu().numpy())
            if callback is not None:
                callback(state, done)
        return state, cells

    def _berendsen_scale(self, state: MDState, time_fs: float,
                         pressure: float, tau_p_fs: float,
                         compressibility: float) -> float:
        """Berendsen's isotropic factor over ``time_fs`` from the
        pressure of the analytic stress and the mobile atoms' kinetic
        energy (the reference also counts pinned atoms; ROADMAP.md
        section 3)."""
        stress = self.stress(state)
        volume = float(_volume(state.cell))
        p = float(-(stress[0] + stress[1] + stress[2]) / 3.0
                  + 2.0 * self._mobile_ke(state.velocities) / (3.0 * volume))
        return (1.0 - (time_fs / tau_p_fs) * compressibility
                * (pressure - p)) ** (1.0 / 3.0)

    def stress(self, state: MDState):
        """Voigt stress (xx, yy, zz, yz, xz, xy) in eV/A^3 from the
        analytic virial at the state's positions, lists and cell."""
        _, _, virial = self.energy_forces(
            state.positions, state.nbr2, state.nbr3, cell=state.cell,
            with_energy=False, with_virial=True)
        return stress_voigt(virial, _volume(state.cell))

    # -- observables --------------------------------------------------------
    @staticmethod
    def _overflow_flag(state: MDState):
        """The state's lists' overflow flags, ORed (a device bool)."""
        if state.nbr3 is None:
            return state.nbr2.overflow
        return state.nbr2.overflow | state.nbr3.overflow

    def overflowed(self, state: MDState) -> bool:
        """True when a neighbor capacity was exceeded at a build since
        the state's flags were last reset, or a flag still queued by an
        asynchronous ``run`` reads True; reads them all (host sync)."""
        queued = self._drain_pending()
        return bool(self._overflow_flag(state)) or queued

    def temperature(self, state: MDState) -> float:
        """Temperature of the mobile atoms, K."""
        ke = self._mobile_ke(state.velocities)
        return float(2.0 * ke / (self.dof * units.kB))

    def kinetic_energy(self, state: MDState) -> float:
        """Kinetic energy of every atom, pinned ones included (the
        reference's convention), eV."""
        m = self.masses[:, None]
        return float(0.5 * torch.sum(m * state.velocities ** 2))

    def to_atoms(self, atoms_template: Atoms, state: MDState) -> Atoms:
        """A copy of ``atoms_template`` at the state's positions, with
        its velocities (internal units) in ``arrays["velocities"]``."""
        out = atoms_template.copy()
        out.set_positions(state.positions.detach().double().cpu().numpy())
        out.set_array("velocities",
                      state.velocities.detach().double().cpu().numpy())
        return out
