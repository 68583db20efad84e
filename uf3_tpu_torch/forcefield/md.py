"""
Molecular dynamics of a unary 2+3-body UF3 potential in torch: plain
velocity Verlet, 2-level or 3-level r-RESPA, with one-tier or two-tier
Verlet skins, NVE or Langevin.

Counterpart of ``uf3_tpu/forcefield/md.py`` (``MDSystem.run`` ->
``_run_chunk`` / ``_run_chunk_respa`` -> ``_verlet_step``,
``_respa_cycle``, ``_respa_cycle_3l``).  The neighbor builder follows
the cell: a cell list for periodic boxes of 512 atoms and 16 bins or
more, explicit images for periodic cells narrower than twice the
cutoff, otherwise the O(N^2) minimum-image search (non-periodic
clusters included).  Per rebuild cycle the lists are refreshed on the
host's decision (one sync): a full rebuild once half the 2-body skin
is used, else, with two-tier skins, a refilter of the 3-body list from
the 2-body list.  The 3-body force runs through the trio kernel on the
card.  Options off these paths raise NotImplementedError naming the
ROADMAP.md item that will port them.
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
from uf3_tpu_torch.ops.pair import pair_short_forces, pair_tail_forces
from uf3_tpu_torch.ops.potential import UF3Potential
from uf3_tpu_torch.ops.splines import basis_window_hi
from uf3_tpu_torch.ops.trio import (pair_trio_forces_shared, trio_forces,
                                    trio_short_forces)

OPTIONS = "engine options off the benchmark path"


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to uf3_tpu_torch yet (ROADMAP.md, modules "
        f"still to port: {item})")


def _resolve_device(device) -> torch.device:
    """The requested device, or the current CUDA card when none is
    named; never the CPU unless asked for."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("MDSystem runs on the CUDA card by default and "
                           "this host has none; pass device=\"cpu\" to run "
                           "the plain torch version on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


class MDState(NamedTuple):
    positions: torch.Tensor   # (N, 3)
    velocities: torch.Tensor  # (N, 3) internal units
    forces: torch.Tensor      # (N, 3) eV / A
    energy: torch.Tensor      # () potential energy, eV
    nbr2: nb.NeighborList
    nbr3: nb.NeighborList
    generator: torch.Generator  # Langevin noise stream
    stale: torch.Tensor       # () bool: a skin was exceeded
    cell: torch.Tensor        # (3, 3)
    f_short: torch.Tensor = None  # r-RESPA split forces at `positions`,
    f_tail: torch.Tensor = None   # carried across cycles: short range
    f_mid: torch.Tensor = None    # (pair + 3-body, or pair only with a
    #   mid level), pair tail, 3-body (3-level only); None after plain
    #   Verlet steps, so that the next r-RESPA launch recomputes them


class MDSystem:
    """Binds a fitted potential to a configuration for device MD.

    ``model`` is a ``UF3Potential`` or the path of a model JSON;
    ``atoms`` any object with the reader methods of
    ``uf3_tpu_torch.data.atoms.Atoms``.  ``device`` defaults to the
    CUDA card and raises where there is none: a CPU run (the plain torch
    twins of the kernels) passes ``device="cpu"``."""

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
        if isinstance(model, UF3Potential):
            model = copy.deepcopy(model)
        else:
            model = UF3Potential.from_json(model)
        self.potential = model.to(device=self.device, dtype=dtype)
        if fused != "shared":
            raise _not_ported(f"fused={fused!r}", OPTIONS)
        if trio_triangle:
            raise _not_ported("the triangle-lane trio layout", OPTIONS)
        if static_rebuild:
            raise _not_ported("static_rebuild", OPTIONS)
        self.skin = float(skin)
        self.skin_2b = float(skin_2b) if skin_2b is not None else self.skin
        self.rebuild_every = int(rebuild_every)
        self.r_cut_2b = self.potential.r_cut_2b
        self.r_cut_3b = self.potential.r_cut_3b
        if self.r_cut_3b > self.r_cut_2b:
            raise _not_ported("a 3-body cutoff beyond the 2-body cutoff",
                              "2-body-only models and a separately built "
                              "3-body list")
        # two-tier skins: a larger 2-body skin makes full rebuilds rare,
        # and the 3-body list is refiltered from it every cycle
        self.two_tier = self.skin_2b > self.skin
        if self.two_tier and not eager_refilter:
            raise _not_ported("eager_refilter=False", OPTIONS)
        self.n_respa = int(n_respa)
        self.respa_mid = int(respa_mid)
        if self.respa_mid > 1 and self.n_respa <= 1:
            raise ValueError("respa_mid > 1 requires n_respa > 1")
        self.respa_switch = None
        self.n_basis_short = None
        if self.n_respa > 1:
            self._respa_setup(respa_switch)
        numbers = np.asarray(atoms.get_atomic_numbers())
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
        self.capacity_3b = capacity_3b or nb.estimate_capacity(
            n_atoms, volume, self.r_cut_3b + self.skin)
        self._positions0 = torch.as_tensor(atoms.get_positions(),
                                           dtype=dtype, device=self.device)
        # periodic cells narrower than twice the cutoff: the
        # minimum-image search would drop pairs, so scan explicit images
        self._images_2b = None
        if any(self.pbc):
            req = nb.images_required(atoms.get_cell(), self.pbc,
                                     self.r_cut_2b + self.skin_2b)
            if max(req) > 0:
                self._images_2b = tuple(max(1, r) if p else 0
                                        for r, p in zip(req, self.pbc))
        self._cells_2b = self._cell_list_setup(
            atoms, self.r_cut_2b + self.skin_2b)

    def _respa_setup(self, respa_switch):
        """Validate the r-RESPA cadence and switch band; set the short
        force's basis window."""
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

    @staticmethod
    def _cell_list_setup(atoms, r_cut):
        if not np.any(atoms.get_pbc()) or len(atoms) < 512:
            return None
        grid_shape = nb.grid_shape_for(atoms.get_cell(), r_cut,
                                       atoms.get_pbc())
        n_bins = int(np.prod(grid_shape))
        if n_bins < 16:
            return None
        # size bins from the measured initial occupancy, not the mean:
        # lattice planes aligned with bin boundaries put up to ~1.8x
        # the mean in one bin.  An atom on a bin face may fall on either
        # side of it once the builder recomputes its fractional
        # coordinate in float32 (bcc W at 8^3 or 10^3 overflowed so), so
        # it counts in every bin within 1e-5 of it
        frac = atoms.get_positions() @ np.linalg.inv(atoms.get_cell())
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
        topology = nb.bin_topology(grid_shape, atoms.get_pbc())
        return grid_shape, bin_capacity, topology

    # -- neighbor construction ---------------------------------------------
    def _build_2b(self, positions, cell):
        """The 2-body list by the builder this cell takes."""
        r_cut = self.r_cut_2b + self.skin_2b
        if self._cells_2b is not None:
            grid_shape, bin_capacity, topology = self._cells_2b
            return nb.build_neighbor_list_cells(
                positions, cell, self.pbc, r_cut, self.capacity_2b,
                grid_shape, bin_capacity, topology)
        if self._images_2b is not None:
            return nb.build_neighbor_list_images(
                positions, cell, self.pbc, r_cut, self.capacity_2b,
                images=self._images_2b)
        return nb.build_neighbor_list(positions, cell, self.pbc, r_cut,
                                      self.capacity_2b)

    def build_lists(self, positions, cell=None):
        """(2-body list, 3-body list filtered from it) for positions
        wrapped into the primary cell."""
        cell = self.cell if cell is None else cell
        nbr2 = self._build_2b(positions, cell)
        nbr3 = nb.filter_neighbor_list(nbr2, positions, cell,
                                       self.r_cut_3b + self.skin,
                                       self.capacity_3b)
        return nbr2, nbr3

    def _wrap(self, positions, cell):
        """Wrap into the primary cell (an exact lattice translation);
        a cluster stays as it is."""
        if not any(self.pbc):
            return positions
        return nb.wrap_positions(positions, cell, self.pbc)

    def _e1(self):
        return torch.sum(self.potential.offsets_1b[self.species])

    def energy_forces(self, positions, nbr2, nbr3, cell=None,
                      with_energy: bool = True, cache2=None, cache3=None):
        """Total energy and forces from one shared pair-row gather;
        ``with_energy=False`` skips the energy sums (the 1-body energy
        alone comes back).  ``cache2`` / ``cache3`` carry the lists'
        per-cycle invariants."""
        cell = self.cell if cell is None else cell
        e2, e3, forces = pair_trio_forces_shared(
            self.potential, positions, cell, nbr2, nbr3, with_energy,
            cache2, cache3)
        return self._e1() + e2 + torch.sum(e3), forces

    # -- state setup --------------------------------------------------------
    def init_state(self, velocities: np.ndarray = None,
                   temperature: float = None, seed: int = 0) -> MDState:
        """Initial state: given velocities, Maxwell-Boltzmann velocities
        at ``temperature`` (zero total momentum) drawn from a generator
        seeded with ``seed`` -- which then drives the Langevin noise --
        or zero velocities."""
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
            velocities = torch.as_tensor(np.asarray(velocities),
                                         dtype=self.dtype,
                                         device=self.device)
        nbr2, nbr3 = self.build_lists(positions)
        if bool(nbr2.overflow | nbr3.overflow):
            raise ValueError(
                "neighbor capacity exceeded at initialization "
                f"(capacity_2b={self.capacity_2b}, "
                f"capacity_3b={self.capacity_3b}); increase capacities")
        energy, forces = self.energy_forces(positions, nbr2, nbr3)
        return MDState(positions=positions, velocities=velocities,
                       forces=forces, energy=energy, nbr2=nbr2, nbr3=nbr3,
                       generator=generator,
                       stale=torch.zeros((), dtype=torch.bool,
                                         device=self.device),
                       cell=self.cell)

    # -- integrator ---------------------------------------------------------
    def _rebuild_switch(self, state: MDState):
        """Neighbor refresh at a cycle boundary: a full rebuild once the
        two largest drifts since the 2-body build pass half its skin;
        otherwise, with two-tier skins, a refilter of the 3-body list
        from the 2-body list at the current positions (which resets the
        3-body staleness reference every cycle), and with one tier the
        lists as they are.  Returns (positions, nbr2, nbr3)."""
        cell = state.cell
        x = state.positions
        if bool(nb.needs_rebuild(state.nbr2, x, 0.5 * self.skin_2b)):
            x_w = self._wrap(x, cell)
            nbr2, nbr3 = self.build_lists(x_w, cell)
            return x_w, nbr2, nbr3
        if not self.two_tier:
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
        nbr3 = nbr3._replace(overflow=nbr3.overflow | state.nbr3.overflow)
        return x, nbr2, nbr3

    def _stale(self, stale, nbr2, nbr3, x):
        """Sticky flag: a skin was outrun at positions ``x``."""
        stale = stale | nb.needs_rebuild(nbr2, x, self.skin_2b)
        if self.two_tier:
            stale = stale | nb.needs_rebuild(nbr3, x, self.skin)
        return stale

    @staticmethod
    def _langevin(dt, temperature, friction_ps, m):
        """Langevin c1 and per-atom noise widths cn for one step dt."""
        c1 = math.exp(-(friction_ps / units.ps) * dt)
        return c1, torch.sqrt((1 - c1 ** 2) * units.kB * temperature / m)

    def _thermostat_update(self, v, generator, thermostat, c1, cn):
        """Langevin c1/cn kick, or nothing for NVE."""
        if thermostat == "langevin":
            noise = torch.randn(v.shape, generator=generator,
                                dtype=v.dtype, device=v.device)
            return c1 * v + cn * noise
        return v

    def _verlet_step(self, state: MDState, dt: float, thermostat, c1, cn,
                     with_energy: bool, cache2, cache3) -> MDState:
        """One velocity-Verlet step on the full force; the energy is
        computed when ``with_energy``, else carried over."""
        m = self.masses[:, None]
        v = state.velocities + 0.5 * dt * state.forces / m
        x = state.positions + dt * v
        energy, forces = self.energy_forces(
            x, state.nbr2, state.nbr3, cell=state.cell,
            with_energy=with_energy, cache2=cache2, cache3=cache3)
        v = v + 0.5 * dt * forces / m
        v = self._thermostat_update(v, state.generator, thermostat, c1, cn)
        return MDState(positions=x, velocities=v, forces=forces,
                       energy=energy if with_energy else state.energy,
                       nbr2=state.nbr2, nbr3=state.nbr3,
                       generator=state.generator,
                       stale=self._stale(state.stale, state.nbr2,
                                         state.nbr3, x),
                       cell=state.cell)

    def _verlet_cycle(self, state: MDState, n_steps: int, dt_fs: float,
                      thermostat: Optional[str], temperature: float,
                      friction_ps: float, compute_energy: bool) -> MDState:
        """One rebuild cycle of plain velocity Verlet: the neighbor
        refresh, then ``n_steps`` steps; the energy on the last step
        when ``compute_energy``, else the cycle's entry energy stays."""
        x, nbr2, nbr3 = self._cycle_lists(state)
        cell = state.cell
        cache2 = nb.list_cache(nbr2, cell, self.dtype)
        cache3 = nb.list_cache(nbr3, cell, self.dtype)
        dt = dt_fs * units.fs
        c1, cn = self._langevin(dt, temperature, friction_ps,
                                self.masses[:, None])
        state = state._replace(positions=x, nbr2=nbr2, nbr3=nbr3)
        for step in range(n_steps):
            state = self._verlet_step(
                state, dt, thermostat, c1, cn,
                compute_energy and step == n_steps - 1, cache2, cache3)
        return state

    def _run_chunk(self, state: MDState, n_steps: int, dt_fs: float,
                   thermostat: Optional[str] = None,
                   temperature: float = 300.0, friction_ps: float = 2.0,
                   n_chunks: int = 1) -> MDState:
        """One launch of plain velocity Verlet: ``n_chunks`` rebuild
        cycles of ``n_steps`` steps each, the energy on the launch's
        last step.  The returned state carries no r-RESPA split forces.
        Staleness resets per launch."""
        state = state._replace(stale=torch.zeros_like(state.stale))
        for chunk in range(n_chunks):
            state = self._verlet_cycle(state, n_steps, dt_fs, thermostat,
                                       temperature, friction_ps,
                                       chunk == n_chunks - 1)
        return state

    def _respa_split_forces(self, state: MDState):
        """(f_short, f_tail) of 2-level r-RESPA at ``state``'s
        positions: the switched short pair and 3-body force on the
        3-body rows, and the pair tail."""
        r_lo, r_hi = self.respa_switch
        _, _, f_short = trio_short_forces(
            self.potential, state.positions, state.cell, state.nbr3,
            self.n_basis_short, with_energy=False, r_lo=r_lo, r_hi=r_hi)
        spec = self.potential.pair_spec
        _, f_tail = pair_tail_forces(
            self.potential.pair_coefficients, state.positions, state.cell,
            state.nbr2, spec_pair=spec, n_basis_pair=spec.n_basis,
            with_energy=False, r_lo=r_lo, r_hi=r_hi)
        return f_short, f_tail

    def _respa_cycle(self, state: MDState, n_outer: int, dt_fs: float,
                     thermostat: Optional[str], temperature: float,
                     friction_ps: float, compute_energy: bool) -> MDState:
        """One rebuild cycle of 2-level r-RESPA: per outer step [tail
        half-kick, n_respa inner velocity-Verlet steps on the short
        force (switched short pair + 3-body, on the 3-body rows), tail
        half-kick]."""
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
        c1, cn = self._langevin(dt, temperature, friction_ps, m)

        def short_forces(xx, with_energy=False):
            return trio_short_forces(pot, xx, cell, nbr3,
                                     self.n_basis_short, with_energy,
                                     r_lo, r_hi, cache3)

        def tail_forces(xx, with_energy=False):
            return pair_tail_forces(
                pot.pair_coefficients, xx, cell, nbr2, spec_pair=spec,
                n_basis_pair=spec.n_basis, with_energy=with_energy,
                r_lo=r_lo, r_hi=r_hi, cache2=cache2)

        v = state.velocities
        f_short, f_tail = state.f_short, state.f_tail
        stale = state.stale
        for _ in range(n_outer):
            v = v + 0.5 * dt_out * f_tail / m
            for _ in range(self.n_respa):
                v = v + 0.5 * dt * f_short / m
                x = x + dt * v
                _, _, f_short = short_forces(x)
                v = v + 0.5 * dt * f_short / m
                v = self._thermostat_update(v, state.generator, thermostat,
                                            c1, cn)
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
                       generator=state.generator, stale=stale, cell=cell,
                       f_short=f_short, f_tail=f_tail)

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
                               cache3=cache3, d=d3)
        _, f_tail = pair_tail_forces(
            pot.pair_coefficients, state.positions, state.cell, state.nbr2,
            spec_pair=pot.pair_spec, n_basis_pair=pot.pair_spec.n_basis,
            with_energy=False, r_lo=r_lo, r_hi=r_hi)
        return f_ps, f_mid, f_tail

    def _respa_cycle_3l(self, state: MDState, n_outer: int, dt_fs: float,
                        thermostat: Optional[str], temperature: float,
                        friction_ps: float,
                        compute_energy: bool) -> MDState:
        """One rebuild cycle of 3-level r-RESPA: per outer step [tail
        half-kick, n_respa / respa_mid mid steps, tail half-kick]; per
        mid step [trio half-kick, respa_mid inner velocity-Verlet steps
        on the switched short pair force, trio refresh on the last inner
        step's displacement rows, trio half-kick]."""
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
        c1, cn = self._langevin(dt, temperature, friction_ps, m)

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

        v = state.velocities
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
                    v = self._thermostat_update(v, state.generator,
                                                thermostat, c1, cn)
                    stale = self._stale(stale, nbr2, nbr3, x)
                # the last inner step's rows feed the trio refresh
                _, f_mid = trio_forces(pot, x, cell, nbr3,
                                       with_energy=False, cache3=cache3,
                                       d=d3)
                v = v + 0.5 * dt_mid * f_mid / m
            _, f_tail = tail_forces(x)
            v = v + 0.5 * dt_out * f_tail / m
        energy = state.energy
        if compute_energy:
            e_ps, f_ps, d3 = ps_forces(x, with_energy=True)
            e3, f_mid = trio_forces(pot, x, cell, nbr3, with_energy=True,
                                    cache3=cache3, d=d3)
            e_t, f_tail = tail_forces(x, with_energy=True)
            energy = self._e1() + e_ps + e_t + torch.sum(e3)
        return MDState(positions=x, velocities=v,
                       forces=f_ps + f_mid + f_tail, energy=energy,
                       nbr2=nbr2, nbr3=nbr3, generator=state.generator,
                       stale=stale, cell=cell, f_short=f_ps,
                       f_tail=f_tail, f_mid=f_mid)

    def _run_chunk_respa(self, state: MDState, n_outer: int, dt_fs: float,
                         thermostat: Optional[str] = None,
                         temperature: float = 300.0,
                         friction_ps: float = 2.0,
                         compute_energy: bool = True,
                         n_chunks: int = 1) -> MDState:
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
                          compute_energy and chunk == n_chunks - 1)
        return state

    def run(self, state: MDState, n_steps: int, dt_fs: float,
            thermostat: Optional[str] = None, temperature: float = 300.0,
            friction_ps: float = 2.0, on_overflow: str = "raise",
            callback=None, launch_chunks: int = 1) -> MDState:
        """Run ``n_steps`` of MD, NVE (``thermostat=None``) or Langevin,
        in launches of up to ``launch_chunks`` rebuild cycles of
        ``rebuild_every`` steps; the trajectory does not depend on
        ``launch_chunks``.  With r-RESPA, steps left after the last
        whole outer step run as plain velocity Verlet.
        ``callback(state, steps_done)`` fires after each launch.
        Neighbor overflow is checked once per launch: "raise"
        (RuntimeError) or "warn".  The returned state's ``stale`` says
        whether any launch outran a skin."""
        if thermostat not in (None, "langevin"):
            raise _not_ported(f"thermostat={thermostat!r}", "Nose-Hoover")
        if on_overflow == "regrow":
            raise _not_ported("on_overflow='regrow'", OPTIONS)
        if on_overflow not in ("raise", "warn"):
            raise ValueError(f"on_overflow={on_overflow!r}")
        inner = min(self.rebuild_every, n_steps)
        any_stale = torch.zeros((), dtype=torch.bool, device=self.device)
        kw = dict(dt_fs=dt_fs, thermostat=thermostat,
                  temperature=temperature, friction_ps=friction_ps)
        remaining = n_steps
        while remaining > 0:
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
            if self.overflowed(state):
                message = ("neighbor capacity exceeded during MD: pairs "
                           "were dropped at a rebuild; increase "
                           "capacity_2b/capacity_3b")
                if on_overflow == "raise":
                    raise RuntimeError(message)
                warnings.warn(message)
            # each launch's flag covers that launch only
            false_flag = torch.zeros_like(state.stale)
            state = state._replace(
                nbr2=state.nbr2._replace(overflow=false_flag),
                nbr3=state.nbr3._replace(overflow=false_flag))
            any_stale = any_stale | state.stale
            remaining -= steps
            if callback is not None:
                callback(state, n_steps - remaining)
        return state._replace(stale=any_stale)

    def npt_run(self, *args, **kwargs):
        raise _not_ported("NPT", "NPT and virial")

    def stress(self, state: MDState):
        raise _not_ported("the virial and stress", "NPT and virial")

    # -- observables --------------------------------------------------------
    def overflowed(self, state: MDState) -> bool:
        """True when a neighbor capacity was exceeded at a build since
        the flags were last reset (host sync)."""
        return bool(state.nbr2.overflow | state.nbr3.overflow)

    def temperature(self, state: MDState) -> float:
        m = self.masses[:, None]
        v = state.velocities if self.mobile_mask is None \
            else state.velocities * self.mobile_mask[:, None]
        ke = 0.5 * torch.sum(m * v ** 2)
        return float(2.0 * ke / (self.dof * units.kB))

    def kinetic_energy(self, state: MDState) -> float:
        m = self.masses[:, None]
        return float(0.5 * torch.sum(m * state.velocities ** 2))
