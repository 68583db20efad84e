"""
UFCalculator: energies, forces and stresses of a fitted model, on the
CUDA card.

Counterpart of ``uf3_tpu/forcefield/calculator.py``: the same names
(``coefficients_by_interaction`` too), methods and results (energy in eV with the 1-body offsets unless
``force_consistent``, forces in eV/A in the caller's atom order, Voigt
stress xx, yy, zz, yz, xz, xy in eV/A^3), computed by the MD engine's
force routes (``MDSystem.energy_forces``: the fused kernels, the fused
multi-species route or the factorized path, whichever the model takes)
where the reference contracts basis values with numpy on the host.  The
stress is the analytic virial over the volume, the quantity the
reference takes from central differences of the energy.  Float64 by
default, as the reference's host calculator.

One ``MDSystem`` is kept per structure signature (atomic numbers and
pbc), so the potential's tables stay on the device across calls; a
structure of another signature replaces it.  Each call builds the
lists in full at its positions and cell, with no skin, reads their
overflow flag with the result and, on overflow, grows the capacities
and computes again: no result comes from a truncated list.  A cluster
(no periodic axis) takes the O(N^2) builder whatever its cell.
"""

from typing import Dict

import numpy as np
import torch

from uf3_tpu_torch import io
from uf3_tpu_torch.forcefield.md import MDSystem, _load, _resolve_device
from uf3_tpu_torch.ops.potential import stress_voigt

MAX_REGROWS = 8  # capacity growths (1.5x each) within one call


def coefficients_by_interaction(element_list,
                                interactions_map,
                                partition_sizes,
                                coefficients) -> Dict:
    """Split the flat coefficient vector per interaction (1-body entries
    as one-element arrays; ``io.arrange_coefficients`` gives scalars)."""
    split_indices = np.cumsum(partition_sizes)[:-1]
    pieces = np.array_split(coefficients, split_indices)
    solutions = {el: piece for el, piece
                 in zip(element_list, pieces[:len(element_list)])}
    keys = list(interactions_map[2]) + list(interactions_map.get(3, []))
    for idx, key in enumerate(keys):
        solutions[key] = pieces[len(element_list) + idx]
    return solutions


class UFCalculator:
    """Energy, force and stress evaluation of a fitted UF potential.

    ``model``: the path of a model JSON, a fitted model (an object with
    ``bspline_config`` and ``coefficients``, as ``io.load_model``
    returns) or a ``UF3Potential``; the passthrough properties read the
    fitted model's basis and need one of the first two.  ``device``
    defaults to the CUDA card and raises where there is none: a CPU run
    (the plain torch versions of the kernels) passes ``device="cpu"``."""

    implemented_properties = ["energy", "forces", "stress"]

    def __init__(self, model, dtype=torch.float64, device=None):
        self.device = _resolve_device(device)
        self.dtype = dtype
        if isinstance(model, str):
            model = io.load_model(model)
        self.model = model if hasattr(model, "bspline_config") else None
        self.potential = _load(model).to(device=self.device, dtype=dtype)
        self.system = None     # the MDSystem of the last signature
        self._signature = None
        self._cell = None      # (numpy cell, its tensor) of the last call
        self._e1 = None        # the 1-body energy of the signature
        self._last = None      # (structure key, results) of the last call

    # -- passthroughs -------------------------------------------------------
    def _fitted(self):
        if self.model is None:
            raise ValueError("this calculator was built from a UF3Potential, "
                             "which carries no B-spline basis")
        return self.model

    @property
    def bspline_config(self):
        return self._fitted().bspline_config

    @property
    def degree(self):
        return self.bspline_config.degree

    @property
    def element_list(self):
        return self.bspline_config.element_list

    @property
    def interactions_map(self):
        return self.bspline_config.interactions_map

    @property
    def r_min_map(self):
        return self.bspline_config.r_min_map

    @property
    def r_max_map(self):
        return self.bspline_config.r_max_map

    @property
    def r_cut(self):
        return self.bspline_config.r_cut

    @property
    def coefficients(self):
        return self._fitted().coefficients

    @property
    def chemical_system(self):
        return self.bspline_config.chemical_system

    @property
    def pair_potentials(self):
        """Pair interaction -> (knots, coefficients) map."""
        config = self.bspline_config
        solutions = io.arrange_coefficients(self.model.coefficients, config)
        return {pair: (config.knots_map[pair], solutions[pair])
                for pair in self.interactions_map[2]}

    def __repr__(self):
        return (f"UFCalculator({self.element_list if self.model else ''}, "
                f"{self.dtype}, {self.device})")

    # -- evaluation ---------------------------------------------------------
    def _system_for(self, atoms) -> MDSystem:
        """The cached MDSystem of this structure's signature, made anew
        for another signature."""
        numbers = np.asarray(atoms.get_atomic_numbers())
        signature = (numbers.tobytes(),
                     tuple(bool(p) for p in atoms.get_pbc()))
        if signature != self._signature:
            self.system = MDSystem(self.potential, atoms, dtype=self.dtype,
                                   skin=0.0, device=self.device)
            self._signature = signature
            self._cell = None
            self._e1 = float(self.system._e1())  # the 1-body energy
        return self.system

    def _cell_tensor(self, atoms, system: MDSystem):
        """The cell on the device, the same tensor while the cell stays
        (the builders are checked against a new cell once); the identity
        for a cluster, whose lists take no image."""
        cell = np.eye(3) if not any(system.pbc) \
            else np.asarray(atoms.get_cell(), dtype=np.float64)
        if self._cell is None or not np.array_equal(cell, self._cell[0]):
            self._cell = (cell.copy(), torch.as_tensor(
                cell, dtype=self.dtype, device=self.device))
        return self._cell[1]

    def _evaluate(self, atoms, with_stress: bool) -> Dict:
        """Energy, forces and (with ``with_stress``) stress of
        ``atoms`` as numpy float64, from lists built in full at its
        positions and cell; the last call's results are reused for the
        same structure."""
        system = self._system_for(atoms)
        positions_np = np.asarray(atoms.get_positions(), dtype=np.float64)
        key = (self._signature, positions_np.tobytes(),
               np.asarray(atoms.get_cell(), dtype=np.float64).tobytes())
        if self._last is not None and self._last[0] == key \
                and (self._last[1]["stress"] is not None or not with_stress):
            return self._last[1]
        cell = self._cell_tensor(atoms, system)
        positions = torch.as_tensor(positions_np, dtype=self.dtype,
                                    device=self.device)
        for _ in range(MAX_REGROWS + 1):
            x = system._wrap(positions, cell)
            nbr2, nbr3 = system.build_lists(x, cell)
            energy, forces, virial = system.energy_forces(
                x, nbr2, nbr3, cell=cell, with_virial=with_stress)
            overflow = nbr2.overflow if nbr3 is None \
                else nbr2.overflow | nbr3.overflow
            if not bool(overflow):
                break
            system._grow_capacity()
        else:
            raise RuntimeError(
                f"neighbor capacity still overflowing after {MAX_REGROWS} "
                f"regrows (capacities {system.capacity_2b}/"
                f"{system.capacity_3b}): overlapping atoms?")
        results = dict(
            energy=float(energy),
            forces=forces.detach().double().cpu().numpy(),
            stress=None if not with_stress else stress_voigt(
                virial, atoms.get_volume()).detach().double().cpu().numpy())
        self._last = (key, results)
        return results

    def get_potential_energy(self, atoms,
                             force_consistent: bool = False) -> float:
        """Total energy (eV); without the 1-body offsets when
        ``force_consistent``."""
        results = self._evaluate(atoms, with_stress=False)
        if force_consistent:
            return results["energy"] - self._e1
        return results["energy"]

    def get_forces(self, atoms) -> np.ndarray:
        """Forces (N, 3) in eV/A, in the atoms' order."""
        return self._evaluate(atoms, with_stress=False)["forces"].copy()

    def get_stress(self, atoms) -> np.ndarray:
        """Stress in Voigt order (xx, yy, zz, yz, xz, xy), eV/A^3: the
        analytic virial over the cell's volume (a cell with no volume
        raises)."""
        return self._evaluate(atoms, with_stress=True)["stress"].copy()

    # -- relaxation ---------------------------------------------------------
    def relax_fmax(self, geom, fmax: float = 0.05, steps: int = 500,
                   dt: float = 0.1, verbose: bool = False):
        """FIRE minimization of maximum force."""
        from uf3_tpu_torch.forcefield.optimize import fire_minimize
        return fire_minimize(geom, self, fmax=fmax, max_steps=steps,
                             dt_start=dt, verbose=verbose)

    # -- properties ---------------------------------------------------------
    def get_elastic_constants(self, atoms, n: int = 5, d: float = 1.0):
        from uf3_tpu_torch.forcefield.properties import elastic
        return elastic.get_elastic_constants(atoms, self, n=n, d=d)

    def get_phonon_data(self, atoms, n_super: int = 5, disp: float = 0.05):
        from uf3_tpu_torch.forcefield.properties import phonon
        return phonon.compute_phonon_data(atoms, self, n_super=n_super,
                                          disp=disp)
