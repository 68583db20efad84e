"""
Optional ASE interoperability: where ase is importable,
:class:`UFAseCalculator` exposes any fitted model to ASE's optimizers,
MD and phonon drivers through this package's ``UFCalculator`` (on the
CUDA card unless ``device="cpu"``), without making ase a dependency;
``from_ase`` and ``to_ase`` convert configurations.

Copy of ``uf3_tpu/forcefield/ase_adapter.py``.  Importing this module
never requires ase; constructing the calculator does (raising a clear
ImportError otherwise).
"""

import numpy as np

from uf3_tpu_torch.data.atoms import Atoms as UFAtoms

try:
    from ase.calculators.calculator import Calculator, all_changes
    HAVE_ASE = True
except ImportError:          # pragma: no cover - env-dependent
    HAVE_ASE = False
    Calculator = object
    all_changes = ["positions", "numbers", "cell", "pbc"]


def from_ase(atoms) -> UFAtoms:
    """Convert an ase.Atoms (or anything with the same accessors) into
    the framework's container."""
    return UFAtoms(np.asarray(atoms.get_atomic_numbers()),
                   np.asarray(atoms.get_positions()),
                   cell=np.asarray(atoms.get_cell()),
                   pbc=np.asarray(atoms.get_pbc()))


def to_ase(atoms: UFAtoms):
    """Convert the framework container into an ase.Atoms."""
    if not HAVE_ASE:
        raise ImportError("ase is not installed")
    import ase
    return ase.Atoms(numbers=atoms.get_atomic_numbers(),
                     positions=atoms.get_positions(),
                     cell=atoms.get_cell(),
                     pbc=atoms.get_pbc())


class UFAseCalculator(Calculator):
    """ase.calculators.calculator.Calculator wrapping a fitted model.

    Drop-in replacement for the reference's UFCalculator in ASE
    workflows::

        calc = UFAseCalculator(model)
        ase_atoms.calc = calc
        ase_atoms.get_potential_energy()
    """

    implemented_properties = ["energy", "forces", "stress"]

    def __init__(self, model, device=None, **kwargs):
        if not HAVE_ASE:
            raise ImportError(
                "ase is not installed; use "
                "uf3_tpu_torch.forcefield.calculator.UFCalculator with "
                "uf3_tpu_torch.data.atoms.Atoms instead")
        super().__init__(**kwargs)
        from uf3_tpu_torch.forcefield.calculator import UFCalculator
        self.uf_calc = UFCalculator(model, device=device)

    def calculate(self, atoms=None, properties=("energy",),
                  system_changes=all_changes):
        super().calculate(atoms, properties, system_changes)
        uf_atoms = from_ase(self.atoms)
        self.results["energy"] = \
            self.uf_calc.get_potential_energy(uf_atoms)
        self.results["free_energy"] = self.results["energy"]
        self.results["forces"] = self.uf_calc.get_forces(uf_atoms)
        if "stress" in properties:
            self.results["stress"] = self.uf_calc.get_stress(uf_atoms)
