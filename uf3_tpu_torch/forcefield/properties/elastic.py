"""
Elastic constants by finite-strain energy fits.

Standalone equivalent of the reference's `elastic`-package wrapper
(uf3/forcefield/properties/elastic.py:15-40): apply elementary
deformations, fit the stress/energy response, and assemble C_ij plus
the Voigt bulk modulus.

Copy of ``uf3_tpu/forcefield/properties/elastic.py``: each strained
probe's stress comes from the calculator it is given (the port's
``UFCalculator`` on the card).
"""

from typing import Dict, List

import numpy as np

from uf3_tpu_torch.data.atoms import Atoms


def _strain_matrix(voigt_index: int, magnitude: float) -> np.ndarray:
    strain = np.eye(3)
    if voigt_index < 3:
        strain[voigt_index, voigt_index] += magnitude
    else:
        pairs = {3: (1, 2), 4: (0, 2), 5: (0, 1)}
        i, j = pairs[voigt_index]
        strain[i, j] += magnitude / 2
        strain[j, i] += magnitude / 2
    return strain


def get_elastic_constants(atoms: Atoms,
                          calc,
                          n: int = 5,
                          d: float = 1.0,
                          relax_positions: bool = False) -> Dict:
    """
    Full 6x6 elastic tensor from linear fits of the Voigt stress
    against applied strain (n strain magnitudes up to d percent).

    Returns a dict with keys Cij (GPa), bulk_modulus (GPa, Voigt
    average), and the raw tensor.
    """
    from uf3_tpu_torch.forcefield import units
    magnitudes = np.linspace(-d / 100, d / 100, n)
    magnitudes = magnitudes[magnitudes != 0] if n % 2 else magnitudes
    cell0 = atoms.get_cell()
    c_matrix = np.zeros((6, 6))
    for j in range(6):
        stresses = []
        for eps in magnitudes:
            probe = atoms.copy()
            probe.set_cell(cell0 @ _strain_matrix(j, eps).T,
                           scale_atoms=True)
            if relax_positions:
                probe = calc.relax_fmax(probe, fmax=0.02)
            stresses.append(calc.get_stress(probe))
        stresses = np.array(stresses)  # (n, 6)
        for i in range(6):
            c_matrix[i, j] = np.polyfit(magnitudes, stresses[:, i], 1)[0]
    c_matrix = 0.5 * (c_matrix + c_matrix.T) / units.GPa
    bulk = np.sum(c_matrix[:3, :3]) / 9.0
    return dict(elastic_tensor=c_matrix,
                C11=float(c_matrix[0, 0]),
                C12=float(c_matrix[0, 1]),
                C44=float(c_matrix[3, 3]),
                bulk_modulus=float(bulk))
