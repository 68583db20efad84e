"""
Unit system: eV (energy), angstrom (length), amu (mass); the derived
time unit is sqrt(amu A^2 / eV) = 10.1805 fs, as in ASE.

Copy of the constants of ``uf3_tpu/forcefield/units.py``.
"""

# 1 fs in internal time units
fs = 0.09822694750253231
ps = 1000.0 * fs

# Boltzmann constant, eV / K
kB = 8.617333262e-5

# pressure conversions (internal = eV / A^3)
GPa = 1.0 / 160.21766208
bar = 1e-4 * GPa
