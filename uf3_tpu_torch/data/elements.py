"""
Periodic-table data the port reads: symbol <-> atomic number (and the
symbols-to-numbers list converter), the element ordering key that
canonicalizes interactions, and atomic masses.

Trimmed copy of ``uf3_tpu/data/elements.py`` (the same tables, which
fitted-model files depend on).
"""

from typing import Iterable, List, Union

import numpy as np

# index == atomic number ('X' placeholder at Z=0)
chemical_symbols = [
    'X', 'H', 'He', 'Li', 'Be', 'B', 'C', 'N', 'O', 'F', 'Ne',
    'Na', 'Mg', 'Al', 'Si', 'P', 'S', 'Cl', 'Ar', 'K', 'Ca',
    'Sc', 'Ti', 'V', 'Cr', 'Mn', 'Fe', 'Co', 'Ni', 'Cu', 'Zn',
    'Ga', 'Ge', 'As', 'Se', 'Br', 'Kr', 'Rb', 'Sr', 'Y', 'Zr',
    'Nb', 'Mo', 'Tc', 'Ru', 'Rh', 'Pd', 'Ag', 'Cd', 'In', 'Sn',
    'Sb', 'Te', 'I', 'Xe', 'Cs', 'Ba', 'La', 'Ce', 'Pr', 'Nd',
    'Pm', 'Sm', 'Eu', 'Gd', 'Tb', 'Dy', 'Ho', 'Er', 'Tm', 'Yb',
    'Lu', 'Hf', 'Ta', 'W', 'Re', 'Os', 'Ir', 'Pt', 'Au', 'Hg',
    'Tl', 'Pb', 'Bi', 'Po', 'At', 'Rn', 'Fr', 'Ra', 'Ac', 'Th',
    'Pa', 'U', 'Np', 'Pu', 'Am', 'Cm', 'Bk', 'Cf', 'Es', 'Fm',
    'Md', 'No', 'Lr', 'Rf', 'Db', 'Sg', 'Bh', 'Hs', 'Mt', 'Ds',
    'Rg', 'Cn', 'Nh', 'Fl', 'Mc', 'Lv', 'Ts', 'Og',
]

atomic_numbers = {symbol: z for z, symbol in enumerate(chemical_symbols)}

# Element ordering key: the atomic number, with Po, At, Rn, Fr, Ra and
# Ac absent as in the reference UF3 table.
_ORDER_EXCLUDED = {'X', 'Po', 'At', 'Rn', 'Fr', 'Ra', 'Ac'}
element_order_key = {symbol: z for z, symbol in enumerate(chemical_symbols)
                     if symbol not in _ORDER_EXCLUDED}

# standard atomic masses (amu), IUPAC 2021 abridged; 0.0 for 'X'
atomic_masses = np.array([
    0.0, 1.008, 4.002602, 6.94, 9.0121831, 10.81, 12.011, 14.007, 15.999,
    18.998403163, 20.1797, 22.98976928, 24.305, 26.9815385, 28.085,
    30.973761998, 32.06, 35.45, 39.948, 39.0983, 40.078, 44.955908, 47.867,
    50.9415, 51.9961, 54.938044, 55.845, 58.933194, 58.6934, 63.546, 65.38,
    69.723, 72.630, 74.921595, 78.971, 79.904, 83.798, 85.4678, 87.62,
    88.90584, 91.224, 92.90637, 95.95, 97.90721, 101.07, 102.9055, 106.42,
    107.8682, 112.414, 114.818, 118.710, 121.760, 127.60, 126.90447, 131.293,
    132.90545196, 137.327, 138.90547, 140.116, 140.90766, 144.242, 144.91276,
    150.36, 151.964, 157.25, 158.92535, 162.500, 164.93033, 167.259,
    168.93422, 173.054, 174.9668, 178.49, 180.94788, 183.84, 186.207, 190.23,
    192.217, 195.084, 196.966569, 200.592, 204.38, 207.2, 208.9804, 208.98243,
    209.98715, 222.01758, 223.01974, 226.02541, 227.02775, 232.0377,
    231.03588, 238.02891, 237.04817, 244.06421, 243.06138, 247.07035,
    247.07031, 251.07959, 252.0830, 257.09511, 258.09843, 259.1010, 262.110,
    267.122, 268.126, 271.134, 270.133, 269.1338, 278.156, 281.165, 282.169,
    285.177, 286.182, 289.190, 289.194, 293.204, 293.208, 294.214,
])


def symbols_to_numbers(symbols: Union[str, Iterable]) -> List[int]:
    """Convert symbol(s) (or number(s)) to a list of atomic numbers."""
    if isinstance(symbols, str):
        symbols = [symbols]
    numbers = []
    for item in symbols:
        if isinstance(item, str):
            numbers.append(atomic_numbers[item])
        else:
            numbers.append(int(item))
    return numbers


def numbers_to_symbols(numbers: Iterable[int]) -> List[str]:
    """Convert atomic number(s) to symbol(s)."""
    return [chemical_symbols[int(z)] for z in numbers]


def order_value(symbol: str) -> int:
    """Canonical ordering key for an element symbol."""
    return element_order_key[symbol]
