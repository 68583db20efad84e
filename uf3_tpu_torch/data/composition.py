"""
Chemical-system description: the sorted element list, the pair and
trio interactions a B-spline basis is keyed by, and their integer
(Szudzik) species hashes.

Trimmed copy of ``uf3_tpu/data/composition.py`` (the symbol sorting, the
Szudzik hashes of species arrays and of symbol tuples, and the part of
``ChemicalSystem`` that the basis, the host featurizer and the fitting
tools read).  Orderings follow the reference UF3:
  * element_list is the de-duplicated input sorted by the order key;
  * pairs are combinations-with-replacement, each sorted, the list
    ordered by order key;
  * trios fix the first (center) element and sort the neighbors;
  * interaction hashes fold the Szudzik pairing function over columns
    with the neighbor species sorted ascending.
"""

import itertools
from typing import Any, Collection, Dict, List, Tuple

import numpy as np

from uf3_tpu_torch.data import elements as el


def sort_elements(symbols: Collection[str]) -> List[str]:
    """Sort element symbols by the canonical order key."""
    return sorted(symbols, key=el.order_value)


def sort_interaction_symbols(symbols: Collection[str],
                             fix_first: bool = True) -> Tuple[str, ...]:
    """Canonicalize an interaction tuple.  For trios and beyond the
    first (center) element stays put and only neighbors are sorted."""
    symbols = list(symbols)
    if len(symbols) >= 3 and fix_first:
        return tuple([symbols[0]] + sort_elements(symbols[1:]))
    return tuple(sort_elements(symbols))


def sort_interaction_map(imap: Dict[Tuple, Any]) -> Dict[Tuple, Any]:
    """Canonicalize every key of an interaction-keyed dictionary."""
    return {sort_interaction_symbols(k): v for k, v in imap.items()}


def szudzik_pair(pairs: np.ndarray) -> np.ndarray:
    """Vectorized Szudzik pairing: invertible hash of integer pairs."""
    xy = np.asarray(pairs)
    x, y = xy[..., 0], xy[..., 1]
    return np.where(x > y, x * x + y, y * y + x + y)


def szudzik_unpair(hash_list: np.ndarray) -> np.ndarray:
    """Invert szudzik_pair."""
    h = np.asarray(hash_list)
    b = np.sqrt(h).astype(np.int64)
    a = h - b * b
    # a < b  =>  (x, y) = (b, a);   a >= b  =>  (x, y) = (a - b, b)
    out = np.empty(h.shape + (2,), dtype=np.int64)
    out[..., 0] = np.where(a < b, b, a - b)
    out[..., 1] = np.where(a < b, a, b)
    return out


def get_szudzik_hash(array: np.ndarray) -> np.ndarray:
    """Left-fold the pairing function across columns of an (n, d) array."""
    array = np.asarray(array)
    h = array[:, 0]
    for col in range(1, array.shape[1]):
        h = szudzik_pair(np.stack([h, array[:, col]], axis=-1))
    return h


def unpack_szudzik_hash(hash_list: np.ndarray, n_iter: int) -> np.ndarray:
    """Invert get_szudzik_hash back into n_iter columns."""
    h = np.asarray(hash_list)
    columns = []
    for _ in range(n_iter - 1):
        unpacked = szudzik_unpair(h)
        columns.insert(0, unpacked[..., 1])
        h = unpacked[..., 0]
    columns.insert(0, h)
    return np.stack(columns, axis=-1)


def symbols_to_hash(symbols: Collection[str]) -> int:
    numbers = np.array([el.symbols_to_numbers(list(symbols))])
    return int(get_szudzik_hash(numbers)[0])


def hash_to_symbols(hash_: int, n: int = 2) -> Tuple[str, ...]:
    row = unpack_szudzik_hash(np.array([hash_]), n)[0]
    return tuple(el.chemical_symbols[int(z)] for z in row)


class ChemicalSystem:
    """Element list plus enumerated pair/trio interactions and hashes."""

    def __init__(self, element_list: Collection[str], degree: int = 2):
        self.degree = int(degree)
        self.element_list = tuple(sort_elements(set(element_list)))
        self.numbers = [el.atomic_numbers[s] for s in self.element_list]
        self.interactions_map = self._build_interactions_map()
        self.interactions = [
            item for degree in range(1, self.degree + 1)
            for item in self.interactions_map[degree]]
        self.interaction_hashes = self._build_interaction_hashes()

    @staticmethod
    def from_config(config: Dict) -> "ChemicalSystem":
        return ChemicalSystem.from_dict(config)

    @staticmethod
    def from_dict(config: Dict) -> "ChemicalSystem":
        return ChemicalSystem(element_list=config["element_list"],
                              degree=config["degree"])

    def as_dict(self) -> Dict:
        return dict(element_list=list(self.element_list), degree=self.degree)

    def __repr__(self) -> str:
        lines = ["ChemicalSystem:",
                 f"    Elements: {list(self.element_list)}",
                 f"    Degree: {self.degree}",
                 f"    Pairs: {self.interactions_map[2]}"]
        if self.degree > 2:
            lines.append(f"    Trios: {self.interactions_map[3]}")
        return "\n".join(lines)

    def _build_interactions_map(self) -> Dict[int, List]:
        imap: Dict[int, Any] = {1: list(self.element_list)}
        pairs = [sort_interaction_symbols(c) for c in
                 itertools.combinations_with_replacement(self.element_list, 2)]
        imap[2] = sorted(pairs, key=lambda c: [el.order_value(s) for s in c])
        for degree in range(3, self.degree + 1):
            combos = []
            for center in self.element_list:
                for neighbors in itertools.combinations_with_replacement(
                        sort_elements(self.element_list), degree - 1):
                    combos.append((center,) + tuple(neighbors))
            combos.sort(key=lambda c: [el.order_value(s) for s in c])
            imap[degree] = combos
        return imap

    def _build_interaction_hashes(self) -> Dict[int, np.ndarray]:
        hashes = {}
        for degree in range(2, self.degree + 1):
            numbers = np.array([el.symbols_to_numbers(list(combo))
                                for combo in self.interactions_map[degree]])
            numbers[:, 1:] = np.sort(numbers[:, 1:], axis=1)
            hashes[degree] = get_szudzik_hash(numbers)
        return hashes

    def get_composition_tuple(self, geometry) -> np.ndarray:
        """Per-element atom counts in element_list order."""
        numbers = geometry.get_atomic_numbers()
        counts = np.zeros(len(self.element_list), dtype=int)
        for i, z in enumerate(self.numbers):
            counts[i] = int(np.sum(numbers == z))
        return counts
