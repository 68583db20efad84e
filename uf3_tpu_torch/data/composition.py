"""
Chemical-system description: the sorted element list and the pair and
trio interactions a B-spline basis is keyed by.

Trimmed copy of ``uf3_tpu/data/composition.py`` (the symbol sorting and
the part of ``ChemicalSystem`` that ``BSplineBasis.from_dict`` and
``as_dict`` need; no species hashing).  Orderings follow the reference UF3:
  * element_list is the de-duplicated input sorted by the order key;
  * pairs are combinations-with-replacement, each sorted, the list
    ordered by order key;
  * trios fix the first (center) element and sort the neighbors.
"""

import itertools
from typing import Any, Collection, Dict, List, Tuple

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


class ChemicalSystem:
    """Element list plus enumerated pair/trio interactions."""

    def __init__(self, element_list: Collection[str], degree: int = 2):
        self.degree = int(degree)
        self.element_list = tuple(sort_elements(set(element_list)))
        self.interactions_map = self._build_interactions_map()
        self.interactions = [
            item for degree in range(1, self.degree + 1)
            for item in self.interactions_map[degree]]

    @staticmethod
    def from_dict(config: Dict) -> "ChemicalSystem":
        return ChemicalSystem(element_list=config["element_list"],
                              degree=config["degree"])

    def as_dict(self) -> Dict:
        return dict(element_list=list(self.element_list), degree=self.degree)

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
