"""
Dataset distance analysis: per-interaction pair-distance histograms,
r^2-normalized RDFs, and peak/valley detection for knot-range selection.

Copy of ``uf3_tpu/data/analyze.py`` (host numpy and scipy) on this
package's geometry helpers.  ``DataAnalyzer.atomic_volumes`` imports
scikit-learn when called, as the reference does; where it is absent it
raises ImportError.
"""

from typing import Dict, List, Tuple

import numpy as np

from uf3_tpu_torch.data import composition, elements
from uf3_tpu_torch.data import geometry as geo
from uf3_tpu_torch.data.atoms import Atoms
from uf3_tpu_torch.representation.featurize_np import _species_pair_mask


def summarize_distances(geometries: List[Atoms],
                        chemical_system: composition.ChemicalSystem,
                        r_cut: float = 12.0,
                        n_bins: int = 100,
                        print_stats: bool = True,
                        min_peak_width: float = 0.5
                        ) -> Tuple[Dict, np.ndarray, Dict]:
    """Histogram pair distances per interaction across a dataset,
    normalize by 4 pi r^2 and density, and report lower bounds/peaks."""
    from scipy import signal
    pair_tuples = chemical_system.interactions_map[2]
    bin_edges = np.linspace(0, r_cut, n_bins + 1)
    histogram = {pair: np.zeros(n_bins) for pair in pair_tuples}
    n_entries = len(geometries)
    for geom in geometries:
        if np.any(geom.get_pbc()):
            supercell = geo.get_supercell(geom, r_cut=r_cut)
            density = len(geom) / geom.get_volume()
        else:
            supercell = geom
            density = 1
        matrix = geo.get_distance_matrix(geom, supercell)
        geo_z = geom.get_atomic_numbers()
        sup_z = supercell.get_atomic_numbers()
        for pair in pair_tuples:
            numbers = elements.symbols_to_numbers(list(pair))
            mask = (_species_pair_mask(numbers, geo_z, sup_z)
                    & (matrix > 0) & (matrix < r_cut))
            freq, _ = np.histogram(matrix[mask], bin_edges)
            freq = freq / density / n_entries / 2
            if pair[0] != pair[1]:
                freq = freq / 2
            histogram[pair] += freq
    bin_centers = 0.5 * (bin_edges[:-1] + bin_edges[1:])
    bin_span = int(np.ceil(min_peak_width / (bin_edges[1] - bin_edges[0])))
    lower_bounds = {}
    for pair in pair_tuples:
        histogram[pair] /= bin_centers ** 2 * 4 * np.pi
        nonzero = np.nonzero(histogram[pair])[0]
        lower_bound = bin_edges[nonzero[0]] if len(nonzero) else r_cut
        lower_bounds[pair] = lower_bound
        if print_stats:
            peaks = bin_centers[signal.find_peaks(histogram[pair],
                                                  width=bin_span)[0]]
            print(pair, f"Lower bound: {lower_bound:.3f} angstroms")
            print(pair, f"Peaks (min width {min_peak_width} angstroms):",
                  peaks)
    return histogram, bin_edges, lower_bounds


class DataAnalyzer:
    """Suggest knot cutoffs from dataset distance statistics."""

    def __init__(self,
                 chemical_system: composition.ChemicalSystem,
                 r_cut: float = 12.0,
                 bins: int = 100,
                 min_peak_width: float = 0.5):
        self.chemical_system = chemical_system
        self.r_cut = r_cut
        self.bins = bins
        self.min_peak_width = min_peak_width
        self.histogram = None
        self.bin_edges = None
        self.lower_bounds = None

    def load_entries(self, geometries: List[Atoms],
                     print_stats: bool = False) -> None:
        self.histogram, self.bin_edges, self.lower_bounds = \
            summarize_distances(geometries, self.chemical_system,
                                r_cut=self.r_cut, n_bins=self.bins,
                                print_stats=print_stats,
                                min_peak_width=self.min_peak_width)

    def analyze(self) -> Dict:
        """Per-pair suggested r_min (first populated bin) and r_max
        (valley after the second coordination peak, else r_cut)."""
        from scipy import signal
        if self.histogram is None:
            raise RuntimeError("Call load_entries first.")
        bin_centers = 0.5 * (self.bin_edges[:-1] + self.bin_edges[1:])
        bin_span = int(np.ceil(self.min_peak_width
                               / (self.bin_edges[1] - self.bin_edges[0])))
        summary = {}
        for pair, values in self.histogram.items():
            peaks, _ = signal.find_peaks(values, width=bin_span)
            valleys, _ = signal.find_peaks(-values, width=bin_span)
            r_min = self.lower_bounds[pair]
            r_max = self.r_cut
            if len(peaks) >= 2 and len(valleys):
                after = valleys[valleys > peaks[1]]
                if len(after):
                    r_max = bin_centers[after[0]]
            summary[pair] = dict(r_min=float(r_min), r_max=float(r_max),
                                 peaks=bin_centers[peaks].tolist())
        return summary

    def atomic_volumes(self, geometries: List[Atoms]) -> Dict[str, float]:
        """Per-element effective atomic volume via a robust (Huber) fit
        of cell volume against composition."""
        from sklearn.linear_model import HuberRegressor
        element_list = list(self.chemical_system.element_list)
        rows = []
        volumes = []
        for geom in geometries:
            if not np.any(geom.get_pbc()):
                continue
            counts = self.chemical_system.get_composition_tuple(geom)
            rows.append(counts)
            volumes.append(geom.get_volume())
        if len(rows) < 2:
            return {}
        x = np.asarray(rows, dtype=float)
        y = np.asarray(volumes)
        model = HuberRegressor(fit_intercept=False)
        model.fit(x, y)
        return {el: float(c) for el, c in zip(element_list, model.coef_)}
