"""
B-spline basis of a model: per-interaction knot sequences, the 3-body
symmetry template, the partition of the flat coefficient vector, the
columns the edge trims freeze, and the regularizer of the fit.

Trimmed copy of ``BSplineBasis`` (``uf3_tpu/representation/basis.py``):
``from_dict`` / ``as_dict`` and the knot bookkeeping, the cutoff
``r_cut``, ``n_feats``, ``get_interaction_partitions`` and
``get_column_names``, the 3-body ``compress_3B`` /
``compress_3B_batch`` / ``decompress_3B`` with the flatten template and
the symmetry helpers they use, the frozen columns
(``generate_frozen_indices``: ``col_idx``, ``frozen_c``) and
``get_regularization_matrix``.  The ``knots_path`` file options are left
out.  Parity notes (the reference UF3's defaults): pairs r in [1, 8]
with 15 intervals; trios [min, min, min] -> [max, max, 2 max] with
[5, 5, 10] intervals; trims leading {2: 0, 3: 3}, trailing
{2: 3, 3: 3}.
"""

import itertools
import warnings
from typing import Any, Dict, List, Tuple, Union

import numpy as np

from uf3_tpu_torch.data import composition
from uf3_tpu_torch.regression import regularize
from uf3_tpu_torch.representation import knots as kn


def process_trim_values(user_input: Union[None, int, Dict],
                        default_trim: Dict[int, int]) -> Dict[int, int]:
    if user_input is None:
        return dict(default_trim)
    if isinstance(user_input, (int, np.integer)):
        return {key: int(user_input) for key in default_trim}
    if isinstance(user_input, dict):
        out = {}
        for key, value in user_input.items():
            if not isinstance(key, (int, np.integer)) \
                    or not isinstance(value, (int, np.integer)):
                raise ValueError("Trim keys and values must be integers.")
            out[int(key)] = int(value)
        return out
    raise ValueError("Trim values must be None, int, or dict.")


def find_symmetry_3B(trio: Tuple, r_min: List, r_max: List,
                     resolution: List) -> int:
    """Symmetry level of a trio interaction given its leg configurations."""
    if trio[1] != trio[2]:
        return 1
    legs = list(zip(r_min, r_max, resolution))
    if legs[0] == legs[1] == legs[2]:
        return 3 if trio[0] == trio[1] else 2
    if legs[0] == legs[1]:
        return 2
    return 1


def get_symmetry_weights(symmetry: int,
                         l_space: np.ndarray,
                         m_space: np.ndarray,
                         n_space: np.ndarray,
                         n_lead: int = 0,
                         n_trail: int = 3) -> np.ndarray:
    """L x M x N weight grid selecting the symmetry-unique wedge: 0 on
    redundant cells, 1/2 on mirror planes, 1/6 on the body diagonal,
    0 on cells violating the triangle inequality or inside the trims."""
    L, M, N = len(l_space) - 4, len(m_space) - 4, len(n_space) - 4
    i = np.arange(L)[:, None, None]
    j = np.arange(M)[None, :, None]
    k = np.arange(N)[None, None, :]
    template = np.ones((L, M, N))
    if symmetry == 2:
        template = np.where(i > j, 0.0, template)
        template = np.where(i == j, 0.5, template)
    elif symmetry == 3:
        diag = (i == j) & (j == k)
        dead = (i > j) | (j > k)
        plane = (i == k) | (i == j) | (j == k)
        template = np.where(plane, 0.5, template)
        template = np.where(dead, 0.0, template)
        template = np.where(diag, 1.0 / 6.0, template)
    # triangle-inequality restriction on basis-function supports
    ls, ms, ns = (np.asarray(s) for s in (l_space, m_space, n_space))
    bad = ((ls[i + 4] + ms[j + 4] <= ns[k])
           | (ls[i + 4] + ns[k + 4] <= ms[j])
           | (ms[j + 4] + ns[k + 4] <= ls[i]))
    template = np.where(bad, 0.0, template)
    if n_lead > 0:
        template[:n_lead, :, :] = 0
        template[:, :n_lead, :] = 0
        template[:, :, :n_lead] = 0
    if n_trail > 0:
        template[L - n_trail:, :, :] = 0
        template[:, M - n_trail:, :] = 0
        template[:, :, N - n_trail:] = 0
    return template


def symmetrize_3B(grid: np.ndarray, symmetry: int) -> np.ndarray:
    """Sum of grid over the permutation images for the symmetry level."""
    if symmetry == 1:
        return grid
    if symmetry == 2:
        return grid + grid.transpose(1, 0, 2)
    return (grid
            + grid.transpose(0, 2, 1)
            + grid.transpose(1, 0, 2)
            + grid.transpose(1, 2, 0)
            + grid.transpose(2, 0, 1)
            + grid.transpose(2, 1, 0))


class BSplineBasis:
    """Knot sequences and basis-set bookkeeping per chemical interaction."""

    def __init__(self,
                 chemical_system: composition.ChemicalSystem,
                 r_min_map: Dict = None,
                 r_max_map: Dict = None,
                 resolution_map: Dict = None,
                 knot_strategy: str = "linear",
                 offset_1b: bool = True,
                 leading_trim: Union[None, int, Dict] = None,
                 trailing_trim: Union[None, int, Dict] = None,
                 knots_map: Dict = None):
        self.chemical_system = chemical_system
        self.knot_strategy = knot_strategy
        self.offset_1b = offset_1b
        self.leading_trim = process_trim_values(leading_trim, {2: 0, 3: 3})
        self.trailing_trim = process_trim_values(trailing_trim, {2: 3, 3: 3})
        self.r_min_map: Dict[Tuple, Any] = {}
        self.r_max_map: Dict[Tuple, Any] = {}
        self.resolution_map: Dict[Tuple, Any] = {}
        self.knots_map: Dict[Tuple, Any] = {}
        self.symmetry: Dict[Tuple, int] = {}
        self.flat_weights: Dict[Tuple, np.ndarray] = {}
        self.template_mask: Dict[Tuple, np.ndarray] = {}
        self.templates: Dict[Tuple, np.ndarray] = {}
        self.partition_sizes: List[int] = []
        self.frozen_c = np.array([])
        self.col_idx = np.array([], dtype=int)
        self.r_cut = 0.0
        self.update_knots(r_max_map, r_min_map, resolution_map, knots_map)
        self.update_basis_functions()

    @staticmethod
    def from_config(config: Dict) -> "BSplineBasis":
        return BSplineBasis.from_dict(config)

    @staticmethod
    def from_dict(config: Dict) -> "BSplineBasis":
        chemical_system = composition.ChemicalSystem.from_dict(config)
        settings: Dict[str, Any] = {}
        aliases = dict(r_min="r_min_map", r_max="r_max_map",
                       resolution="resolution_map", fit_offsets="offset_1b")
        for key, alias in aliases.items():
            if key in config:
                settings[alias] = config[key]
            if alias in config:
                settings[alias] = config[alias]
        keys = ["r_min_map", "r_max_map", "resolution_map", "knot_strategy",
                "offset_1b", "leading_trim", "trailing_trim", "knots_map"]
        settings.update({k: v for k, v in config.items() if k in keys})
        for trim_key in ("leading_trim", "trailing_trim"):
            value = settings.get(trim_key)
            if isinstance(value, dict):  # JSON stores int keys as strings
                settings[trim_key] = {int(k): v for k, v in value.items()}
        return BSplineBasis(chemical_system, **settings)

    def __repr__(self) -> str:
        lines = ["BSplineBasis:", "    Basis functions:"]
        sizes = self.get_interaction_partitions()[0]
        for degree in range(2, self.degree + 1):
            for interaction in self.interactions_map[degree]:
                lines.append(" " * 8 + f"{interaction}: {sizes[interaction]}")
        lines.append(repr(self.chemical_system))
        return "\n".join(lines)

    def as_dict(self) -> Dict:
        return dict(
            knot_strategy=self.knot_strategy,
            offset_1b=self.offset_1b,
            leading_trim={str(k): v for k, v in self.leading_trim.items()},
            trailing_trim={str(k): v for k, v in self.trailing_trim.items()},
            knots_map=self.knots_map,
            **self.chemical_system.as_dict())

    # -- convenience properties ---------------------------------------------
    @property
    def degree(self) -> int:
        return self.chemical_system.degree

    @property
    def element_list(self):
        return self.chemical_system.element_list

    @property
    def interactions_map(self):
        return self.chemical_system.interactions_map

    @property
    def interactions(self):
        return self.chemical_system.interactions

    @property
    def n_feats(self) -> int:
        return int(np.sum(self.get_feature_partition_sizes()))

    def get_cutoff(self) -> float:
        """Largest center-atom cutoff over all interactions."""
        values = []
        for interaction, r_max in self.r_max_map.items():
            if np.isscalar(r_max) or isinstance(r_max, (int, float)):
                values.append(float(r_max))
            else:  # trio: only legs touching the central atom matter
                values.append(float(max(r_max[:len(interaction) - 1])))
        return max(values)

    # -- knot management ----------------------------------------------------
    def update_knots(self, r_max_map=None, r_min_map=None,
                     resolution_map=None, knots_map=None) -> None:
        def broadcast(value):
            # scalar specs (the YAML-config shorthand) apply to every
            # pair; trio entries then derive from the pair values below
            if value is None or isinstance(value, dict):
                return value or {}
            return {pair: value
                    for pair in self.interactions_map.get(2, [])}

        r_min_map = composition.sort_interaction_map(broadcast(r_min_map))
        r_max_map = composition.sort_interaction_map(broadcast(r_max_map))
        resolution_map = composition.sort_interaction_map(
            broadcast(resolution_map))
        self.r_min_map.update(r_min_map)
        self.r_max_map.update(r_max_map)
        self.resolution_map.update(resolution_map)
        if knots_map is not None:
            self._load_knots_map(composition.sort_interaction_map(knots_map))
        valid = set()
        for degree_data in self.interactions_map.values():
            valid.update(degree_data)
        for map_ in (self.r_min_map, self.r_max_map, self.resolution_map):
            for entry in map_:
                if entry not in valid:
                    warnings.warn(f"{entry} specification unused.")
        for pair in self.interactions_map.get(2, []):
            self.r_min_map.setdefault(pair, 1.0)
            self.r_max_map.setdefault(pair, 8.0)
            self.resolution_map.setdefault(pair, 15)
        for trio in self.interactions_map.get(3, []):
            sub_pairs = list(itertools.combinations(trio, 2))
            mins = [r_min_map.get(k, 1.0) for k in sub_pairs]
            maxs = [r_max_map.get(k, 4.0) for k in sub_pairs]
            self.r_min_map.setdefault(trio, [min(mins)] * 3)
            self.r_max_map.setdefault(trio,
                                      [max(maxs), max(maxs), 2 * max(maxs)])
            self.resolution_map.setdefault(trio, [5, 5, 10])
            self.symmetry[trio] = find_symmetry_3B(trio,
                                                   self.r_min_map[trio],
                                                   self.r_max_map[trio],
                                                   self.resolution_map[trio])
        self.r_cut = self.get_cutoff()

    def _load_knots_map(self, knots_map: Dict) -> None:
        for pair in self.interactions_map.get(2, []):
            if pair not in knots_map:
                warnings.warn(f"{pair} specification unused.")
                continue
            seq = np.array(knots_map[pair], dtype=np.float64)
            self.knots_map[pair] = seq
            self.r_min_map[pair] = seq[0]
            self.r_max_map[pair] = seq[-1]
            self.resolution_map[pair] = len(seq) - 7
        for trio in self.interactions_map.get(3, []):
            if trio not in knots_map:
                warnings.warn(f"{trio} specification unused.")
                continue
            entry = knots_map[trio]
            if isinstance(entry[0], (float, int, np.floating, np.integer)):
                self.symmetry[trio] = 3
                sequences = [np.array(entry)] * 3
            elif len(entry) == 2:
                self.symmetry[trio] = 2
                sequences = [np.array(entry[0]), np.array(entry[0]),
                             np.array(entry[1])]
            else:
                if len(entry) > 3:
                    warnings.warn(f"More than three knot sequences provided "
                                  f"for {trio}.", RuntimeWarning)
                self.symmetry[trio] = 1
                sequences = [np.array(entry[0]), np.array(entry[1]),
                             np.array(entry[2])]
            sequences = [seq.astype(np.float64) for seq in sequences]
            self.knots_map[trio] = sequences
            self.r_min_map[trio] = [seq[0] for seq in sequences]
            self.r_max_map[trio] = [seq[-1] for seq in sequences]
            self.resolution_map[trio] = [len(seq) - 7 for seq in sequences]

    def update_basis_functions(self) -> None:
        spacer = kn.get_knot_spacer(self.knot_strategy)
        for pair in self.interactions_map.get(2, []):
            if pair not in self.knots_map:
                seq = spacer(self.r_min_map[pair], self.r_max_map[pair],
                             self.resolution_map[pair])
                if self.r_min_map[pair] is None:
                    self.r_min_map[pair] = seq[0]
                self.knots_map[pair] = seq
        if self.degree > 2:
            for trio in self.interactions_map.get(3, []):
                if trio not in self.knots_map:
                    self.knots_map[trio] = [
                        spacer(self.r_min_map[trio][i],
                               self.r_max_map[trio][i],
                               self.resolution_map[trio][i])
                        for i in range(3)]
            self.set_flatten_template_3B()
        self.partition_sizes = self.get_feature_partition_sizes()
        self.col_idx, self.frozen_c = self.generate_frozen_indices(
            offset_1b=self.offset_1b,
            n_lead=self.leading_trim,
            n_trail=self.trailing_trim)

    # -- 3-body symmetry compression ----------------------------------------
    def set_flatten_template_3B(self) -> None:
        for trio in self.interactions_map[3]:
            l_space, m_space, n_space = self.knots_map[trio]
            template = get_symmetry_weights(self.symmetry[trio],
                                            l_space, m_space, n_space,
                                            self.leading_trim[3],
                                            self.trailing_trim[3])
            flat = template.flatten()
            mask = np.where(flat > 0)[0]
            self.template_mask[trio] = mask
            self.flat_weights[trio] = flat[mask]
            self.templates[trio] = template

    def symmetrize_3B(self, grid: np.ndarray, symmetry: int) -> np.ndarray:
        """Sum of grid over the permutation images for the symmetry level
        (the module's ``symmetrize_3B``)."""
        return symmetrize_3B(grid, symmetry)

    def compress_3B(self, grid: np.ndarray, interaction: Tuple,
                    fitting: bool = True) -> np.ndarray:
        """Fold an L x M x N grid onto the symmetry-unique wedge vector."""
        symmetry = self.symmetry[interaction]
        vec = symmetrize_3B(np.asarray(grid), symmetry)
        if fitting:
            redundancy = self.flat_weights[interaction]
        else:
            redundancy = {1: 1.0, 2: 0.5, 3: 1.0 / 6.0}[symmetry]
        return vec.flat[self.template_mask[interaction]] * redundancy

    def compress_3B_batch(self, grids: np.ndarray, interaction: Tuple,
                          fitting: bool = True) -> np.ndarray:
        """compress_3B vectorized over arbitrary leading axes:
        grids (..., L, M, N) -> (..., n_wedge)."""
        symmetry = self.symmetry[interaction]
        grids = np.asarray(grids)
        lead = grids.ndim - 3
        if symmetry == 1:
            vec = grids
        elif symmetry == 2:
            vec = grids + np.swapaxes(grids, -3, -2)
        else:
            def t(p):
                return np.transpose(
                    grids, tuple(range(lead)) + tuple(lead + i
                                                      for i in p))
            vec = (t((0, 1, 2)) + t((0, 2, 1)) + t((1, 0, 2))
                   + t((1, 2, 0)) + t((2, 0, 1)) + t((2, 1, 0)))
        if fitting:
            redundancy = self.flat_weights[interaction]
        else:
            redundancy = {1: 1.0, 2: 0.5, 3: 1.0 / 6.0}[symmetry]
        flat = vec.reshape(grids.shape[:lead] + (-1,))
        return flat[..., self.template_mask[interaction]] * redundancy

    def decompress_3B(self, vec: np.ndarray,
                      interaction: Tuple) -> np.ndarray:
        """Expand a wedge vector back into the full L x M x N grid."""
        vec = np.asarray(vec) * self.flat_weights[interaction]
        l_space, m_space, n_space = self.knots_map[interaction]
        shape = (len(l_space) - 4, len(m_space) - 4, len(n_space) - 4)
        grid = np.zeros(shape)
        grid.flat[self.template_mask[interaction]] = vec
        symmetry = self.symmetry[interaction]
        if symmetry == 2:
            grid = grid + grid.transpose(1, 0, 2)
        elif symmetry == 3:
            grid = symmetrize_3B(grid, 3)
        return grid

    # -- partitioning / trims -------------------------------------------------------
    def get_feature_partition_sizes(self) -> List[int]:
        sizes = [1] * len(self.element_list)
        for degree in range(2, self.degree + 1):
            for interaction in self.interactions_map[degree]:
                if degree == 2:
                    sizes.append(self.resolution_map[interaction] + 3)
                else:
                    sizes.append(
                        int(np.sum(self.flat_weights[interaction] > 0)))
        self.partition_sizes = sizes
        return sizes

    def get_interaction_partitions(self) -> Tuple[Dict, Dict]:
        sizes_list = self.get_feature_partition_sizes()
        offsets = np.insert(np.cumsum(sizes_list), 0, 0)
        sizes = {}
        starts = {}
        for j, interaction in enumerate(self.interactions):
            sizes[interaction] = sizes_list[j]
            starts[interaction] = int(offsets[j])
        return sizes, starts

    def get_column_names(self) -> List[str]:
        names = ["y"] + [f"n_{el}" for el in self.element_list]
        sizes = self.get_interaction_partitions()[0]
        for degree in range(2, self.degree + 1):
            for interaction in self.interactions_map[degree]:
                tag = "".join(interaction)
                names.extend(f"{tag}{i}"
                             for i in range(sizes[interaction]))
        return names

    def generate_frozen_indices(self,
                                offset_1b: bool = True,
                                n_lead: Dict[int, int] = None,
                                n_trail: Dict[int, int] = None,
                                value: float = 0.0):
        """Feature-column indices (and values) pinned by the edge trims."""
        n_lead = n_lead or self.leading_trim
        n_trail = n_trail or self.trailing_trim
        sizes, offsets = self.get_interaction_partitions()
        col_idx: List[int] = []
        for pair in self.interactions_map.get(2, []):
            offset, size = offsets[pair], sizes[pair]
            col_idx.extend(offset + t for t in range(n_lead[2]))
            col_idx.extend(offset + size - t for t in range(1, n_trail[2] + 1))
        for trio in self.interactions_map.get(3, []):
            template = np.zeros_like(self.templates[trio])
            for t in range(n_lead[3]):
                template[t, :, :] = 1
                template[:, t, :] = 1
                template[:, :, t] = 1
            for t in range(1, n_trail[3] + 1):
                template[-t, :, :] = 1
                template[:, -t, :] = 1
                template[:, :, -t] = 1
            compressed = self.compress_3B(template, trio)
            base = offsets[trio]
            col_idx.extend(int(base + i)
                           for i in np.where(compressed > 0)[0])
        if not offset_1b:
            col_idx = list(range(len(self.element_list))) + col_idx
        col_idx = np.array(col_idx, dtype=int)
        frozen_c = np.full(len(col_idx), value)
        return col_idx, frozen_c

    # -- regularization -----------------------------------------------------
    def get_regularization_matrix(self,
                                  ridge_map: Dict = None,
                                  curvature_map: Dict = None,
                                  **kwargs) -> np.ndarray:
        import re
        ridge_map = dict(ridge_map or {})
        curvature_map = dict(curvature_map or {})
        for key, value in kwargs.items():
            degree = int(re.sub(r"[^0-9]", "", key))
            if key.lower().startswith("r"):
                ridge_map[degree] = float(value)
            elif key.lower().startswith("c"):
                curvature_map[degree] = float(value)
        grid = regularize.DEFAULT_REGULARIZER_GRID
        ridge_map = {1: grid["ridge_1b"], 2: grid["ridge_2b"],
                     3: grid["ridge_3b"], **ridge_map}
        curvature_map = {1: 0.0, 2: grid["curve_2b"],
                         3: grid["curve_3b"], **curvature_map}
        matrices = [np.sqrt(ridge_map[1])
                    * regularize.get_ridge_penalty_matrix(
                        len(self.element_list))]
        for degree in range(2, self.degree + 1):
            for interaction in self.interactions_map[degree]:
                if degree == 2:
                    matrices.append(self._regularizer_2b(
                        interaction, ridge_map[2], curvature_map[2]))
                else:
                    matrices.append(self._regularizer_3b(
                        interaction, ridge_map[3], curvature_map[3]))
        return regularize.combine_regularizer_matrices(matrices)

    def _regularizer_2b(self, interaction, ridge, curvature) -> np.ndarray:
        size = self.resolution_map[interaction] + 3
        matrix = np.sqrt(ridge) * regularize.get_ridge_penalty_matrix(size)
        if curvature > 0:
            matrix_c = np.sqrt(curvature) \
                * regularize.get_curvature_penalty_matrix_1D(size)
            matrix = np.vstack((matrix, matrix_c))
        return matrix

    def _regularizer_3b(self, interaction, ridge, curvature) -> np.ndarray:
        mask = self.template_mask[interaction]
        matrix = np.sqrt(ridge) * regularize.get_ridge_penalty_matrix(
            len(mask))
        if curvature > 0:
            res = self.resolution_map[interaction]
            matrix_c = regularize.get_curvature_penalty_matrix_3D(
                res[0] + 3, res[1] + 3, res[2] + 3, flatten=False)
            compressed = np.zeros((len(mask), len(mask)))
            for row_i, grid_i in enumerate(mask):
                compressed[row_i] = self.compress_3B(matrix_c[grid_i],
                                                     interaction)
            matrix = np.vstack((matrix, np.sqrt(curvature) * compressed))
        return matrix
