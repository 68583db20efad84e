"""
Model loading without pandas: a fitted UF3 model JSON, or the
dictionary it decodes to, to its B-spline basis and flat coefficient
vector, as ``uf3_tpu.regression.least_squares.WeightedLinearModel``'s
``from_json`` / ``from_dict`` and ``arrange_coefficients`` produce them
(that module imports pandas at module level, which the GPU hosts do not
carry).
"""

import warnings
from typing import Dict, NamedTuple

import numpy as np

from uf3_tpu_torch.data import composition
from uf3_tpu_torch.representation.basis import BSplineBasis
from uf3_tpu_torch.util import json_io


class FittedModel(NamedTuple):
    """A fitted model's basis and flat coefficient vector."""
    bspline_config: BSplineBasis
    coefficients: np.ndarray


def flat_coefficients(solution: Dict, config: BSplineBasis) -> np.ndarray:
    """Per-interaction coefficients (3-body possibly as full L x M x N
    grids) to the flat vector, as ``WeightedLinearModel.load``."""
    for nesting in ("coefficients", "solution"):
        if nesting in solution:
            solution = solution[nesting]
            break
    solution = {
        composition.sort_interaction_symbols(k)
        if isinstance(k, tuple) else k: v
        for k, v in dict(solution).items()}
    component_len = config.get_interaction_partitions()[0]

    def checked(key, vec):
        if len(vec) != component_len[key]:
            raise ValueError(f"Incorrect shape: {key}, "
                             f"{len(vec)} != {component_len[key]}")
        return vec

    segments = [np.atleast_1d(solution[el]) for el in config.element_list]
    for pair in config.interactions_map[2]:
        if pair not in solution:
            warnings.warn(f"{pair} not provided.")
            solution[pair] = np.zeros(component_len[pair])
        segments.append(checked(pair, solution[pair]))
    for trio in config.interactions_map.get(3, []):
        if trio not in solution:
            warnings.warn(f"{trio} not provided.")
            continue
        grid = np.array(solution[trio])
        if grid.ndim > 1:  # full LxMxN grid -> symmetry-compressed
            grid = config.compress_3B(grid, trio, fitting=False)
        segments.append(checked(trio, grid))
    flattened = np.concatenate(segments)
    n_coefficients = sum(config.partition_sizes)
    if len(flattened) != n_coefficients:
        raise ValueError(f"Incorrect coefficients: {len(flattened)} "
                         f"provided, {n_coefficients} expected.")
    return flattened


def from_dict(config: Dict) -> FittedModel:
    """A fitted model from its decoded dictionary: the basis settings
    and the per-interaction coefficients (3-body as wedge vectors or full
    L x M x N grids), as ``WeightedLinearModel.from_dict``."""
    basis = BSplineBasis.from_dict(config)
    return FittedModel(basis, flat_coefficients(config, basis))


def load_model(filename: str) -> FittedModel:
    """Read a fitted model JSON (``WeightedLinearModel.to_json``)."""
    return from_dict(json_io.load_interaction_map(filename))


def arrange_coefficients(coefficients, bspline_config) -> Dict:
    """Split the flat coefficient vector into per-interaction entries
    (1-body entries as scalars)."""
    split_indices = np.cumsum(bspline_config.partition_sizes)[:-1]
    pieces = np.array_split(coefficients, split_indices)
    element_list = bspline_config.element_list
    solutions = {el: piece[0]
                 for el, piece in zip(element_list, pieces)}
    pieces = pieces[len(element_list):]
    j = 0
    for degree in range(2, bspline_config.degree + 1):
        for interaction in bspline_config.interactions_map[degree]:
            solutions[interaction] = pieces[j]
            j += 1
    return solutions
