"""
Knot sequences of clamped cubic B-spline bases: four spacings with the
endpoints repeated (multiplicity 4), as the reference UF3 makes them:
  linear     uniformly spaced points (rounded to 10 decimals)
  lammps     uniform in r^2 (the LAMMPS table convention)
  geometric  uniform in log r
  inverse    uniform in 1/r

Copy of the spacers of ``uf3_tpu/representation/knots.py``, with its
support windows (``get_knot_subintervals``) and its check of a clamped
sequence (``validate_knot_sequence``).
"""

from typing import Callable, Collection, List

import numpy as np


def knot_sequence_from_points(knot_points: Collection) -> np.ndarray:
    """Repeat both endpoints 3 extra times to clamp the cubic basis."""
    knot_points = np.asarray(knot_points, dtype=np.float64)
    return np.concatenate([np.repeat(knot_points[0], 3),
                           knot_points,
                           np.repeat(knot_points[-1], 3)])


def get_knot_subintervals(knots: np.ndarray) -> List[np.ndarray]:
    """5-knot support windows, one per basis function."""
    return [knots[i:i + 5] for i in range(len(knots) - 4)]


def generate_uniform_knots(r_min, r_max, n_intervals,
                           sequence: bool = True,
                           offset: int = 3) -> np.ndarray:
    if r_min is None:
        # place r_min so that basis function `offset` starts at 0
        r_min = -offset * (r_max - 0.0) / (n_intervals - offset)
    knots = np.linspace(r_min, r_max, n_intervals + 1)
    if sequence:
        knots = knot_sequence_from_points(knots)
    return np.round(knots, 10)


def generate_lammps_knots(r_min, r_max, n_intervals,
                          sequence: bool = True) -> np.ndarray:
    if r_min is None:
        raise ValueError("Automatic lower bound unsupported for r^2 spacing.")
    knots = np.linspace(r_min ** 2, r_max ** 2, n_intervals + 1) ** 0.5
    if sequence:
        knots = knot_sequence_from_points(knots)
    return knots


def generate_geometric_knots(r_min, r_max, n_intervals,
                             sequence: bool = True) -> np.ndarray:
    if r_min is None:
        raise ValueError("Automatic lower bound unsupported for log spacing.")
    knots = np.geomspace(r_min, r_max, n_intervals + 1)
    if sequence:
        knots = knot_sequence_from_points(knots)
    return knots


def generate_inv_knots(r_min, r_max, n_intervals,
                       sequence: bool = True) -> np.ndarray:
    if r_min is None:
        raise ValueError("Automatic lower bound unsupported for 1/r spacing.")
    knots = np.linspace(1 / r_min, 1 / r_max, n_intervals + 1) ** -1
    if sequence:
        knots = knot_sequence_from_points(knots)
    return knots


_SPACERS = {
    "lammps": generate_lammps_knots,
    "linear": generate_uniform_knots,
    "geometric": generate_geometric_knots,
    "inverse": generate_inv_knots,
}


def get_knot_spacer(knot_strategy: str) -> Callable:
    try:
        return _SPACERS[knot_strategy]
    except KeyError:
        raise ValueError(f"Invalid knot_strategy: {knot_strategy}")


def validate_knot_sequence(array: np.ndarray) -> bool:
    """Clamped ends (4-fold) and monotonically non-decreasing interior."""
    array = np.asarray(array)
    return bool(np.ptp(array[:4]) == 0
                and np.ptp(array[-4:]) == 0
                and np.all(np.diff(array) >= 0))
