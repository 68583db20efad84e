"""
Cubic B-spline basis values on the host (numpy, float64): the 4
non-zero basis functions at each point by the Cox-de Boor recursion.

Copy of ``find_spline_indices``, ``deboor_values``,
``evaluate_basis_sums``, ``featurize_force_2b``, ``evaluate_spline`` and
the 1D fits ``fit_spline_1d`` / ``fit_spline_1d_ridge`` from
``uf3_tpu/representation/splines.py``.
"""

from typing import Tuple

import numpy as np


def find_spline_indices(points: np.ndarray,
                        knot_sequence: np.ndarray,
                        clip: bool = True) -> np.ndarray:
    """Index of the first non-zero basis function at each point:
    ``searchsorted(knots, r, 'left') - 4``, clamped into the valid range
    with ``clip``."""
    points = np.asarray(points)
    idx = np.searchsorted(knot_sequence, points, side="left") - 4
    if clip:
        n_splines = len(knot_sequence) - 4
        idx = np.clip(idx, 0, n_splines - 4)
    return idx


def deboor_values(points: np.ndarray,
                  knot_sequence: np.ndarray,
                  idx: np.ndarray = None,
                  nu: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Values (or nu-th derivatives, nu <= 2) of the 4 non-zero cubic
    basis functions at each point: (n, 4) with column t = B_{idx + t},
    and the (n,) first non-zero basis index per point."""
    t = np.asarray(knot_sequence, dtype=np.float64)
    r = np.asarray(points, dtype=np.float64)
    if idx is None:
        idx = find_spline_indices(r, t)
    j = idx

    def safe_div(num, den):
        out = np.zeros_like(num)
        np.divide(num, den, out=out, where=(den != 0))
        return out

    tk = t[j[:, None] + np.arange(8)[None, :]]  # knots t[j] .. t[j+7]
    # degree 0: local position 3 is the interval's characteristic function
    b = np.zeros((len(r), 4))
    b[:, 3] = 1.0
    max_degree = 3 - nu if nu > 0 else 3
    for k in range(1, max_degree + 1):
        new = np.zeros_like(b)
        for p in range(3 - k, 4):
            term = safe_div(r - tk[:, p], tk[:, p + k] - tk[:, p]) * b[:, p]
            if p + 1 <= 3:
                term = term + safe_div(tk[:, p + k + 1] - r,
                                       tk[:, p + k + 1] - tk[:, p + 1]) \
                    * b[:, p + 1]
            new[:, p] = term
        b = new
    if nu == 0:
        return b, idx
    # derivative: d/dr B^k_i = k (B^{k-1}_i / (t_{i+k} - t_i)
    #                             - B^{k-1}_{i+1} / (t_{i+k+1} - t_{i+1}))
    for k in range(max_degree + 1, 4):
        new = np.zeros_like(b)
        for p in range(3 - k, 4):
            term = k * safe_div(b[:, p], tk[:, p + k] - tk[:, p])
            if p + 1 <= 3:
                term = term - k * safe_div(b[:, p + 1],
                                           tk[:, p + k + 1] - tk[:, p + 1])
            new[:, p] = term
        b = new
    return b, idx


def evaluate_basis_sums(points: np.ndarray,
                        knot_sequence: np.ndarray,
                        nu: int = 0,
                        n_lead: int = 0,
                        n_trail: int = 0) -> np.ndarray:
    """
    Per-basis-function sums over all points: the 2-body energy feature
    vector.  Equivalent to the reference's dense evaluation
    (bspline.py:810-849) but via the 4-tap kernel + scatter-add.
    """
    n_splines = len(knot_sequence) - 4
    out = np.zeros(n_splines)
    points = np.asarray(points, dtype=np.float64)
    if len(points) == 0:
        return out
    values, idx = deboor_values(points, knot_sequence, nu=nu)
    for tap in range(4):
        np.add.at(out, idx + tap, values[:, tap])
    if n_lead > 0:
        out[:n_lead] = 0.0
    if n_trail > 0:
        out[n_splines - n_trail:] = 0.0
    return out


def featurize_force_2b(points: np.ndarray,
                       drij_dR: np.ndarray,
                       knot_sequence: np.ndarray,
                       n_lead: int = 0,
                       n_trail: int = 0) -> np.ndarray:
    """
    2-body force features: x[a, c, s] = -sum_p B'_s(r_p) * drij_dR[a, c, p].

    Matches reference bspline.py:852-895 (which loops over basis functions
    with per-spline strict-interior masks; for C^2 cubic splines the
    boundary terms those masks exclude are identically zero).
    """
    n_atoms, _, n_distances = drij_dR.shape
    n_splines = len(knot_sequence) - 4
    x = np.zeros((n_atoms, 3, n_splines))
    if n_distances == 0:
        return x
    values, idx = deboor_values(points, knot_sequence, nu=1)
    for tap in range(4):
        contrib = drij_dR * values[None, None, :, tap]  # (n_atoms, 3, n_d)
        # scatter-add along the spline axis
        np.add.at(x.transpose(2, 0, 1), idx + tap, contrib.transpose(2, 0, 1))
    if n_lead > 0:
        x[:, :, :n_lead] = 0.0
    if n_trail > 0:
        x[:, :, n_splines - n_trail:] = 0.0
    return -x


def evaluate_spline(points: np.ndarray,
                    knot_sequence: np.ndarray,
                    coefficients: np.ndarray,
                    nu: int = 0) -> np.ndarray:
    """Evaluate sum_i c_i B_i^(nu)(r) at each point (pair-potential eval)."""
    values, idx = deboor_values(points, knot_sequence, nu=nu)
    c = np.asarray(coefficients)
    taps = c[idx[:, None] + np.arange(4)[None, :]]
    return np.sum(values * taps, axis=1)


def fit_spline_1d(x: np.ndarray,
                  y: np.ndarray,
                  knot_sequence: np.ndarray) -> np.ndarray:
    """
    Least-squares cubic-spline fit of sampled 1D data (for building
    pair potentials from analytic curves), with the endpoint
    pseudo-point padding that guarantees every knot interval holds at
    least one sample.
    """
    from scipy import interpolate
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    b_min, b_max = knot_sequence[0], knot_sequence[-1]
    mask = (x > b_min) & (x < b_max)
    x, y = x[mask], y[mask]
    lowest, highest = np.argmin(x), np.argmax(x)
    x_min, y_min = x[lowest], y[lowest]
    x_max, y_max = x[highest], y[highest]
    unique_knots = np.unique(knot_sequence)
    for i in range(len(unique_knots) - 1):
        midpoint = 0.5 * (unique_knots[i] + unique_knots[i + 1])
        if x_min > unique_knots[i]:
            x = np.insert(x, 0, midpoint)
            y = np.insert(y, 0, y_min)
        elif x_max < unique_knots[i]:
            x = np.insert(x, -1, midpoint)
            y = np.insert(y, -1, y_max)
    order = np.argsort(x)
    x, y = x[order], y[order]
    if knot_sequence[0] == knot_sequence[3]:
        interior = knot_sequence[4:-4]
    else:
        interior = knot_sequence[1:-1]
    lsq = interpolate.LSQUnivariateSpline(x, y, interior,
                                          bbox=(b_min, b_max))
    return lsq.get_coeffs()


def fit_spline_1d_ridge(x: np.ndarray,
                        y: np.ndarray,
                        knot_sequence: np.ndarray,
                        ridge: float = 1e-10) -> np.ndarray:
    """Unpadded ridge-regularized spline fit via the de Boor kernel."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    b_min, b_max = knot_sequence[0], knot_sequence[-1]
    mask = (x > b_min) & (x < b_max)
    x, y = x[mask], y[mask]
    values, idx = deboor_values(x, knot_sequence)
    n_splines = len(knot_sequence) - 4
    design = np.zeros((len(x), n_splines))
    rows = np.arange(len(x))
    for tap in range(4):
        design[rows, idx + tap] += values[:, tap]
    gram = design.T @ design + ridge * np.eye(n_splines)
    return np.linalg.solve(gram, design.T @ y)
