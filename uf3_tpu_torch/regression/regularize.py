"""
Regularizer-matrix construction for regularized linear least squares.

Ridge (identity) and discrete-Laplacian curvature penalties per interaction
block, combined block-diagonally.  Matches reference semantics
(uf3/regression/regularize.py) with vectorized construction.

Copy of ``uf3_tpu/regression/regularize.py`` (numpy only).
"""

from typing import List

import numpy as np

DEFAULT_REGULARIZER_GRID = dict(ridge_1b=1e-16,
                                ridge_2b=0.0,
                                ridge_3b=1e-10,
                                curve_2b=1e-16,
                                curve_3b=1e-16)


def get_ridge_penalty_matrix(n_features: int) -> np.ndarray:
    """Identity (L2) penalty."""
    return np.eye(n_features)


def get_curvature_penalty_matrix_1D(n_features: int) -> np.ndarray:
    """
    Second-difference penalty on adjacent coefficients; the first and last
    diagonal entries are halved (one-sided difference at the edges).
    """
    matrix = (np.eye(n_features) * -2.0
              + np.eye(n_features, k=-1)
              + np.eye(n_features, k=1))
    matrix[0, 0] /= 2
    matrix[-1, -1] /= 2
    return matrix


def _curvature_nd(shape) -> np.ndarray:
    """
    Discrete Laplacian over an n-D coefficient grid: one row per grid cell;
    each neighbor (along any axis) contributes +1 and the center entry is
    minus the neighbor count.  Returns array of shape (prod(shape), *shape).
    """
    size = int(np.prod(shape))
    ndim = len(shape)
    rows = np.zeros((size,) + tuple(shape))
    grid_idx = np.indices(shape).reshape(ndim, -1).T  # (size, ndim)
    flat = rows.reshape(size, size)
    strides = np.array([int(np.prod(shape[d + 1:])) for d in range(ndim)])
    centers = grid_idx @ strides
    neighbor_counts = np.zeros(size)
    for d in range(ndim):
        for step in (-1, 1):
            coord = grid_idx[:, d] + step
            ok = (coord >= 0) & (coord < shape[d])
            nbr = centers[ok] + step * strides[d]
            flat[np.nonzero(ok)[0], nbr] = 1
            neighbor_counts[ok] += 1
    flat[np.arange(size), centers] = -neighbor_counts
    return rows


def get_curvature_penalty_matrix_2D(L: int, M: int,
                                    flatten: bool = True) -> np.ndarray:
    matrix = _curvature_nd((L, M))
    return matrix.reshape(L * M, L * M) if flatten else matrix


def get_curvature_penalty_matrix_3D(L: int, M: int, N: int,
                                    flatten: bool = True) -> np.ndarray:
    matrix = _curvature_nd((L, M, N))
    return matrix.reshape(L * M * N, L * M * N) if flatten else matrix


def combine_regularizer_matrices(matrices: List[np.ndarray]) -> np.ndarray:
    """Stack penalty matrices block-diagonally (rows = conditions)."""
    n_rows = [m.shape[0] for m in matrices]
    n_cols = [m.shape[1] for m in matrices]
    full = np.zeros((int(np.sum(n_rows)), int(np.sum(n_cols))))
    r0 = 0
    c0 = 0
    for m in matrices:
        full[r0:r0 + m.shape[0], c0:c0 + m.shape[1]] = m
        r0 += m.shape[0]
        c0 += m.shape[1]
    return full
