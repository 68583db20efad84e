"""
Farthest-point subsampling of scalar/vector data (reference
uf3/util/subsample.py semantics: start at the minimum, stop at
max_samples or when the largest remaining gap drops below min_diff).

Copy of ``uf3_tpu/util/subsample.py``.
"""

import numpy as np


def farthest_point_sampling(data: np.ndarray,
                            max_samples: int = None,
                            min_diff: float = 0) -> np.ndarray:
    data = np.asarray(data, dtype=float)
    if data.ndim < 2:
        data = data[:, None]
    diff = data[:, None, :] - data[None, :, :]
    dist_matrix = np.sqrt(np.sum(diff * diff, axis=-1))
    if max_samples is None and min_diff == 0:
        return np.arange(len(data))
    if max_samples is None or max_samples >= len(data) or max_samples < 1:
        max_samples = len(data)
    subsamples = np.array([int(np.argmin(data[:, 0]))])
    while len(subsamples) < max_samples:
        dist_matrix[subsamples, :] = 0
        scores = np.min(dist_matrix[:, subsamples], axis=1)
        if np.max(scores) < min_diff:
            break
        subsamples = np.append(subsamples, int(np.argmax(scores)))
    return subsamples
