"""
Weighted regularized linear least squares for UF potentials, without
pandas: the Gram matrix (X^T X) and ordinate (X^T y) are accumulated in
float64 on the model's device, by default the CUDA card, batch by batch
as features arrive; they are blended with the per-channel 1/(sqrt(n)
sigma) weights and the energy/force balance, the squared regularizer
is added, the frozen (trimmed) columns are eliminated, and the normal
equations are solved in float64 on the host.

Counterpart of ``uf3_tpu/regression/least_squares.py`` (which imports
pandas, absent from the GPU hosts): ``VarianceRecorder``, the Gram
primitives (``moore_penrose_components``, ``batched_moore_penrose``,
``linear_least_squares``, ``weighted_least_squares``: the products on a
device, the solve on the host), the frozen-column helpers,
``calc_E_F_weights``, ``BasicLinearModel``, ``WeightedLinearModel``
(``fit_with_gram``, ``fit``, ``combine_weighted_gram``, ``predict``,
``score``, ``from_dict`` / ``from_json``, ``as_dict`` / ``to_json`` /
``dump``, ``load``, ``fix_repulsion_2b``), the pair-spline
post-processing (``get_spline_taylor_expansion``,
``postprocess_coefficients_2b``, ``find_pair_potential_well``),
``arrange_coefficients``, ``dataframe_to_tuples`` (on a
``representation.process.FeatureTable``), ``subset_prediction`` and
the metrics.  ``fit_from_file``, ``batched_predict`` and
``batched_prediction`` read the features file that ``python -m
uf3_tpu_torch featurize`` writes one table at a time
(``feature_tables``; ``feature_rows`` concatenates them), and
``fit_tables`` fits them as ``parallel/mesh.py``'s
``fit_from_file_sharded`` does too: the reference's HDF5 store streamed
table by table, each table's rows through ``dataframe_to_tuples``, or
an ``.npz`` whose rows are already per atom.  Feature batches on the
device fit through ``fit_from_batches`` and ``gram_from_batches``.
"""

import os
from typing import Collection, Dict, Iterable, List, Tuple

import numpy as np
import torch

from uf3_tpu_torch import io
from uf3_tpu_torch.data import io as data_io
from uf3_tpu_torch.forcefield.md import _resolve_device
from uf3_tpu_torch.io import arrange_coefficients  # noqa: F401
from uf3_tpu_torch.representation import process
from uf3_tpu_torch.representation import splines as sp
from uf3_tpu_torch.representation.basis import BSplineBasis
from uf3_tpu_torch.util import hdf5, json_io


class VarianceRecorder:
    """Streaming population mean/std over batches.

    Internally carries Chan-style moments (count, mean, M2 = summed
    squared deviations), which merge exactly across batches of any
    size; ``mean``/``std`` are derived views of the moments.  Used by
    the fit pipeline to size the 1/(sqrt(n) sigma) channel weights
    (reference semantics: uf3/regression/least_squares.py:19-60).
    """

    def __init__(self, mean=0, std=0, n=0):
        self.n = int(n)
        self._mean = np.asarray(mean, dtype=float) if n else 0.0
        self._m2 = (np.asarray(std, dtype=float) ** 2 * n) if n else 0.0

    @property
    def mean(self):
        return self._mean

    @property
    def std(self):
        return np.sqrt(self._m2 / self.n) if self.n else 0.0

    def update(self, batch: Collection) -> Tuple:
        batch = np.asarray(batch, dtype=float)
        n_b = len(batch)
        if n_b:
            mean_b = batch.mean(axis=0)
            m2_b = ((batch - mean_b) ** 2).sum(axis=0)
            total = self.n + n_b
            delta = mean_b - self._mean
            self._m2 = (self._m2 + m2_b
                        + delta * delta * (self.n * n_b / total))
            self._mean = self._mean + delta * (n_b / total)
            self.n = total
        return self.mean, self.std, self.n

    def update_with_components(self, df, keys=None):
        """Fold the flattened force components of a ``Dataset``'s rows
        into the stream, skipping rows with missing entries."""
        keys = keys or ["fx", "fy", "fz"]
        for cols in zip(*(df[k] for k in keys)):
            if any(c is None or (np.isscalar(c) and np.isnan(c))
                   for c in cols):
                continue
            self.update(np.concatenate(
                [np.ravel(np.asarray(c, dtype=float)) for c in cols]))
        return self.mean, self.std, self.n


def _host(array) -> np.ndarray:
    if isinstance(array, torch.Tensor):
        return array.detach().cpu().numpy()
    return np.asarray(array)


# ---------------------------------------------------------------------------
# gram/ordinate primitives
# ---------------------------------------------------------------------------
def _rows64(array, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_host(array), dtype=torch.float64, device=device)


def moore_penrose_components(x, y, device=None) -> Tuple[np.ndarray,
                                                          np.ndarray]:
    """Gram matrix (X^T X) and ordinate (X^T y) in float64, the products
    on ``device`` (the CUDA card unless ``device="cpu"``), as numpy
    arrays."""
    device = _resolve_device(device)
    xt, yt = _rows64(x, device), _rows64(y, device)
    return _host(xt.T @ xt), _host(xt.T @ yt)


def batched_moore_penrose(x, y, batch_size: int = 2500, device=None):
    """(X^T X, X^T y) summed on ``device`` over row batches that cross
    to it one at a time, as the reference splits them."""
    n_samples, n_features = np.shape(x)
    n_batches = int(n_samples / batch_size)
    if n_batches <= 1:
        return moore_penrose_components(x, y, device)
    device = _resolve_device(device)
    gram = torch.zeros((n_features, n_features), dtype=torch.float64,
                       device=device)
    ordinate = torch.zeros(n_features, dtype=torch.float64, device=device)
    for batch in np.array_split(np.arange(n_samples), n_batches):
        xb, yb = _rows64(x[batch], device), _rows64(y[batch], device)
        gram += xb.T @ xb
        ordinate += xb.T @ yb
    return _host(gram), _host(ordinate)


def lu_factorization(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.linalg.solve(a, b)


def linear_least_squares(x, y, device=None):
    """The least-squares solution of x c = y: the products on
    ``device``, the solve on the host in float64."""
    a, b = moore_penrose_components(x, y, device)
    return lu_factorization(a, b)


def apply_weights(x, y, weights):
    if weights is None:
        return x, y
    if len(weights) != len(x):
        raise ValueError("Number of weights does not match samples.")
    if not np.all(np.asarray(weights) >= 0):
        raise ValueError("Negative weights provided.")
    w = np.sqrt(weights)
    return np.multiply(x.T, w).T, np.multiply(y, w)


def weighted_least_squares(x, y, weights=None, regularizer=None,
                           device=None):
    """``linear_least_squares`` of the rows scaled by sqrt(weights), the
    ``regularizer``'s rows appended with zero targets."""
    x_fit, y_fit = apply_weights(x, y, weights)
    if regularizer is not None:
        x_fit = np.concatenate([x_fit, regularizer])
        y_fit = np.concatenate([y_fit, np.zeros(len(regularizer))])
    return linear_least_squares(x_fit, y_fit, device)


# ---------------------------------------------------------------------------
# frozen-column elimination
# ---------------------------------------------------------------------------
def get_freezing_mask(n_feats: int, col_idx: np.ndarray) -> np.ndarray:
    return np.setdiff1d(np.arange(n_feats), col_idx)


def freeze_columns(x, y, mask, frozen_c, col_idx):
    """Eliminate frozen columns, moving their contribution into y; numpy
    arrays, or tensors on their own device."""
    if isinstance(x, torch.Tensor):
        x_fixed = x[:, torch.as_tensor(col_idx, device=x.device)]
        shift = x_fixed @ torch.as_tensor(frozen_c, dtype=x.dtype,
                                          device=x.device)
        return x[:, torch.as_tensor(mask, device=x.device)], y - shift
    x = np.asarray(x)
    x_fixed = x[:, col_idx]
    return x[:, mask], np.subtract(y, np.dot(x_fixed, frozen_c))


def freeze_regularizer(regularizer, mask):
    return regularizer[:, mask]


def revert_frozen_coefficients(solution, n_coeff, mask, frozen_c,
                               frozen_idx) -> np.ndarray:
    full = np.zeros(n_coeff, dtype=np.asarray(solution).dtype)
    full[np.asarray(mask, dtype=int)] = solution
    full[np.asarray(frozen_idx, dtype=int)] = frozen_c
    return full


def calc_E_F_weights(n_e, n_f, std_e, std_f) -> Tuple[float, float]:
    """Per-channel weights 1/(sqrt(n) * sigma); degenerate energies fall
    back to weight 1 (reference least_squares.py:1147-1169)."""
    if std_e == 0:
        return 1.0, 1.0 / np.sqrt(n_f)
    return 1.0 / np.sqrt(n_e) / std_e, 1.0 / np.sqrt(n_f) / std_f


# ---------------------------------------------------------------------------
# feature tables
# ---------------------------------------------------------------------------
def dataframe_to_tuples(df_features, n_elements: int = None,
                        energy_key: str = "energy",
                        sample_weights: Dict = None):
    """
    Split a ``FeatureTable``'s rows into energy and force channels;
    energy rows are normalized per atom via the 1-body composition
    columns when ``n_elements`` is given; each row is scaled by its
    configuration's ``sample_weights`` entry.  The table's values are
    read in place and each channel is copied once, so the rows take at
    most twice the table's memory.
    """
    names = df_features.names
    energy_mask = np.array([kind == energy_key
                            for kind in df_features.kinds], dtype=bool)
    force_mask = ~energy_mask
    data = np.asarray(df_features.values, dtype=np.float64)
    y = data[:, 0]
    x = data[:, 1:]
    y_e = y[energy_mask]
    y_f = y[force_mask]
    if n_elements is not None:
        sizes = np.sum(x[energy_mask, :n_elements], axis=1)
        x_e = x[energy_mask] / sizes[:, None]
        y_e = y_e / sizes
    else:
        x_e = x[energy_mask]
    x_f = x[force_mask]
    if sample_weights is not None:   # each channel is a copy already
        w = np.array([sample_weights.get(name, 1.0) for name in names])
        x_e *= w[energy_mask][:, None]
        y_e *= w[energy_mask]
        x_f *= w[force_mask][:, None]
        y_f *= w[force_mask]
    return x_e, y_e, x_f, y_f


def _row_batches(x_e, y_e, x_f, y_f, batch_size: int):
    """(x_e, y_e, x_f, y_f) in batches of at most ``batch_size`` rows of
    each channel."""
    for start in range(0, max(len(y_e), len(y_f), 1), batch_size):
        rows = slice(start, start + batch_size)
        yield x_e[rows], y_e[rows], x_f[rows], y_f[rows]


def feature_keys(path: str) -> List[str]:
    """The configuration keys of a features file, in its order (each
    once), read from the tables' row names or the ``.npz``'s keys."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    if not hdf5.is_hdf5_path(path):
        with np.load(path) as data:
            return data["keys"].tolist()
    keys = {}
    with hdf5.File(path) as f:
        for table in f.keys():
            keys.update(dict.fromkeys(f.read(f"{table}/row_names")))
    return list(keys)


def feature_tables(path: str, subset=None, sample_weights: Dict = None,
                   drop_columns=None, energy_key: str = "energy",
                   n_elements: int = None, table_names=None):
    """(x_e, y_e, x_f, y_f) of a features file, one tuple per table, so
    that host memory holds one table: those of the configurations in
    ``subset`` (every configuration where None), each row scaled by its
    configuration's ``sample_weights`` entry (1 where it has none), the
    ``drop_columns`` removed by name (KeyError for a name the file
    lacks).

    An HDF5 store is read table by table (``table_names``, by default
    every table in sorted order), as the reference's ``fit_from_file``
    reads it: a table's rows of the ``subset`` keys through
    ``dataframe_to_tuples`` with ``energy_key`` and ``n_elements`` (the
    energy rows divided by the atom count of the first ``n_elements``
    columns); a table holding none of them gives nothing.  An ``.npz``
    is one table whose rows are already per atom; it holds one energy
    column, so ``energy_key`` must be "energy"."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    if not hdf5.is_hdf5_path(path):
        yield _npz_rows(path, subset, sample_weights, drop_columns,
                        energy_key)
        return
    if table_names is None:
        table_names = process.analyze_hdf_tables(path)[2]
    wanted = None if subset is None else set(subset)
    for name in table_names:
        table = process.load_feature_db(path, name)
        configs = list(dict.fromkeys(table.names))
        keys = configs if wanted is None \
            else [key for key in configs if key in wanted]
        if not keys:
            continue
        if len(keys) < len(configs):
            table = table.select(keys)
        if drop_columns is not None:
            table = table.drop(drop_columns)
        rows = dataframe_to_tuples(table, n_elements=n_elements,
                                   energy_key=energy_key,
                                   sample_weights=sample_weights)
        del table   # neither is held while the next table is read
        yield rows
        del rows


def feature_rows(path: str, subset=None, sample_weights: Dict = None,
                 drop_columns=None, energy_key: str = "energy",
                 n_elements: int = None):
    """(x_e, y_e, x_f, y_f) of every table of ``feature_tables``,
    concatenated in the file's order."""
    parts = list(feature_tables(path, subset, sample_weights, drop_columns,
                                energy_key, n_elements))
    if len(parts) == 1:
        return parts[0]
    if not parts:
        raise ValueError(f"{path} holds no row of the keys asked for")
    return tuple(np.concatenate(arrays) for arrays in zip(*parts))


def _npz_rows(path: str, subset, sample_weights, drop_columns,
              energy_key):
    """The ``.npz`` rows of ``feature_tables``."""
    if energy_key != "energy":
        raise ValueError(f"energy_key {energy_key!r}: the .npz features "
                         "file holds one energy column, 'energy'")
    with np.load(path) as data:
        x_e, y_e, x_f, y_f, keys, force_rows, columns = (
            data[k] for k in data_io.FEATURE_KEYS + ("keys", "force_rows",
                                             "columns"))
    if drop_columns is not None:
        missing = sorted(set(drop_columns) - set(columns[1:].tolist()))
        if missing:
            raise KeyError(f"{missing} not found in the features' columns")
        keep = ~np.isin(columns[1:], list(drop_columns))
        x_e, x_f = x_e[:, keep], x_f[:, keep]
    chosen = np.arange(len(keys)) if subset is None \
        else np.flatnonzero(np.isin(keys, list(subset)))
    w = np.array([1.0 if sample_weights is None
                  else sample_weights.get(keys[i], 1.0) for i in chosen],
                 dtype=np.float64)
    f_start = np.concatenate([[0], np.cumsum(force_rows)])
    f_idx = np.concatenate([np.arange(f_start[i], f_start[i + 1])
                            for i in chosen] + [np.zeros(0)]).astype(np.int64)
    w_f = np.repeat(w, force_rows[chosen])
    return (x_e[chosen] * w[:, None], y_e[chosen] * w,
            x_f[f_idx] * w_f[:, None], y_f[f_idx] * w_f)


def fit_tables(model, filename: str, subset, table_gram,
               weight: float = 0.5, sample_weights: Dict = None,
               energy_key: str = "energy", drop_columns=None) -> None:
    """Fit ``model`` on the rows of ``subset`` in a features file read
    one table at a time (``feature_tables``): ``table_gram(rows,
    e_variance, f_variance)`` gives a table's (gram_e, gram_f, ord_e,
    ord_f) and streams its targets into the recorders; the sums are
    weighted by the recorded channel weights and solved on the host.
    ``fit_from_file`` and ``parallel.mesh.fit_from_file_sharded`` differ
    only in their ``table_gram``."""
    e_var, f_var = VarianceRecorder(), VarianceRecorder()
    sums = None
    for rows in feature_tables(filename, subset, sample_weights,
                               drop_columns, energy_key,
                               len(model.bspline_config.element_list)):
        if rows[0].shape[1] != model.n_feats:
            raise ValueError(f"{rows[0].shape[1]} feature columns, the "
                             f"basis has {model.n_feats}")
        grams = table_gram(rows, e_var, f_var)
        del rows   # one table's rows in host memory at a time
        sums = grams if sums is None else [a + b for a, b in zip(sums,
                                                                 grams)]
    if sums is None:
        raise ValueError(f"{filename} holds no row of the keys asked for")
    model.fit_with_gram(*model.weighted_gram(*sums, e_var, f_var,
                                             weight=weight))


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------
class BasicLinearModel:
    """Plain regularized linear regression: the Gram matrix on
    ``device`` (the CUDA card unless ``device="cpu"``; it raises where
    there is none) in float64, the solve on the host in float64."""

    def __init__(self, regularizer: np.ndarray = None, device=None):
        self.device = _resolve_device(device)
        self.coefficients = None
        self.regularizer = regularizer

    def fit(self, x, y, ridge_penalty: float = 1e-8):
        gram, ordinate = moore_penrose_components(x, y, self.device)
        reg = (np.eye(len(gram)) * ridge_penalty
               if self.regularizer is None else self.regularizer)
        self.coefficients = lu_factorization(gram + reg.T @ reg, ordinate)

    def predict(self, x):
        """x @ coefficients: numpy on the host, a tensor on its device."""
        if isinstance(x, torch.Tensor):
            return x @ torch.as_tensor(self.coefficients, dtype=x.dtype,
                                       device=x.device)
        return np.dot(x, self.coefficients)

    def score(self, x, y, weights=None, normalize=True):
        if weights is not None:
            x, y = apply_weights(x, y, weights)
        score = -rmse_metric(y, self.predict(x))
        if normalize:
            score /= np.std(y)
        return score


class WeightedLinearModel(BasicLinearModel):
    """Energy+force weighted regularized least squares over a basis set.

    The Gram matrices are accumulated on ``device`` (the CUDA card unless
    ``device="cpu"``; it raises where there is none) in float64; the
    solve runs on the host in float64."""

    def __init__(self,
                 bspline_config: BSplineBasis,
                 regularizer: np.ndarray = None,
                 data_coverage: np.ndarray = None,
                 device=None,
                 **params):
        super().__init__(regularizer, device)
        self.bspline_config = bspline_config
        n_basis = self.n_feats
        if data_coverage is not None:
            if len(data_coverage) != n_basis:
                raise ValueError(f"Incorrect data_coverage shape: "
                                 f"{len(data_coverage)} != {n_basis}")
            self.data_coverage = np.asarray(data_coverage, dtype=bool)
        else:
            self.data_coverage = np.zeros(n_basis, dtype=bool)
        if self.regularizer is None:
            self.set_params(**params)

    def set_params(self, **params):
        self.bspline_config = params.get("bspline_config",
                                         self.bspline_config)
        try:
            self.regularizer = params["regularizer"]
        except KeyError:
            pass
        if "regularizer" not in params and self.regularizer is None:
            scalars = {k: v for k, v in params.items()
                       if isinstance(v, (int, float, np.floating))}
            self.regularizer = \
                self.bspline_config.get_regularization_matrix(**scalars)

    # -- delegation views onto the basis config ------------------------------
    n_feats = property(lambda self: self.bspline_config.n_feats)
    frozen_c = property(lambda self: self.bspline_config.frozen_c)
    col_idx = property(lambda self: self.bspline_config.col_idx)
    mask = property(
        lambda self: get_freezing_mask(self.n_feats, self.col_idx))

    def __repr__(self):
        fit = "True" if self.coefficients is not None else "False"
        return "\n".join(["WeightedLinearModel:", f"    Fit: {fit}",
                          f"    Device: {self.device}"])

    # -- Gram accumulation on the device -------------------------------------
    def _frozen_rows(self, x, y):
        """Rows as float64 tensors on the model's device, frozen columns
        eliminated."""
        x = torch.as_tensor(x, dtype=torch.float64, device=self.device)
        y = torch.as_tensor(y, dtype=torch.float64, device=self.device)
        return freeze_columns(x, y, self.mask, self.frozen_c, self.col_idx)

    def _gram(self, x, y, batch_size: int):
        """(X^T X, X^T y) of the frozen rows on the device, accumulated
        over row batches of ``batch_size`` (numpy rows cross to the
        device one batch at a time)."""
        n_columns = len(self.mask)
        gram = torch.zeros((n_columns, n_columns), dtype=torch.float64,
                           device=self.device)
        ordinate = torch.zeros(n_columns, dtype=torch.float64,
                               device=self.device)
        for start in range(0, len(y), batch_size):
            xb, yb = self._frozen_rows(x[start:start + batch_size],
                                       y[start:start + batch_size])
            gram += xb.T @ xb
            ordinate += xb.T @ yb
        return gram, ordinate

    def gram_from_batches(self, batches: Iterable,
                          e_variance: VarianceRecorder = None,
                          f_variance: VarianceRecorder = None):
        """Energy and force Gram matrices and ordinates, summed on the
        device over ``batches`` of (x_e, y_e, x_f, y_f) (numpy arrays or
        tensors; rows as ``featurize_dataset_device`` orders them; a
        batch may hold no force rows) or of ``FeatureBatch``es, with the
        frozen columns eliminated; the targets stream into the variance
        recorders when given.  Returns (gram_e, gram_f, ord_e, ord_f) as
        float64 tensors on the device."""
        n_columns = len(self.mask)
        gram_e, gram_f = (torch.zeros((n_columns, n_columns),
                                      dtype=torch.float64, device=self.device)
                          for _ in range(2))
        ord_e, ord_f = (torch.zeros(n_columns, dtype=torch.float64,
                                    device=self.device) for _ in range(2))
        for batch in batches:
            if hasattr(batch, "x_e"):   # a FeatureBatch
                batch = (batch.x_e, batch.y_e, batch.x_f, batch.y_f)
            x_e, y_e, x_f, y_f = batch
            x_e, y_e = self._frozen_rows(x_e, y_e)
            x_f, y_f = self._frozen_rows(x_f, y_f)
            if e_variance is not None and f_variance is not None:
                e_variance.update(_host(y_e))
                f_variance.update(_host(y_f))
            gram_e += x_e.T @ x_e
            ord_e += x_e.T @ y_e
            gram_f += x_f.T @ x_f
            ord_f += x_f.T @ y_f
        return gram_e, gram_f, ord_e, ord_f

    # -- fitting ------------------------------------------------------------
    def fit_with_gram(self, gram, ordinate):
        """Solve the regularized normal equations on the host in float64
        (``gram`` and ``ordinate`` over the unfrozen columns, arrays or
        tensors)."""
        gram = _host(gram).astype(np.float64)
        ordinate = _host(ordinate).astype(np.float64)
        coverage = (np.sum(gram, axis=0) != 0)
        coverage = revert_frozen_coefficients(coverage, self.n_feats,
                                              self.mask, self.frozen_c,
                                              self.col_idx)
        self.data_coverage = np.logical_or(self.data_coverage,
                                           coverage.astype(bool))
        reg = freeze_regularizer(self.regularizer, self.mask)
        coefficients = lu_factorization(gram + reg.T @ reg, ordinate)
        self.coefficients = revert_frozen_coefficients(
            coefficients, self.n_feats, self.mask, self.frozen_c,
            self.col_idx)

    def fit(self, x_e, y_e, x_f=None, y_f=None, weight: float = 0.5,
            batch_size: int = 2500):
        """Fit energy (and force) rows: arrays or tensors, each Gram
        accumulated on the device over row batches of ``batch_size``.
        Without force rows (None, or none at all) the fit takes the
        energy rows alone, as ``fit`` without forces in the reference."""
        y_e_frozen = _host(y_e) - np.dot(_host(x_e)[:, self.col_idx],
                                         self.frozen_c)
        gram_e, ord_e = self._gram(x_e, y_e, batch_size)
        if x_f is not None and len(x_f):
            energy_weight, force_weight = calc_E_F_weights(
                len(y_e), len(y_f), np.std(y_e_frozen), np.std(_host(y_f)))
            gram_f, ord_f = self._gram(x_f, y_f, batch_size)
            gram, ordinate = self.combine_weighted_gram(
                gram_e, gram_f, ord_e, ord_f,
                energy_weight, force_weight, weight)
        else:
            gram, ordinate = gram_e, ord_e
        self.fit_with_gram(gram, ordinate)

    def fit_from_batches(self, batches: Iterable, weight: float = 0.5):
        """Fit over ``batches`` of (x_e, y_e, x_f, y_f): Gram matrices
        summed on the device, the channel weights from the streamed
        targets' variances, the solve on the host; the energy rows
        alone where the batches hold no force row."""
        e_var = VarianceRecorder()
        f_var = VarianceRecorder()
        gram_e, gram_f, ord_e, ord_f = self.gram_from_batches(
            batches, e_variance=e_var, f_variance=f_var)
        self.fit_with_gram(*self.weighted_gram(
            gram_e, gram_f, ord_e, ord_f, e_var, f_var, weight))

    def weighted_gram(self, gram_e, gram_f, ord_e, ord_f,
                      e_variance: VarianceRecorder,
                      f_variance: VarianceRecorder, weight: float = 0.5):
        """The blended (gram, ordinate) of ``gram_from_batches``' sums,
        weighted by the recorded targets' channel weights; the energy
        channel alone where no force row was recorded."""
        if f_variance.n == 0:
            return gram_e, ord_e
        energy_weight, force_weight = calc_E_F_weights(
            e_variance.n, f_variance.n, e_variance.std, f_variance.std)
        return self.combine_weighted_gram(
            gram_e, gram_f, ord_e, ord_f, energy_weight, force_weight,
            weight)

    @staticmethod
    def combine_weighted_gram(gram_e, gram_f, ord_e, ord_f,
                              energy_weight, force_weight, weight):
        gram = (weight * energy_weight ** 2 * gram_e
                + (1 - weight) * force_weight ** 2 * gram_f)
        ordinate = (weight * energy_weight ** 2 * ord_e
                    + (1 - weight) * force_weight ** 2 * ord_f)
        return gram, ordinate

    # -- the features file ----------------------------------------------------
    def fit_from_file(self, filename: str, subset: Collection,
                      weight: float = 0.5, batch_size: int = 2500,
                      sample_weights: Dict = None,
                      energy_key: str = "energy",
                      drop_columns: List[str] = None):
        """Fit the rows of the configurations in ``subset`` of a
        features file, read one table at a time
        (``feature_tables``: energy rows per atom, rows scaled
        by ``sample_weights``, ``drop_columns`` removed, ``energy_key``
        naming the energy rows of an HDF5 store): the Gram matrices
        summed on the device over batches of at most ``batch_size``
        rows, the channel weights from the targets' variances, the
        solve on the host."""
        fit_tables(self, filename, subset,
                   lambda rows, e_var, f_var: self.gram_from_batches(
                       _row_batches(*rows, batch_size), e_var, f_var),
                   weight, sample_weights, energy_key, drop_columns)

    def batched_predict(self, filename: str, keys=None, table_names=None,
                        score: bool = True, drop_columns=None):
        """Targets and predictions (y_e, p_e, y_f, p_f) of the rows of
        ``keys`` (every configuration where None) of a features file
        (of its ``table_names`` where given), predicted table by table
        on the model's device; with ``score`` also the energy and force
        RMSE, printed as the reference prints them (the force RMSE NaN
        where no force row was chosen)."""
        y_e, p_e, y_f, p_f = batched_prediction(
            self, filename, table_names=table_names, subset_keys=keys,
            drop_columns=drop_columns,
            n_elements=len(self.bspline_config.element_list))
        if not score:
            return y_e, p_e, y_f, p_f
        rmse_e = rmse_metric(y_e, p_e)
        rmse_f = rmse_metric(y_f, p_f) if len(y_f) else np.nan
        print(f"RMSE (energy): {rmse_e:.3F}\nRMSE (forces): {rmse_f:.3F}")
        return y_e, p_e, y_f, p_f, rmse_e, rmse_f

    # -- serialization ------------------------------------------------------
    @staticmethod
    def from_dict(config: Dict, device=None) -> "WeightedLinearModel":
        """A model from the dictionary ``as_dict`` (of this package or of
        ``uf3_tpu``) produces."""
        bspline_config = BSplineBasis.from_dict(config)
        model = WeightedLinearModel(
            bspline_config,
            regularizer=config.get("regularizer"),
            data_coverage=config.get("data_coverage"),
            device=device)
        model.load(solution=config)
        return model

    @staticmethod
    def from_json(filename: str, device=None) -> "WeightedLinearModel":
        return WeightedLinearModel.from_dict(
            json_io.load_interaction_map(filename), device=device)

    def as_dict(self) -> Dict:
        solution = io.arrange_coefficients(self.coefficients,
                                           self.bspline_config)
        for trio in self.bspline_config.interactions_map.get(3, []):
            solution[trio] = self.bspline_config.decompress_3B(
                solution[trio], trio)
        return dict(coefficients=solution,
                    knots=self.bspline_config.knots_map,
                    data_coverage=self.data_coverage,
                    **self.bspline_config.as_dict())

    def to_json(self, filename: str):
        json_io.dump_interaction_map(self.as_dict(), filename=filename,
                                     write=True)

    def load(self, solution: Dict = None, filename: str = None):
        """Arrange per-interaction coefficient vectors (3B possibly as a
        full L x M x N grid) into the flat coefficient vector."""
        if filename is not None:
            solution = json_io.load_interaction_map(filename)
        elif solution is None:
            raise ValueError("Neither solution nor filename provided.")
        self.coefficients = io.flat_coefficients(solution,
                                                 self.bspline_config)

    def dump(self):
        return self.as_dict()

    # -- post-processing ----------------------------------------------------
    def fix_repulsion_2b(self, pair, r_target=None, min_curvature=2.0):
        """Replace poorly-covered low-r coefficients with a repulsive
        Taylor extrapolation of the fitted spline."""
        sizes, offsets = self.bspline_config.get_interaction_partitions()
        offset, n_basis = offsets[pair], sizes[pair]
        rows = slice(offset, offset + n_basis)
        c_subset = self.coefficients[rows]
        first_covered = int(np.argmax(self.data_coverage[rows]))
        if first_covered == 0:
            print(f"Coverage is sufficient; no fix applied to {pair}.")
        idx_fix = np.arange(self.bspline_config.leading_trim[2],
                            first_covered)
        knot_sequence = self.bspline_config.knots_map[pair]
        r_centers = knot_sequence[2:n_basis + 2]
        c_new = get_spline_taylor_expansion(
            r_centers[first_covered] if r_target is None else r_target,
            r_centers[idx_fix], c_subset, knot_sequence,
            min_curvature=min_curvature)
        print(f"{pair} Correction: adjusted {len(idx_fix)} coefficients.")
        self.coefficients[offset + idx_fix] = c_new


def get_spline_taylor_expansion(r_target, r, coefficients, knot_sequence,
                                min_curvature=0.0):
    """Second-order Taylor extrapolation of a fitted 1D spline."""
    pt = np.atleast_1d(np.float64(r_target))
    y0 = sp.evaluate_spline(pt, knot_sequence, coefficients, nu=0)[0]
    d1 = sp.evaluate_spline(pt, knot_sequence, coefficients, nu=1)[0]
    d2 = sp.evaluate_spline(pt, knot_sequence, coefficients, nu=2)[0]
    if min_curvature is not None:
        d2 = max(d2, min_curvature)
    dr = np.asarray(r) - r_target
    return y0 + d1 * dr + 0.5 * d2 * dr ** 2


def postprocess_coefficients_2b(coefficients,
                                core_hardness: float = 2.0,
                                min_core: float = 2.0,
                                min_slope: float = 0.1,
                                rounding_factor: int = 3,
                                smooth_cutoff: bool = False,
                                in_place: bool = False) -> np.ndarray:
    """Enforce a repulsive core (and optionally smooth cutoff) on fitted
    pair coefficients."""
    c = coefficients if in_place else np.array(coefficients)
    well_idx = find_pair_potential_well(c, rounding_factor)
    if well_idx > 1:
        # Tiny monotone tie-breaker so flat plateaus resolve rightward.
        tilt = np.arange(well_idx) * 10 ** (-2 * rounding_factor)
        head = np.round(c[:well_idx], rounding_factor) + tilt
        peak_idx = int(np.argmax(head))
        monotone = bool(np.all(np.gradient(head)[:peak_idx] >= 0))
        if monotone:
            # Geometric core: each knot >= hardness x its right neighbor,
            # floored at min_slope; sequential because each step reads
            # the value the previous one just wrote.
            for i in range(peak_idx - 1, -1, -1):
                c[i] = max(abs(c[i + 1]) * core_hardness, min_slope)
    c[0] = max(c[0], min_core)
    if smooth_cutoff:
        c[-2:] = 0
    return c


def find_pair_potential_well(coefficients, rounding_factor) -> int:
    """Index of the attractive minimum; if everything left of the peak is
    flat to rounding precision, place it just past the peak instead."""
    peak_idx, well_idx = np.argmax(coefficients), np.argmin(coefficients)
    flat_tol = 10 ** -(rounding_factor - 1)
    if (well_idx < peak_idx
            and np.ptp(np.round(coefficients[:peak_idx],
                                rounding_factor)) < flat_tol):
        well_idx = peak_idx + 1
    return well_idx


# ---------------------------------------------------------------------------
# prediction / metrics
# ---------------------------------------------------------------------------
def subset_prediction(df, model: BasicLinearModel, subset_keys=None,
                      **kwargs):
    """(y_e, p_e, y_f, p_f) of a ``FeatureTable``'s rows (of the
    configurations in ``subset_keys`` where given), ``kwargs`` passed to
    ``dataframe_to_tuples``."""
    if subset_keys is not None:
        subset = set(subset_keys)
        idx = [name for name in dict.fromkeys(df.names) if name in subset]
        if len(idx) == 0:
            return [], [], [], []
        df = df.select(idx)
    x_e, y_e, x_f, y_f = dataframe_to_tuples(df, **kwargs)
    return y_e, model.predict(x_e), y_f, model.predict(x_f)


def batched_prediction(model: BasicLinearModel, filename: str,
                       table_names=None, subset_keys=None,
                       drop_columns=None, n_elements: int = None):
    """(y_e, p_e, y_f, p_f) of a features file's rows (of the
    configurations in ``subset_keys`` where given), read one table at a
    time (``n_elements`` as ``dataframe_to_tuples`` takes it), the
    products on the model's device in float64."""

    def predict(x):
        return _host(model.predict(torch.as_tensor(
            x, dtype=torch.float64, device=model.device)))

    parts = [(y_e, predict(x_e), y_f, predict(x_f))
             for x_e, y_e, x_f, y_f in feature_tables(
                 filename, subset_keys, drop_columns=drop_columns,
                 n_elements=n_elements, table_names=table_names)]
    if not parts:
        return tuple(np.zeros(0) for _ in range(4))
    return tuple(np.concatenate(column) for column in zip(*parts))


def rmse_metric(predicted, actual) -> float:
    return np.sqrt(np.mean(np.subtract(predicted, actual) ** 2))


def mae_metric(predicted, actual) -> float:
    return np.mean(np.abs(np.subtract(predicted, actual)))
