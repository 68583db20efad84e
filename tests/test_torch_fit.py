"""
The port's fit (``uf3_tpu_torch/regression``, the fitting half of
``representation/basis.py``, ``util/user_config.py`` and the
``featurize`` / ``fit`` / ``predict`` commands) on the CPU in float64,
against ``uf3_tpu``'s ``WeightedLinearModel`` on the same arrays:

- the basis's fitting views (``n_feats``, frozen columns, column names,
  ``compress_3B_batch``, ``as_dict``) equal, the regularizer matrices
  within 1e-12, the regularize module and ``VarianceRecorder`` equal;
- fits of the same rows predict within 1e-8 (the tiny problems are
  ill-conditioned, so predictions are the well-conditioned comparison,
  as in ``tests/test_featurize_device.py``), frozen coefficients kept;
- the twin of ``test_device_fit_matches_host_fit``: the port's device
  rows against the host oracle's dataframe rows, and the fits;
- a model JSON written by either package read by the other, and by the
  port's ``io.load_model`` and ``UFCalculator``;
- the three commands on a JSON settings file with ``--device cpu``.
"""

import json
import os

import numpy as np
import jax.numpy as jnp
import pandas as pd
import pytest
import torch

from uf3_tpu.data.atoms import bulk as j_bulk
from uf3_tpu.data.composition import ChemicalSystem as JChem
from uf3_tpu.forcefield.calculator import UFCalculator as JCalc
from uf3_tpu.ops import pallas_trio as pt
from uf3_tpu.ops import potential as jpot
from uf3_tpu.regression import least_squares as jls
from uf3_tpu.regression import regularize as jreg
from uf3_tpu.representation.basis import BSplineBasis as JBasis
from uf3_tpu.representation.process import BasisFeaturizer
from uf3_tpu.util import json_io as j_json
from uf3_tpu.util import user_config as j_config
from uf3_tpu_torch import io
from uf3_tpu_torch.__main__ import main
from uf3_tpu_torch.data import io as data_io
from uf3_tpu_torch.data.atoms import Atoms, bulk
from uf3_tpu_torch.data.composition import ChemicalSystem
from uf3_tpu_torch.forcefield.calculator import UFCalculator
from uf3_tpu_torch.ops import featurize as tf
from uf3_tpu_torch.ops.potential import UF3Potential
from uf3_tpu_torch.regression import least_squares as ls
from uf3_tpu_torch.regression import regularize as treg
from uf3_tpu_torch.representation.basis import BSplineBasis
from uf3_tpu_torch.util import json_io
from uf3_tpu_torch.util import user_config

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(REPO, "benchmarks_data", "model_2and3.json")
MODELS = [MODEL, os.path.join(REPO, "tests", "data", "model_unary.json"),
          os.path.join(REPO, "tests", "data", "model_binary.json")]
REG_TOL = 1e-12      # regularizer matrices
PREDICT_TOL = 1e-8   # predictions of fits on the same rows
ORACLE_TOL = 1e-9    # device rows against the host featurizer's
TUNGSTEN = dict(
    r_min_map={("W", "W"): 1.5, ("W", "W", "W"): [1.5] * 3},
    r_max_map={("W", "W"): 5.5, ("W", "W", "W"): [3.5, 3.5, 7.0]},
    resolution_map={("W", "W"): 15, ("W", "W", "W"): [6, 6, 12]})


def basis_pair(path):
    config = j_json.load_interaction_map(path)
    return JBasis.from_dict(config), BSplineBasis.from_dict(config)


@pytest.fixture(scope="module")
def tungsten():
    return (JBasis(JChem(["W"], degree=3), **TUNGSTEN),
            BSplineBasis(ChemicalSystem(["W"], degree=3), **TUNGSTEN))


def port_atoms(geom) -> Atoms:
    return Atoms(geom.get_atomic_numbers(), geom.get_positions(),
                 cell=geom.get_cell(), pbc=geom.get_pbc())


def training_set(n=3, reps=2, seed=0):
    """``test_device_fit_matches_host_fit``'s set: rattled bcc W cells
    with random energies and forces."""
    rng = np.random.RandomState(seed)
    geoms, energies, forces = [], [], []
    for i in range(n):
        geom = j_bulk("W", "bcc", a=3.1652) * reps
        geom.rattle(0.04, seed=i)
        geoms.append(geom)
        energies.append(-8.9 * len(geom) + rng.rand())
        forces.append(rng.normal(scale=0.2, size=(len(geom), 3)))
    return geoms, energies, forces


@pytest.mark.parametrize("path", MODELS, ids=os.path.basename)
def test_basis_fitting_views_match_uf3_tpu(path):
    ref, ours = basis_pair(path)
    assert ours.n_feats == ref.n_feats
    assert ours.partition_sizes == ref.partition_sizes
    assert np.array_equal(ours.col_idx, ref.col_idx)
    assert np.array_equal(ours.frozen_c, ref.frozen_c)
    assert ours.get_column_names() == ref.get_column_names()
    if path == MODEL:
        assert (ours.n_feats, ours.partition_sizes, len(ours.col_idx)) \
            == (73, [1, 18, 54], 3)
    grids = np.random.RandomState(1)
    for trio in ours.interactions_map.get(3, []):
        assert np.array_equal(ours.templates[trio], ref.templates[trio])
        shape = ref.templates[trio].shape
        batch = grids.normal(size=(2, 3) + shape)
        assert np.array_equal(ours.compress_3B_batch(batch, trio),
                              ref.compress_3B_batch(batch, trio))
    assert json_io.dump_interaction_map(ours.as_dict()) \
        == j_json.dump_interaction_map(ref.as_dict())


@pytest.mark.parametrize("kwargs", [
    {}, dict(c2=1e-8, c3=1e-8),
    dict(r1=1e-3, r2=1e-4, r3=1e-5, c2=1e-6, c3=1e-7)], ids=str)
@pytest.mark.parametrize("path", [MODELS[0], MODELS[2]],
                         ids=os.path.basename)
def test_regularizer_matches_uf3_tpu(path, kwargs):
    ref, ours = basis_pair(path)
    a = ours.get_regularization_matrix(**kwargs)
    b = ref.get_regularization_matrix(**kwargs)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= REG_TOL


def test_regularize_module_matches_uf3_tpu():
    assert treg.DEFAULT_REGULARIZER_GRID == jreg.DEFAULT_REGULARIZER_GRID
    assert np.array_equal(treg.get_ridge_penalty_matrix(5),
                          jreg.get_ridge_penalty_matrix(5))
    assert np.array_equal(treg.get_curvature_penalty_matrix_1D(7),
                          jreg.get_curvature_penalty_matrix_1D(7))
    assert np.array_equal(treg.get_curvature_penalty_matrix_2D(3, 4),
                          jreg.get_curvature_penalty_matrix_2D(3, 4))
    assert np.array_equal(
        treg.get_curvature_penalty_matrix_3D(3, 4, 2, flatten=False),
        jreg.get_curvature_penalty_matrix_3D(3, 4, 2, flatten=False))
    blocks = [np.ones((2, 3)), np.eye(2)]
    assert np.array_equal(treg.combine_regularizer_matrices(blocks),
                          jreg.combine_regularizer_matrices(blocks))


def test_variance_recorder_matches_uf3_tpu():
    rng = np.random.RandomState(4)
    ours, ref = ls.VarianceRecorder(), jls.VarianceRecorder()
    for size in (5, 1, 17, 0, 9):
        batch = rng.normal(loc=3.0, scale=2.0, size=size)
        assert np.allclose(ours.update(batch), ref.update(batch),
                           rtol=0, atol=0)
    everything = rng.normal(size=3)
    seeded = ls.VarianceRecorder(mean=1.0, std=0.5, n=4)
    ref_seeded = jls.VarianceRecorder(mean=1.0, std=0.5, n=4)
    assert seeded.update(everything) == ref_seeded.update(everything)


def test_frozen_column_helpers_match_uf3_tpu(tungsten):
    ref_basis, basis = tungsten
    model = ls.WeightedLinearModel(basis, device="cpu")
    rng = np.random.RandomState(2)
    x = rng.normal(size=(11, model.n_feats))
    y = rng.normal(size=11)
    frozen_c = rng.normal(size=len(model.col_idx))
    want = jls.freeze_columns(x, y, model.mask, frozen_c, model.col_idx)
    got = ls.freeze_columns(x, y, model.mask, frozen_c, model.col_idx)
    got_t = ls.freeze_columns(torch.as_tensor(x), torch.as_tensor(y),
                              model.mask, frozen_c, model.col_idx)
    for a, b, c in zip(got, want, got_t):
        assert np.array_equal(a, b)
        assert np.abs(c.numpy() - b).max() <= 1e-14
    solution = rng.normal(size=len(model.mask))
    assert np.array_equal(
        ls.revert_frozen_coefficients(solution, model.n_feats, model.mask,
                                      frozen_c, model.col_idx),
        jls.revert_frozen_coefficients(solution, model.n_feats, model.mask,
                                       frozen_c, model.col_idx))
    for args in ((10, 30, 0.5, 0.2), (10, 30, 0.0, 0.2)):
        assert ls.calc_E_F_weights(*args) == jls.calc_E_F_weights(*args)


@pytest.fixture(scope="module")
def device_rows(tungsten):
    """The port's device rows of the training set, and the set."""
    _, basis = tungsten
    geoms, energies, forces = training_set()
    rows = tf.featurize_dataset_device(
        basis, [port_atoms(g) for g in geoms], energies, forces,
        device="cpu")
    return rows, (geoms, energies, forces)


def test_fit_matches_uf3_tpu(tungsten, device_rows):
    """``fit``, ``fit_from_batches`` (two batches of tensors) and
    ``fit_with_gram`` against ``uf3_tpu``'s ``fit`` on the same rows."""
    ref_basis, basis = tungsten
    x_e, y_e, x_f, y_f = device_rows[0]
    # at 1e-6 these rows leave the solve so ill-conditioned that
    # uf3_tpu's own fit of the same rows in another order predicts
    # 6e-9 apart; at 1e-5, 6e-10
    reg = dict(r2=1e-5, c2=1e-5, r3=1e-5, c3=1e-5)
    ref = jls.WeightedLinearModel(ref_basis, **reg)
    ref.fit(x_e, y_e, x_f, y_f)
    ours = ls.WeightedLinearModel(basis, device="cpu", **reg)
    assert np.array_equal(ours.regularizer, ref.regularizer)
    ours.fit(x_e, y_e, x_f, y_f, batch_size=100)
    n_f = len(y_f) // 3
    batched = ls.WeightedLinearModel(basis, device="cpu", **reg)
    batched.fit_from_batches([
        tuple(torch.as_tensor(a) for a in (x_e[:1], y_e[:1], x_f[:n_f],
                                           y_f[:n_f])),
        tuple(torch.as_tensor(a) for a in (x_e[1:], y_e[1:], x_f[n_f:],
                                           y_f[n_f:]))])
    for model in (ours, batched):
        for x in (x_e, x_f):
            assert np.abs(model.predict(x) - ref.predict(x)).max() \
                <= PREDICT_TOL
        assert np.array_equal(model.coefficients[model.col_idx],
                              model.frozen_c)
        assert np.array_equal(model.data_coverage, ref.data_coverage)
    predicted = ours.predict(torch.as_tensor(x_f))
    assert isinstance(predicted, torch.Tensor)
    assert np.abs(predicted.numpy() - ours.predict(x_f)).max() <= 1e-12
    assert ours.score(x_f, y_f) == pytest.approx(ref.score(x_f, y_f),
                                                 rel=1e-9)
    rng = np.random.RandomState(3)
    n = len(ours.mask)
    gram = rng.normal(size=(n, n))
    gram = gram @ gram.T
    ordinate = rng.normal(size=n)
    ours.fit_with_gram(torch.as_tensor(gram), torch.as_tensor(ordinate))
    ref.fit_with_gram(gram, ordinate)
    assert np.abs(ours.coefficients - ref.coefficients).max() <= 1e-10


def test_device_fit_matches_host_fit(tungsten, device_rows):
    """Twin of ``tests/test_featurize_device.py``'s: the host oracle's
    dataframe rows against the port's device rows, and the fits of
    each."""
    ref_basis, basis = tungsten
    x_e, y_e, x_f, y_f = device_rows[0]
    geoms, energies, forces = device_rows[1]
    featurizer = BasisFeaturizer(ref_basis)
    rows = {}
    for i, (geom, energy, force) in enumerate(zip(geoms, energies, forces)):
        rows.update(featurizer.evaluate_configuration(
            geom, name=f"c_{i}", energy=energy, forces=force.T))
    df = pd.DataFrame.from_dict(rows, orient="index",
                                columns=featurizer.columns)
    df.index = pd.MultiIndex.from_tuples(df.index)
    h_e, hy_e, h_f, hy_f = jls.dataframe_to_tuples(df, n_elements=1)
    assert np.abs(x_e - h_e).max() <= ORACLE_TOL
    assert np.abs(x_f - h_f).max() <= ORACLE_TOL
    assert np.allclose(y_e, hy_e, rtol=0, atol=1e-12)
    assert np.allclose(y_f, hy_f, rtol=0, atol=1e-12)
    reg = dict(r2=1e-6, c2=1e-6, r3=1e-6, c3=1e-6)
    host = jls.WeightedLinearModel(ref_basis, **reg)
    host.fit(h_e, hy_e, h_f, hy_f)
    device = ls.WeightedLinearModel(basis, device="cpu", **reg)
    device.fit(x_e, y_e, x_f, y_f)
    for x in (h_e, h_f):
        assert np.abs(device.predict(x) - host.predict(x)).max() \
            <= PREDICT_TOL


def test_model_json_read_by_both_packages(tungsten, device_rows, tmp_path):
    """A fitted model's JSON written by each package, read by the other
    (the same text both ways), by ``io.load_model`` and by
    ``UFCalculator``; ``from_dict`` takes ``uf3_tpu``'s ``as_dict``."""
    ref_basis, basis = tungsten
    x_e, y_e, x_f, y_f = device_rows[0]
    ours = ls.WeightedLinearModel(basis, device="cpu", c2=1e-6, c3=1e-6)
    ours.fit(x_e, y_e, x_f, y_f)
    path_ours = str(tmp_path / "ours.json")
    ours.to_json(path_ours)
    theirs = jls.WeightedLinearModel.from_json(path_ours)
    assert np.array_equal(theirs.coefficients, ours.coefficients)
    assert np.array_equal(theirs.data_coverage, ours.data_coverage)
    path_theirs = str(tmp_path / "theirs.json")
    theirs.to_json(path_theirs)
    assert open(path_ours).read() == open(path_theirs).read()
    back = ls.WeightedLinearModel.from_json(path_theirs, device="cpu")
    assert np.array_equal(back.coefficients, ours.coefficients)
    from_dict = ls.WeightedLinearModel.from_dict(theirs.as_dict(),
                                                 device="cpu")
    assert np.array_equal(from_dict.predict(x_f), theirs.predict(x_f))
    loaded = io.load_model(path_ours)
    assert np.array_equal(loaded.coefficients, ours.coefficients)
    # the fitted model's energy and forces are its predictions on the
    # configuration's rows: exactly on uf3_tpu's host calculator; on the
    # port's (the engine's fused route) within what its uniform cardinal
    # pair path leaves on knots rounded to 1e-10 A, 1.7e-10 eV/atom and
    # 7.0e-10 eV/A on this fitted pair spline, bounded at twice that
    # (ROADMAP.md section 3: 1.5e-5 eV/atom before the legs took the
    # file's knots and the cardinal ends their own interval)
    geom = device_rows[1][0][0]
    n = len(geom)
    host = JCalc(theirs)
    assert host.get_potential_energy(geom) / n == pytest.approx(
        ours.predict(x_e[0]), abs=1e-12)
    assert np.abs(host.get_forces(geom).T.reshape(-1)
                  - ours.predict(x_f[:3 * n])).max() <= 1e-12
    calc = UFCalculator(path_ours, device="cpu")
    assert calc.get_potential_energy(port_atoms(geom)) / n \
        == pytest.approx(ours.predict(x_e[0]), abs=4e-10)
    assert np.abs(calc.get_forces(port_atoms(geom)).T.reshape(-1)
                  - ours.predict(x_f[:3 * n])).max() <= 1.5e-9


@pytest.mark.parametrize("path", MODELS, ids=os.path.basename)
def test_fused_route_matches_host_oracle(path):
    """Fault 2 of ROADMAP.md section 3: the port's fused route (the
    engine's, through ``UFCalculator``) on a model file's own knots
    against ``uf3_tpu``'s host calculator, in float64 on 128 atoms:
    forces within 1e-11 eV/A and energy within 1e-11 eV/atom (1.4e-9
    eV/A when the legs were rebuilt from the first knot gap).  The JAX
    package's specs, through the weights converter, stay off by more."""
    model = jls.WeightedLinearModel.from_json(path)
    elements_ = list(model.bspline_config.element_list)
    base = j_bulk("W", "bcc", a=3.1652) * 4
    numbers = np.full(len(base), el_number(elements_[0]))
    if len(elements_) > 1:
        numbers[np.random.RandomState(0).rand(len(base)) > 0.5] = \
            el_number(elements_[1])
    geom = port_atoms(base)
    geom.numbers = numbers
    geom.rattle(0.05, seed=3)
    jgeom = j_atoms(geom)
    host = JCalc(model)
    e_ref = host.get_potential_energy(jgeom)
    f_ref = host.get_forces(jgeom)
    calc = UFCalculator(path, device="cpu")
    n = len(geom)
    assert abs(calc.get_potential_energy(geom) - e_ref) / n <= 1e-11
    assert np.abs(calc.get_forces(geom) - f_ref).max() <= 1e-11
    if len(elements_) == 1:
        params, _ = jpot.build_potential(model, dtype=jnp.float64)
        trio = pt.build_trio_pallas(model, dtype=jnp.float64)
        spec, coefficients = pt.build_pair_fast(model, dtype=jnp.float64)
        converted = UF3Potential.from_jax_arrays(
            trio._replace(grid=np.asarray(trio.grid)),
            (spec, np.asarray(coefficients)), np.asarray(params.offsets_1b),
            np.asarray(params.z_to_species), float(params.r_cut_2b),
            float(params.r_cut_3b))
        jax_specs = UFCalculator(converted, device="cpu")
        assert np.abs(jax_specs.get_forces(geom) - f_ref).max() > 1e-10


def el_number(symbol) -> int:
    return int(JChem([symbol]).numbers[0])


def j_atoms(geom):
    from uf3_tpu.data.atoms import Atoms as JAtoms
    return JAtoms(numbers=geom.get_atomic_numbers(),
                  positions=geom.get_positions(), cell=geom.get_cell(),
                  pbc=geom.get_pbc())


# penalties at 1 make these few rows a well-posed problem, whose two
# solutions differ by the summation order of their Gram matrices alone:
# coefficients 3e-14-8e-12 of the largest apart, predictions 3e-15-5e-12
# eV (at 1e-3, 2e-11-6e-9 and 1e-13-4e-11)
WELL_POSED = dict(r1=1.0, r2=1.0, r3=1.0, c2=1.0, c3=1.0)


def _fits(ref_basis, basis, rows, ref_rows=None):
    """The port's ``fit`` and ``fit_from_batches`` (the energy rows of
    two configurations in a batch of their own, with no force row)
    against ``uf3_tpu``'s ``fit`` of ``ref_rows`` (the same rows, or
    without force rows where there are none): predictions within 1e-12
    of the largest target, coefficients within 1e-10 of the largest."""
    x_e, y_e, x_f, y_f = rows
    ref = jls.WeightedLinearModel(ref_basis, **WELL_POSED)
    ref.fit(*(ref_rows or rows))
    scale = np.abs(ref.coefficients).max()
    ours = ls.WeightedLinearModel(basis, device="cpu", **WELL_POSED)
    ours.fit(x_e, y_e, x_f, y_f)
    batched = ls.WeightedLinearModel(basis, device="cpu", **WELL_POSED)
    batched.fit_from_batches([
        tuple(torch.as_tensor(a) for a in (x_e[:2], y_e[:2], x_f[:0],
                                           y_f[:0])),
        tuple(torch.as_tensor(a) for a in (x_e[2:], y_e[2:], x_f, y_f))])
    y_scale = max(np.abs(y).max() for y in (y_e, y_f) if len(y))
    for model in (ours, batched):
        assert np.abs(model.coefficients - ref.coefficients).max() \
            <= 1e-10 * scale
        for x in (x_e, x_f):
            if len(x):
                assert np.abs(model.predict(x) - ref.predict(x)).max() \
                    <= 1e-12 * y_scale
    return ours


def test_fit_with_energy_only_configurations_matches_uf3_tpu(tungsten):
    """A training set where configurations 1 and 3 have no forces, and
    one where none has (``fit_forces`` off): the device rows, the fits
    against ``uf3_tpu``'s on the same rows."""
    ref_basis, basis = tungsten
    geoms, energies, forces = training_set(n=5)
    some = [None if i in (1, 3) else f for i, f in enumerate(forces)]
    rows = tf.featurize_dataset_device(
        basis, [port_atoms(g) for g in geoms], energies, some,
        device="cpu")
    assert rows[0].shape[0] == 5 and rows[2].shape[0] == 3 * 3 * 16
    full = tf.featurize_dataset_device(
        basis, [port_atoms(g) for g in geoms], energies, forces,
        device="cpu")
    keep = np.concatenate([np.arange(48 * i, 48 * (i + 1))
                           for i in (0, 2, 4)])
    assert np.array_equal(rows[0], full[0])
    assert np.array_equal(rows[2], full[2][keep])
    assert np.array_equal(rows[3], full[3][keep])
    _fits(ref_basis, basis, rows)
    featurizer = tf.Featurizer(basis, fit_forces=False, device="cpu")
    assert featurizer.route == "device"
    energy_only = featurizer.featurize_dataset(
        [port_atoms(g) for g in geoms], energies, forces)
    assert energy_only[2].shape == (0, basis.n_feats)
    assert list(featurizer.force_rows(geoms, forces)) == [0] * 5
    _fits(ref_basis, basis, energy_only, ref_rows=energy_only[:2])


def test_multi_species_fit_matches_uf3_tpu():
    """Rows of the Ne/Xe 2+3-body ``species23``-shaped basis (r 1-5 A,
    resolution 8) from the multi-species dataset path, one configuration
    without forces, fitted by both packages."""
    from uf3_tpu.data.atoms import Atoms as JAtoms
    maps = dict(r_min_map=1.0, r_max_map=5.0, resolution_map=8)
    ref_basis = JBasis(JChem(["Ne", "Xe"], degree=3), **maps)
    basis = BSplineBasis(ChemicalSystem(["Ne", "Xe"], degree=3), **maps)
    rng = np.random.RandomState(8)
    geoms, energies, forces = [], [], []
    for i, reps in enumerate([2, 2, 2, 2]):
        base = j_bulk("Ne", "fcc", a=5.4) * reps
        numbers = np.asarray(base.get_atomic_numbers()).copy()
        numbers[rng.rand(len(numbers)) > 0.5] = 54
        geom = JAtoms(numbers=numbers, positions=base.get_positions(),
                      cell=base.get_cell(), pbc=True)
        geom.rattle(0.1, seed=i)
        geoms.append(port_atoms(geom))
        energies.append(float(-0.05 * len(geom) + rng.rand()))
        forces.append(None if i == 1 else
                      rng.normal(scale=0.05, size=(len(geom), 3)))
    stats = {}
    rows = tf.featurize_dataset_device(basis, geoms, energies, forces,
                                       device="cpu", stats=stats)
    assert stats["route"] == "device multi"
    assert rows[0].shape == (4, basis.n_feats)
    assert rows[2].shape == (3 * 3 * 32, basis.n_feats)
    ours = _fits(ref_basis, basis, rows)
    assert np.array_equal(ours.coefficients[ours.col_idx], ours.frozen_c)


def write_sources(directory, n=4):
    """Write extended-xyz training data: rattled bcc W 2^3 cells labeled
    by the bench model on the CPU."""
    calc = UFCalculator(MODEL, device="cpu")
    frames = []
    for i in range(n):
        geom = bulk("W", "bcc", a=3.1652) * 2
        geom.rattle(0.05, seed=i)
        geom.info["energy"] = calc.get_potential_energy(geom)
        for c, name in enumerate(("fx", "fy", "fz")):
            geom.arrays[name] = calc.get_forces(geom)[:, c]
        frames.append(geom)
    os.makedirs(directory)
    data_io.write_xyz(os.path.join(directory, "train.xyz"), frames)


def settings_file(tmp_path, features="features.npz"):
    settings = {
        "elements": ["W"], "degree": 3,
        "data": {"sources": {"path": str(tmp_path / "data"),
                             "pattern": "*.xyz"}},
        "basis": {"r_min": 1.5, "r_max": 5.5, "resolution": 12},
        "features": {"features_path": str(tmp_path / features)},
        "model": {"model_path": str(tmp_path / "model.json")},
        "learning": {"features_path": str(tmp_path / features),
                     "regularizer": {"curvature_2b": 1e-6,
                                     "curvature_3b": 1e-6}}}
    path = tmp_path / "settings.json"
    path.write_text(json.dumps(settings))
    return str(path)


def test_fit_commands_on_the_cpu(tmp_path, capsys):
    """``featurize``, ``fit`` and ``predict`` on a JSON settings file
    (which ``uf3_tpu``'s ``read_config`` reads to the same basis) with
    ``--device cpu``: the features file holds ``featurize_dataset_device``'s
    rows, the model is ``WeightedLinearModel.fit``'s and loads in
    ``uf3_tpu``, ``predict`` prints its RMSE, and ``md`` runs it."""
    write_sources(str(tmp_path / "data"))
    path = settings_file(tmp_path)
    main(["featurize", path, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "4 configurations" in out
    settings = user_config.read_config(path)
    handlers = user_config.generate_handlers(settings, device="cpu")
    ref_handlers = j_config.generate_handlers(j_config.read_config(path))
    assert json_io.dump_interaction_map(handlers["basis"].as_dict()) \
        == j_json.dump_interaction_map(ref_handlers["basis"].as_dict())
    with np.load(settings["features"]["features_path"]) as data:
        stored = {k: data[k] for k in data.files}
    assert list(stored["keys"]) == [f"train.xyz_{i}" for i in range(4)]
    assert list(stored["sizes"]) == [16] * 4
    assert list(stored["columns"]) == handlers["basis"].get_column_names()
    frames = data_io.read_xyz(str(tmp_path / "data" / "train.xyz"))
    rows = tf.featurize_dataset_device(
        handlers["basis"], frames, [f.info["energy"] for f in frames],
        [np.stack([f.arrays[c] for c in ("fx", "fy", "fz")], 1)
         for f in frames], device="cpu")
    for key, want in zip(("x_e", "y_e", "x_f", "y_f"), rows):
        assert np.abs(stored[key] - want).max() <= 1e-12, key
    main(["fit", path, "--device", "cpu"])
    model_path = settings["model"]["model_path"]
    assert f"model written to {model_path}" in capsys.readouterr().out
    fitted = ls.WeightedLinearModel.from_json(model_path, device="cpu")
    direct = handlers["learning"]
    direct.fit(*rows)
    assert np.abs(fitted.predict(rows[2]) - direct.predict(rows[2])).max() \
        <= 1e-10
    assert np.array_equal(jls.WeightedLinearModel.from_json(
        model_path).coefficients, fitted.coefficients)
    main(["predict", path, "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("RMSE (energy): ")
    assert out[1].startswith("RMSE (forces): ")
    rmse_f = ls.rmse_metric(rows[3], fitted.predict(rows[2]))
    assert f"RMSE (forces, eV/A): {rmse_f:.6e}" in out[2]
    main(["md", model_path, "--reps", "2", "--steps", "12",
          "--device", "cpu"])
    assert "12 steps in" in capsys.readouterr().out


def test_fit_commands_run_on_the_card_by_default(tmp_path, monkeypatch):
    path = settings_file(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for command in ("featurize", "fit", "predict"):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            main([command, path])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ls.WeightedLinearModel(io.load_model(MODEL).bspline_config)
