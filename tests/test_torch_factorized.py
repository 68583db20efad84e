"""
The port's general (factorized) force path against the JAX package's,
in float64 on the CPU, from the same numpy inputs:

- ``uf3_tpu_torch/ops/spline_jax.py`` against ``uf3_tpu/ops/spline_jax.py``:
  ``find_interval`` and ``deboor_values`` (nu = 0, 1) on random r over
  non-uniform knots (1e-12), the host tables (1e-14), ``eval_pair_tables``
  and ``tricubic_eval`` (1e-12);
- the host coefficient split and the multi-species 3-body grids;
- ``FactorizedPotential`` against ``PotentialParams``: the tables it
  builds itself equal the JAX tables (1e-14), and every evaluation below
  runs on ``FactorizedPotential.from_jax_params`` of the JAX tables;
- ``pair_contributions`` and ``pair_contributions_fast`` (against both
  JAX functions, 1e-10) on the four model files, the two trio routes
  (1e-10) on the unary model and on a random binary 2+3-body model, and
  ``compute_energy_forces`` with its virial (1e-9, the JAX tests' own
  tolerance).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uf3_tpu.data.atoms import Atoms, bulk
from uf3_tpu.data.composition import ChemicalSystem
from uf3_tpu.forcefield.calculator import coefficients_by_interaction
from uf3_tpu.ops import neighbors as jnb
from uf3_tpu.ops import potential as jpot
from uf3_tpu.ops import spline_jax as jsj
from uf3_tpu.regression import least_squares as ls
from uf3_tpu.representation.basis import BSplineBasis
from uf3_tpu_torch import io
from uf3_tpu_torch.data import composition as t_comp
from uf3_tpu_torch.forcefield.md import MDSystem
from uf3_tpu_torch.ops import factorized as fz
from uf3_tpu_torch.ops import neighbors as tnb
from uf3_tpu_torch.ops import spline_jax as tsj
from uf3_tpu_torch.representation import basis as t_basis

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of a thread per core oversubscribes them
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = {"unary": os.path.join(REPO, "tests", "data", "model_unary.json"),
         "model_2": os.path.join(REPO, "benchmarks_data", "model_2.json"),
         "binary": os.path.join(REPO, "tests", "data", "model_binary.json"),
         "pair": os.path.join(REPO, "benchmarks_data", "model_pair.json")}
TOL = 1e-10


def random_binary_model():
    """Ne/Xe, degree 3, r 1.0-5.0 A, resolution 8, coefficients from
    RandomState(11) at scale 0.05 (the model of the JAX package's
    test_multi_fused_matches_factorized): (JAX model, port model)."""
    chem = ChemicalSystem(["Ne", "Xe"], degree=3)
    basis = BSplineBasis(chem, r_min_map=1.0, r_max_map=5.0,
                         resolution_map=8)
    model = ls.WeightedLinearModel(basis)
    model.coefficients = np.random.RandomState(11).normal(
        scale=0.05, size=sum(basis.partition_sizes))
    port_basis = t_basis.BSplineBasis(
        t_comp.ChemicalSystem(["Ne", "Xe"], degree=3), r_min_map=1.0,
        r_max_map=5.0, resolution_map=8)
    return model, io.FittedModel(port_basis, model.coefficients.copy())


def _binary_geom(reps, a, seed, rattle=0.08):
    rng = np.random.RandomState(seed)
    base = bulk("Ne", "fcc", a=a) * reps
    numbers = base.get_atomic_numbers()
    numbers[rng.rand(len(numbers)) > 0.5] = 54
    geom = Atoms(numbers=numbers, positions=base.positions, cell=base.cell,
                 pbc=True)
    geom.rattle(rattle, seed=1)
    return geom


def port_list(nbr):
    """A JAX NeighborList as the port's, on the CPU."""
    return tnb.NeighborList(
        idx=torch.tensor(np.asarray(nbr.idx), dtype=torch.int64),
        shift=torch.tensor(np.asarray(nbr.shift)),
        mask=torch.tensor(np.asarray(nbr.mask)),
        rev=torch.tensor(np.asarray(nbr.rev), dtype=torch.int64),
        overflow=torch.tensor(bool(nbr.overflow)),
        reference_positions=torch.tensor(
            np.asarray(nbr.reference_positions)))


def _np(out):
    return tuple(np.asarray(x) for x in out)


def _case(jax_model, geom, cap2, cap3=None):
    """The port's potential from the JAX tables, the species and lists
    (the 3-body list with reverse slots) as the port's, and every JAX
    result the tests read, as numpy: computed here, in the module
    fixture, before the JAX caches are first cleared."""
    params, static = jpot.build_potential(jax_model, dtype=jnp.float64)
    species = params.z_to_species[jnp.asarray(geom.numbers)]
    pos, cell = jnp.asarray(geom.positions), jnp.asarray(geom.cell)
    nbr2 = jnb.build_neighbor_list(pos, cell, geom.pbc,
                                   float(params.r_cut_2b), cap2)
    assert not bool(nbr2.overflow)
    args = (species, pos, cell)
    ref = dict(pair=_np(jpot.pair_contributions(params, *args, nbr2)),
               pair_fast=_np(jpot.pair_contributions_fast(
                   params, static, *args, nbr2)))
    nbr3 = None
    if static.trio_specs:
        nbr3 = jnb.build_neighbor_list(pos, cell, geom.pbc,
                                       float(params.r_cut_3b), cap3)
        assert not bool(nbr3.overflow)
        ref["trio_factorized"] = _np(jpot.trio_contributions_factorized(
            params, static, *args, nbr3))
        ref["trio_table"] = _np(jpot.trio_contributions(params, *args,
                                                        nbr3))
    for fast in (True, False):
        ref[f"total_{fast}"] = _np(jpot.compute_energy_forces(
            params, *args, nbr2, nbr3, static=static if fast else None))
    return dict(params=jax.tree_util.tree_map(np.asarray, params),
                static=static, ref=ref, geom=geom,
                port=fz.FactorizedPotential.from_jax_params(params, static),
                species=torch.tensor(np.asarray(species), dtype=torch.int64),
                pos=torch.tensor(np.asarray(pos)),
                cell=torch.tensor(np.asarray(cell)), nbr2=port_list(nbr2),
                nbr3=None if nbr3 is None else port_list(nbr3))


@pytest.fixture(scope="module")
def cases():
    """The four model files and the random binary 2+3-body model, each
    on a rattled periodic cell wider than twice its cutoffs (the two
    unary files share one cell, the two binary files another)."""
    w = bulk("W", "bcc", a=3.16) * 4
    w.rattle(0.05, seed=3)
    ne_xe = _binary_geom(4, 5.2, 0)
    out = {}
    for name, path in FILES.items():
        model = ls.WeightedLinearModel.from_json(path)
        if name in ("unary", "model_2"):
            out[name] = _case(model, w, 64, 24)
        else:
            out[name] = _case(model, ne_xe, 80)
    jax_model, _ = random_binary_model()
    out["random_binary"] = _case(jax_model, _binary_geom(3, 5.4, 11), 32,
                                 24)
    return out


# -- splines ----------------------------------------------------------------
def _knots(seed=0):
    """A clamped sequence with random (non-uniform) interior knots."""
    inner = np.sort(np.random.RandomState(seed).uniform(1.2, 5.8, 9))
    return np.concatenate([[1.0] * 4, inner, [6.0] * 4])


@pytest.mark.parametrize("nu", [0, 1])
def test_deboor_values_match_jax(nu):
    seq = _knots()
    r = np.concatenate([np.random.RandomState(1).uniform(0.9, 6.1, 2001),
                        seq])
    vj, ij = jsj.deboor_values_jax(jnp.asarray(r), jnp.asarray(seq), nu=nu)
    vt, it = tsj.deboor_values(torch.tensor(r), torch.tensor(seq), nu=nu)
    assert np.array_equal(np.asarray(ij), it.numpy())
    assert np.abs(np.asarray(vj) - vt.numpy()).max() < 1e-12
    assert np.abs(vt.numpy()).max() > 0.1
    n = len(seq) - 4
    assert np.array_equal(
        np.asarray(jsj.find_interval(jnp.asarray(r), jnp.asarray(seq), n)),
        tsj.find_interval(torch.tensor(r), torch.tensor(seq), n).numpy())


def test_dense_leg_basis_matches_jax():
    seq = _knots(2)
    r = np.random.RandomState(3).uniform(0.9, 6.1, (40, 7))
    valid = np.random.RandomState(4).rand(40, 7) > 0.2
    n = len(seq) - 4
    b, db = fz._dense_leg_basis(torch.tensor(r), torch.tensor(seq), n,
                                torch.tensor(valid))
    for nu, ours in ((0, b), (1, db)):
        ref = jpot._dense_leg_basis(jnp.asarray(r), jnp.asarray(seq), n,
                                    jnp.asarray(valid), nu=nu)
        assert np.abs(np.asarray(ref) - ours.numpy()).max() < 1e-12


def test_tables_and_their_evaluation_match_jax():
    seqs = [_knots(5), _knots(6), np.concatenate(
        [[1.0] * 4, np.sort(np.random.RandomState(7).uniform(1.1, 11.9, 14)),
         [12.0] * 4])]
    rng = np.random.RandomState(8)
    coefficients = rng.normal(size=len(seqs[0]) - 4)
    for a, b in zip(jsj.build_pair_tables(seqs[0], coefficients),
                    tsj.build_pair_tables(seqs[0], coefficients)):
        assert np.abs(np.asarray(a) - b).max() < 1e-14
    grid = rng.normal(size=tuple(len(s) - 4 for s in seqs))
    poly_j, breaks_j = jsj.build_trio_tables(seqs, grid)
    poly_t, breaks_t = tsj.build_trio_tables(seqs, grid)
    assert np.abs(poly_j - poly_t).max() < 1e-14
    for a, b in zip(breaks_j, breaks_t):
        assert np.abs(a - b).max() < 1e-14
    poly_e, poly_f, breaks = tsj.build_pair_tables(seqs[0], coefficients)
    interior = seqs[0][3:-3]
    r = rng.uniform(0.9, 6.1, 500)
    ref = jsj.eval_pair_tables(jnp.asarray(r), *(jnp.asarray(x) for x in (
        poly_e, poly_f, breaks, interior)))
    ours = tsj.eval_pair_tables(torch.tensor(r), *(torch.tensor(x) for x in (
        poly_e, poly_f, breaks, interior)))
    for a, b in zip(ref, ours):
        assert np.abs(np.asarray(a) - b.numpy()).max() < 1e-12
    cells = rng.normal(size=(300, 64))
    u, v, w = (rng.uniform(0.0, 1.0, 300) for _ in range(3))
    ref = jsj.tricubic_eval(*(jnp.asarray(x) for x in (cells, u, v, w)))
    ours = tsj.tricubic_eval(*(torch.tensor(x) for x in (cells, u, v, w)))
    for a, b in zip(ref, ours):
        assert np.abs(np.asarray(a) - b.numpy()).max() < 1e-12


# -- host tables ----------------------------------------------------------------
def _port_model(name):
    if name == "random_binary":
        return random_binary_model()[1]
    return io.load_model(FILES[name])


@pytest.mark.parametrize("name", list(FILES) + ["random_binary"])
def test_tables_match_jax_params(cases, name):
    """FactorizedPotential.from_model builds the JAX tables itself; the
    host split by ``io.arrange_coefficients`` gives the pieces of
    ``coefficients_by_interaction`` (1-body entries as scalars)."""
    params, static = cases[name]["params"], cases[name]["static"]
    model = _port_model(name)
    ours = fz.FactorizedPotential.from_model(model)
    assert ours.n_pair_types == static.n_pair_types
    assert ours.trio_specs == tuple(tuple(s) for s in static.trio_specs)
    assert ours.r_cut_2b == float(params.r_cut_2b)
    assert ours.r_cut_3b == float(params.r_cut_3b)
    for field in fz.TABLES:
        a, b = np.asarray(getattr(params, field)), getattr(ours, field)
        assert a.shape == tuple(b.shape), field
        assert np.array_equal(np.isinf(a), np.isinf(b.numpy())), field
        fin = np.isfinite(a)
        assert np.abs(a[fin] - b.numpy()[fin]).max(initial=0.0) < 1e-14, \
            field
    config = model.bspline_config
    ref = coefficients_by_interaction(
        config.element_list, config.interactions_map, config.partition_sizes,
        model.coefficients)
    split = io.arrange_coefficients(model.coefficients, config)
    assert split.keys() == ref.keys()
    for key in ref:
        assert np.array_equal(np.atleast_1d(split[key]), ref[key]), key


def test_multi_species_grids_match_jax():
    """decompress_3B of every trio of the binary 2+3-body model, both
    leg orders, as the JAX package's basis gives them."""
    jax_model, port_model = random_binary_model()
    ref, ours = jax_model.bspline_config, port_model.bspline_config
    split = io.arrange_coefficients(port_model.coefficients, ours)
    trios = ours.interactions_map[3]
    assert len(trios) == 6 and trios == ref.interactions_map[3]
    for trio in trios:
        grid = ours.decompress_3B(split[trio], trio)
        assert np.array_equal(grid, ref.decompress_3B(split[trio], trio))
        assert ours.symmetry[trio] == ref.symmetry[trio]
        if trio[1] == trio[2]:
            assert np.array_equal(grid, grid.transpose(1, 0, 2))


# -- evaluation -----------------------------------------------------------------
def _close(want, ours, tol=TOL):
    return all(np.abs(a - b.numpy()).max() < tol for a, b in zip(want, ours))


@pytest.mark.parametrize("name", list(FILES))
def test_pair_contributions_match_jax(cases, name):
    """Both port functions against both JAX functions."""
    c = cases[name]
    args = (c["species"], c["pos"], c["cell"], c["nbr2"])
    for ours in (fz.pair_contributions(c["port"], *args),
                 fz.pair_contributions_fast(c["port"], *args)):
        assert _close(c["ref"]["pair"], ours)
        assert _close(c["ref"]["pair_fast"], ours)
    assert np.abs(c["ref"]["pair"][1]).max() > 1e-3


@pytest.mark.parametrize("name", ["unary", "random_binary"])
def test_trio_contributions_match_jax(cases, name):
    c = cases[name]
    args = (c["species"], c["pos"], c["cell"], c["nbr3"])
    ours = fz.trio_contributions_factorized(c["port"], *args)
    assert _close(c["ref"]["trio_factorized"], ours)
    ours_table = fz.trio_contributions(c["port"], *args)
    assert _close(c["ref"]["trio_table"], ours_table)
    # the two routes evaluate one spline
    assert torch.max(torch.abs(ours[1] - ours_table[1])) < 1e-9
    assert float(torch.max(torch.abs(ours[1]))) > 1e-3


@pytest.mark.parametrize("name", list(FILES) + ["random_binary"])
@pytest.mark.parametrize("static", [True, False])
def test_compute_energy_forces_matches_jax(cases, name, static):
    c = cases[name]
    ours = fz.compute_energy_forces(c["port"], c["species"], c["pos"],
                                    c["cell"], c["nbr2"], c["nbr3"],
                                    static=static)
    assert _close(c["ref"][f"total_{static}"], ours, 1e-9)
    assert ours[2].shape == (3, 3)


def test_multi_fused_matches_factorized(cases):
    """Twin of test_multi_fused_matches_factorized: the port's engine on
    the random binary 2+3-body model, built from the model itself (the
    fused multi-species route, as the JAX engine routes it) and from the
    JAX tables (a ``FactorizedPotential``, which runs the factorized
    path alone), against JAX compute_energy_forces with ``static`` on
    the same positions: energy, forces and virial within 1e-9."""
    c = cases["random_binary"]
    e_j, f_j, v_j = c["ref"]["total_True"]
    for model in (c["port"], random_binary_model()[1]):
        port = MDSystem(model, c["geom"], dtype=torch.float64, device="cpu",
                        rebuild_every=5)
        assert port.potential.trio is None and port.degree == 3
        assert port._multi_route() == (model is not c["port"])
        state = port.init_state(temperature=10.0, seed=0)
        energy, forces, virial = port.energy_forces(
            state.positions, state.nbr2, state.nbr3, with_virial=True)
        assert abs(float(energy) - float(e_j)) < 1e-9
        assert np.abs(forces.numpy() - f_j).max() < 1e-9
        assert np.abs(virial.numpy() - v_j).max() < 1e-9
