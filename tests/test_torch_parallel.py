"""
The port's shard mesh (``uf3_tpu_torch/parallel/mesh.py``) within one
process on a mesh of 8 shards, against the JAX package's mesh on its
8-device virtual CPU mesh, in float64 from the same numpy inputs: twins
of the 4 tests of ``tests/test_parallel.py`` (the sharded Gram on rows
that do not divide by 8, the sharded fit, the replicated-positions MD
chunk at 128 atoms, and the streaming fit from a features file, here the
``.npz`` that ``featurize`` writes, holding the rows of the reference
test's two HDF5 tables).
"""

import os

import numpy as np
import pytest
import torch

from uf3_tpu.data.atoms import bulk as jbulk
from uf3_tpu.data.composition import ChemicalSystem as JaxChemicalSystem
from uf3_tpu.parallel import mesh as jmesh
from uf3_tpu.regression import least_squares as jls
from uf3_tpu.representation.basis import BSplineBasis as JaxBSplineBasis
from uf3_tpu_torch.data.atoms import bulk
from uf3_tpu_torch.data.composition import ChemicalSystem
from uf3_tpu_torch.forcefield import units
from uf3_tpu_torch.forcefield.md import MDSystem
from uf3_tpu_torch.parallel import mesh
from uf3_tpu_torch.regression import least_squares as ls
from uf3_tpu_torch.representation.basis import BSplineBasis

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of a thread per core oversubscribes them
torch.set_num_threads(1)

MODEL = os.path.join("benchmarks_data", "model_2and3.json")


@pytest.fixture(scope="module")
def mesh8():
    return mesh.make_mesh(8, device="cpu")


@pytest.fixture(scope="module")
def jax_mesh8():
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jmesh.make_mesh(8)


def test_sharded_gram_matches_host(mesh8, jax_mesh8):
    rng = np.random.RandomState(0)
    x = rng.rand(103, 17)  # deliberately not divisible by 8
    y = rng.rand(103)
    mesh8.reset_traffic()
    gram, ordinate = mesh.sharded_gram(x, y, mesh8)
    assert np.allclose(gram.numpy(), x.T @ x)
    assert np.allclose(ordinate.numpy(), x.T @ y)
    j_gram, j_ord = jmesh.sharded_gram(x, y, jax_mesh8)
    assert np.allclose(gram.numpy(), np.asarray(j_gram), atol=1e-12)
    assert np.allclose(ordinate.numpy(), np.asarray(j_ord), atol=1e-12)
    # one psum of the Gram matrix and one of the ordinate
    assert mesh8.traffic["psum"] == [17 * 17, 17]


def test_fit_sharded_matches_host(mesh8, jax_mesh8):
    config = BSplineBasis(ChemicalSystem(["Al"]))
    n_features = sum(config.partition_sizes)
    rng = np.random.RandomState(1)
    x_e = rng.rand(40, n_features)
    y_e = rng.rand(40)
    x_f = rng.rand(200, n_features)
    y_f = rng.rand(200)
    host = ls.WeightedLinearModel(config, device="cpu")
    host.fit(x_e, y_e, x_f, y_f)
    sharded = ls.WeightedLinearModel(config, device="cpu")
    mesh.fit_sharded(sharded, x_e, y_e, x_f, y_f, mesh=mesh8)
    assert np.allclose(sharded.coefficients, host.coefficients, atol=1e-8)
    j_config = JaxBSplineBasis(JaxChemicalSystem(["Al"]))
    j_sharded = jls.WeightedLinearModel(j_config)
    jmesh.fit_sharded(j_sharded, x_e, y_e, x_f, y_f, mesh=jax_mesh8)
    assert np.allclose(sharded.coefficients, j_sharded.coefficients,
                       atol=1e-8)


def test_sharded_md_matches_single_device(mesh8, jax_mesh8):
    """The mesh-sharded NVE chunk reproduces the single-device
    trajectory (f64, deterministic NVE), and the JAX package's sharded
    chunk."""
    import jax.numpy as jnp
    from uf3_tpu.forcefield.md import MDSystem as JaxMDSystem

    geom = bulk("W", "bcc", a=3.1652) * 4   # 128 atoms = 16 per shard
    geom.rattle(0.03, seed=6)
    system = MDSystem(MODEL, geom, dtype=torch.float64, capacity_2b=64,
                      capacity_3b=16, device="cpu")
    state = system.init_state(temperature=120.0, seed=1)
    dt = 1.0 * units.fs
    n_steps = 5
    m = system.masses[:, None]
    x, v, f = state.positions, state.velocities, state.forces
    for _ in range(n_steps):
        v = v + 0.5 * dt * f / m
        x = x + dt * v
        _, f, _ = system.energy_forces(x, state.nbr2, state.nbr3,
                                       with_energy=False)
        v = v + 0.5 * dt * f / m
    e_ref, f_ref, _ = system.energy_forces(x, state.nbr2, state.nbr3)
    mesh8.reset_traffic()
    chunk, shard_atoms = mesh.sharded_md_step_factory(system, mesh8,
                                                      n_steps=n_steps)
    xs, vs, fs, es = chunk(state.positions, state.velocities, state.forces,
                           shard_atoms(state.nbr2), shard_atoms(state.nbr3),
                           dt)
    assert torch.allclose(xs, x, atol=1e-12, rtol=0)
    assert torch.allclose(vs, v, atol=1e-12, rtol=0)
    assert torch.allclose(fs, f_ref, atol=1e-10, rtol=0)
    assert abs(float(es - e_ref)) < 1e-10
    # one all_gather of every shard's partials and row forces per force
    assert len(mesh8.traffic["all_gather"]) == n_steps + 1
    # the JAX package's chunk from the same positions and velocities
    j_geom = jbulk("W", "bcc", a=3.1652) * 4
    j_geom.rattle(0.03, seed=6)
    model = jls.WeightedLinearModel.from_json(MODEL)
    j_system = JaxMDSystem(model, j_geom, dtype=jnp.float64,
                           capacity_2b=64, capacity_3b=16)
    j_state = j_system.init_state(velocities=state.velocities.numpy())
    j_chunk, j_shard = jmesh.sharded_md_step_factory(j_system, jax_mesh8,
                                                     n_steps=n_steps)
    jx, jv, jf, je = j_chunk(j_state.positions, j_state.velocities,
                             j_state.forces, j_shard(j_state.nbr2),
                             j_shard(j_state.nbr3),
                             jnp.asarray(dt, dtype=jnp.float64))
    assert np.allclose(xs.numpy(), np.asarray(jx), atol=1e-12)
    assert np.allclose(vs.numpy(), np.asarray(jv), atol=1e-12)
    assert np.allclose(fs.numpy(), np.asarray(jf), atol=1e-9)
    assert abs(float(es) - float(je)) < 1e-9 * abs(float(je))


def _dimer_features(tmp_path):
    """The reference test's six W dimers featurized by ``uf3_tpu``: its
    two HDF5 tables, and an ``.npz`` of the same rows as ``featurize``
    writes it (energy rows per atom, force rows after them)."""
    import pandas as pd

    from uf3_tpu.data.atoms import Atoms
    from uf3_tpu.representation.process import (BasisFeaturizer,
                                                save_feature_db)

    config = JaxBSplineBasis(JaxChemicalSystem(["W"]),
                             r_min_map={("W", "W"): 1.5},
                             r_max_map={("W", "W"): 5.5},
                             resolution_map={("W", "W"): 12})
    featurizer = BasisFeaturizer(config)
    rng = np.random.RandomState(2)
    rows = {}
    for i in range(6):
        geom = Atoms("W2", positions=[[0, 0, 0], [2.2 + 0.2 * i, 0, 0]],
                     pbc=False)
        rows.update(featurizer.evaluate_configuration(
            geom, name=f"0_{i}", energy=-1.0 + 0.1 * i,
            forces=rng.normal(size=(3, 2)) * 0.1))
    df = pd.DataFrame.from_dict(rows, orient="index",
                                columns=featurizer.columns)
    df.index = pd.MultiIndex.from_tuples(df.index)
    h5 = str(tmp_path / "features.h5")
    save_feature_db(df.iloc[:df.shape[0] // 2], h5,
                    table_name="features_000")
    save_feature_db(df.iloc[df.shape[0] // 2:], h5,
                    table_name="features_001")
    keys = [f"0_{i}" for i in range(6)]
    x_e, y_e, x_f, y_f = jls.dataframe_to_tuples(df, n_elements=1)
    npz = str(tmp_path / "features.npz")
    with open(npz, "wb") as f:
        np.savez(f, x_e=x_e, y_e=y_e, x_f=x_f, y_f=y_f, keys=np.array(keys),
                 sizes=np.full(6, 2), force_rows=np.full(6, 6),
                 columns=np.array(list(df.columns)))
    return config, df, h5, npz, keys


def test_fit_from_file_sharded_matches_host(mesh8, tmp_path):
    """The mesh fit of a features file (sharded Gram, sample
    weights) on the ``.npz`` and on ``uf3_tpu``'s HDF5 tables
    reproduces ``uf3_tpu``'s host ``fit_from_file`` on those tables."""
    j_config, df, h5, npz, keys = _dimer_features(tmp_path)
    config = BSplineBasis(ChemicalSystem(["W"]),
                          r_min_map={("W", "W"): 1.5},
                          r_max_map={("W", "W"): 5.5},
                          resolution_map={("W", "W"): 12})
    weights = {k: 1.0 + 0.2 * i for i, k in enumerate(keys)}
    # the tiny dimer problem is rank-deficient, so raw coefficients
    # amplify summation-order noise; regularize and compare predictions
    host = jls.WeightedLinearModel(j_config, r2=1e-6, c2=1e-6)
    host.fit_from_file(h5, subset=keys, weight=0.3, sample_weights=weights)
    sharded = ls.WeightedLinearModel(config, r2=1e-6, c2=1e-6, device="cpu")
    mesh.fit_from_file_sharded(sharded, npz, subset=keys, weight=0.3,
                               mesh=mesh8, sample_weights=weights)
    probe = df.to_numpy()[:, 1:]
    assert np.allclose(probe @ sharded.coefficients,
                       probe @ host.coefficients, atol=1e-8)
    unweighted = ls.WeightedLinearModel(config, r2=1e-6, c2=1e-6,
                                        device="cpu")
    mesh.fit_from_file_sharded(unweighted, npz, subset=keys, weight=0.3,
                               mesh=mesh8)
    assert not np.allclose(probe @ unweighted.coefficients,
                           probe @ host.coefficients, atol=1e-8)
    # a subset reaches the rows too
    j_sub = jls.WeightedLinearModel(j_config, r2=1e-6, c2=1e-6)
    j_sub.fit_from_file(h5, subset=keys[1:], weight=0.3)
    sub = ls.WeightedLinearModel(config, r2=1e-6, c2=1e-6, device="cpu")
    mesh.fit_from_file_sharded(sub, npz, subset=keys[1:], weight=0.3,
                               mesh=mesh8)
    assert np.allclose(probe @ sub.coefficients, probe @ j_sub.coefficients,
                       atol=1e-8)
    with pytest.raises(ValueError, match="one energy column"):
        mesh.fit_from_file_sharded(sub, npz, subset=keys, mesh=mesh8,
                                   energy_key="energy_dft")
    # the reference's HDF5 tables read by the port, table by table
    from_h5 = ls.WeightedLinearModel(config, r2=1e-6, c2=1e-6, device="cpu")
    mesh.fit_from_file_sharded(from_h5, h5, subset=keys, weight=0.3,
                               mesh=mesh8, sample_weights=weights)
    assert np.allclose(probe @ from_h5.coefficients,
                       probe @ host.coefficients, atol=1e-8)
