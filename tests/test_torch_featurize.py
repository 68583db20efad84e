"""
The port's device featurizer (``uf3_tpu_torch/ops/featurize.py``) on the
CPU in float64, against the host oracle ``BasisFeaturizer``
(``uf3_tpu/representation/process.py``) and the JAX package's device
featurizer (``uf3_tpu/ops/featurize_jax.py``) on the same configurations:

- twins of ``test_device_matches_host_featurizer`` (both cases) and
  ``test_multi_device_matches_host_featurizer`` (both seeds)
  (``tests/test_featurize_device.py``): features within 1e-9 of the
  oracle and 1e-10 of ``uf3_tpu``'s ``featurize_device`` /
  ``featurize_device_multi``;
- a basis whose 3-body legs reach past the pair cutoff, held to the
  oracle only (the JAX dataset path sizes both lists from the pair
  cutoff, ROADMAP.md section 3): the configuration path and the dataset
  path;
- the dataset path against ``uf3_tpu``'s ``featurize_dataset_device``,
  and its redo of a configuration whose estimated capacity overflowed.
"""

import numpy as np
import pytest
import torch

from uf3_tpu.data.atoms import Atoms as JAtoms
from uf3_tpu.data.atoms import bulk as j_bulk
from uf3_tpu.data.composition import ChemicalSystem as JChem
from uf3_tpu.ops import featurize_jax as fj
from uf3_tpu.representation.basis import BSplineBasis as JBasis
from uf3_tpu.representation.process import BasisFeaturizer
from uf3_tpu_torch.data.atoms import Atoms
from uf3_tpu_torch.data.composition import ChemicalSystem
from uf3_tpu_torch.ops import featurize as tf
from uf3_tpu_torch.ops import neighbors as nb
from uf3_tpu_torch.representation.basis import BSplineBasis

torch.set_num_threads(1)

ORACLE_TOL = 1e-9   # against the host featurizer (tests/test_featurize_device.py)
JAX_TOL = 1e-10     # against uf3_tpu's device featurizer, the same algebra


def both_bases(elements, **maps):
    return (JBasis(JChem(elements, degree=3), **maps),
            BSplineBasis(ChemicalSystem(elements, degree=3), **maps))


TUNGSTEN = dict(
    r_min_map={("W", "W"): 1.5, ("W", "W", "W"): [1.5] * 3},
    r_max_map={("W", "W"): 5.5, ("W", "W", "W"): [3.5, 3.5, 7.0]},
    resolution_map={("W", "W"): 15, ("W", "W", "W"): [6, 6, 12]})
# 3-body legs (5.5, 5.5, 11) A past the 3 A pair cutoff
LONG_LEGS = dict(
    r_min_map={("W", "W"): 1.5, ("W", "W", "W"): [1.5] * 3},
    r_max_map={("W", "W"): 3.0, ("W", "W", "W"): [5.5, 5.5, 11.0]},
    resolution_map={("W", "W"): 8, ("W", "W", "W"): [5, 5, 10]})


@pytest.fixture(scope="module")
def tungsten():
    return both_bases(["W"], **TUNGSTEN)


@pytest.fixture(scope="module")
def binary():
    """Ne-Xe binary with asymmetric per-interaction ranges and
    resolutions (``tests/test_featurize_device.py``'s ``binary_basis``)."""
    chem = JChem(["Ne", "Xe"], degree=3)
    r_min = {pair: 1.5 for pair in chem.interactions_map[2]}
    r_min.update({trio: [1.5] * 3 for trio in chem.interactions_map[3]})
    r_max = {("Ne", "Ne"): 4.5, ("Ne", "Xe"): 5.0, ("Xe", "Xe"): 5.5}
    res = {("Ne", "Ne"): 12, ("Ne", "Xe"): 14, ("Xe", "Xe"): 15}
    for trio in chem.interactions_map[3]:
        pairs = [tuple(sorted(p, key=["Ne", "Xe"].index))
                 for p in ((trio[0], trio[1]), (trio[0], trio[2]))]
        r_max[trio] = [min(3.5, r_max[p]) for p in pairs] + [7.0]
        res[trio] = [5, 6, 12]
    return both_bases(["Ne", "Xe"], r_min_map=r_min, r_max_map=r_max,
                      resolution_map=res)


def port_atoms(geom) -> Atoms:
    return Atoms(geom.get_atomic_numbers(), geom.get_positions(),
                 cell=geom.get_cell(), pbc=geom.get_pbc())


class DeepOracle(BasisFeaturizer):
    """The host featurizer on a ghost supercell twice as deep as its
    own.  Its own (``geo.get_supercell`` at the basis's ``r_cut``) holds
    the ghost centers within ``r_cut`` of the cell but not their other
    neighbor when that lies further out, so in a cell smaller than the
    3-body legs it drops force terms of in-cell atoms (its energies stay
    exact): bcc W 1^3 with (5.5, 5.5, 11) A legs, 0.42 against the
    finite differences of its own energy features, which the port
    matches to 5e-9."""
    r_cut = property(lambda self: 2.0 * self.bspline_config.r_cut)


def oracle(jbasis, geom, featurizer=BasisFeaturizer):
    """(energy vector, force features (N, 3, F)) of the host featurizer,
    without the target column."""
    n_atoms = len(geom)
    ref = featurizer(jbasis).evaluate_configuration(
        geom, energy=0.0, forces=np.zeros((3, n_atoms)))
    return (np.array(ref["energy"])[1:],
            np.stack([[np.array(ref[f"f{c}_{a}"])[1:] for c in "xyz"]
                      for a in range(n_atoms)]))


def tungsten_cell(reps, seed, rattle=0.05):
    geom = j_bulk("W", "bcc", a=3.1652) * reps
    geom.rattle(rattle, seed=seed)
    return geom


@pytest.mark.parametrize("reps,seed", [(2, 0), (3, 7)])
def test_device_matches_host_featurizer(tungsten, reps, seed):
    jbasis, tbasis = tungsten
    geom = tungsten_cell(reps, seed)
    e_ref, f_ref = oracle(jbasis, geom)
    e_jax, f_jax = fj.featurize_configuration_device(
        jbasis, geom, fj.build_featurize_spec(jbasis))
    spec = tf.build_featurize_spec(tbasis)
    assert spec is not None
    e_dev, f_dev = tf.featurize_configuration_device(
        tbasis, port_atoms(geom), spec, device="cpu")
    assert e_dev.shape == e_ref.shape == (tbasis.n_feats,) \
        and f_dev.shape == f_ref.shape
    assert np.abs(e_dev - e_ref).max() <= ORACLE_TOL
    assert np.abs(f_dev - f_ref).max() <= ORACLE_TOL
    assert np.abs(e_dev - e_jax).max() <= JAX_TOL
    assert np.abs(f_dev - f_jax).max() <= JAX_TOL


def test_featurize_device_matches_uf3_tpu_grids(tungsten):
    """``featurize_device`` itself on the same lists as ``uf3_tpu``'s
    (its host lists): the uncompressed 2-body and 3-body energy and force
    grids, single and as a batch of two."""
    jbasis, tbasis = tungsten
    geom = tungsten_cell(2, 3)
    jspec = fj.build_featurize_spec(jbasis)
    lists = [fj.host_neighbor_arrays(geom, r, cap) for r, cap in
             ((jspec.pair.t_max, 96), (jspec.trio_l.t_max, 48))]
    ref = fj.featurize_device(jspec, geom.get_positions(), geom.get_cell(),
                              *lists[0], *lists[1])
    args = [torch.as_tensor(geom.get_positions()),
            torch.as_tensor(geom.get_cell())]
    for idx, shift, mask, rev in lists:
        args += [torch.as_tensor(idx, dtype=torch.int64),
                 torch.as_tensor(shift), torch.as_tensor(mask),
                 torch.as_tensor(rev, dtype=torch.int64)]
    spec = tf.build_featurize_spec(tbasis)
    ours = tf.featurize_device(spec, *args)
    stacked = tf.featurize_device(spec, *(torch.stack([a, a]) for a in args))
    for a, b, c in zip(ours, ref, stacked):
        assert a.shape == np.shape(b)
        assert np.abs(a.numpy() - np.asarray(b)).max() <= JAX_TOL
        assert torch.equal(c[0], c[1])
        assert (c[0] - a).abs().max() <= 1e-12


@pytest.mark.parametrize("seed", [0, 5])
def test_multi_device_matches_host_featurizer(binary, seed):
    jbasis, tbasis = binary
    base = j_bulk("Ne", "fcc", a=5.2) * 2
    numbers = np.asarray(base.get_atomic_numbers()).copy()
    rng = np.random.RandomState(seed)
    numbers[rng.choice(len(numbers), size=len(numbers) // 2,
                       replace=False)] = 54
    geom = JAtoms(numbers=numbers, positions=base.get_positions(),
                  cell=base.get_cell(), pbc=True)
    geom.rattle(0.08, seed=seed)
    e_ref, f_ref = oracle(jbasis, geom)
    mspec = tf.build_featurize_spec_multi(tbasis)
    assert mspec is not None and len(mspec.trios) == 6
    e_dev, f_dev = tf.featurize_configuration_device_multi(
        tbasis, port_atoms(geom), mspec, device="cpu")
    assert e_dev.shape == e_ref.shape and f_dev.shape == f_ref.shape
    assert np.abs(e_dev - e_ref).max() <= ORACLE_TOL
    assert np.abs(f_dev - f_ref).max() <= ORACLE_TOL
    if seed == 0:   # the JAX twin compiles for ~10 s: one seed
        e_jax, f_jax = fj.featurize_configuration_device_multi(jbasis, geom)
        assert np.abs(e_dev - e_jax).max() <= JAX_TOL
        assert np.abs(f_dev - f_jax).max() <= JAX_TOL


@pytest.mark.parametrize("reps", [1, 2])
def test_long_trio_legs_match_host_oracle(reps):
    """3-body legs past the pair cutoff, in cells so small that the
    3-body list needs more images than the 2-body one (bcc W 1^3: 1 and
    2; ``uf3_tpu``'s dataset path takes the pair's and is off by 0.16
    there): the configuration path and the dataset path against the host
    oracle on a supercell deep enough for these legs."""
    jbasis, tbasis = both_bases(["W"], **LONG_LEGS)
    spec = tf.build_featurize_spec(tbasis)
    assert spec.trio_l.t_max > spec.pair.t_max
    geoms = [tungsten_cell(reps, seed, rattle=0.1) for seed in (1, 2)]
    cell = geoms[0].get_cell()
    assert nb.images_required(cell, (True,) * 3, spec.trio_l.t_max) \
        != nb.images_required(cell, (True,) * 3, spec.pair.t_max) \
        or reps == 2
    refs = [oracle(jbasis, g, DeepOracle) for g in geoms]
    for geom, (e_ref, f_ref) in zip(geoms, refs):
        e_dev, f_dev = tf.featurize_configuration_device(
            tbasis, port_atoms(geom), spec, device="cpu")
        assert np.abs(e_dev - e_ref).max() <= ORACLE_TOL
        assert np.abs(f_dev - f_ref).max() <= ORACLE_TOL
    forces = [np.zeros((len(g), 3)) for g in geoms]
    x_e, _, x_f, _ = tf.featurize_dataset_device(
        tbasis, [port_atoms(g) for g in geoms], [0.0, 0.0], forces,
        device="cpu")
    n = len(geoms[0])
    for i, (e_ref, f_ref) in enumerate(refs):
        assert np.abs(x_e[i] - e_ref / n).max() <= ORACLE_TOL
        rows = f_ref.transpose(1, 0, 2).reshape(3 * n, -1)
        assert np.abs(x_f[3 * n * i:3 * n * (i + 1)] - rows).max() \
            <= ORACLE_TOL


def dataset(reps_list, seed=0):
    rng = np.random.RandomState(seed)
    geoms, energies, forces = [], [], []
    for i, reps in enumerate(reps_list):
        geom = tungsten_cell(reps, i, rattle=0.04)
        geoms.append(geom)
        energies.append(-8.9 * len(geom) + rng.rand())
        forces.append(rng.normal(scale=0.2, size=(len(geom), 3)))
    return geoms, energies, forces


def test_dataset_matches_uf3_tpu_dataset(tungsten):
    """``featurize_dataset_device`` against ``uf3_tpu``'s on a dataset
    of two shapes (rows in the same order; ``uf3_tpu``'s lists are
    complete for this basis, whose legs stay inside the pair cutoff)."""
    jbasis, tbasis = tungsten
    geoms, energies, forces = dataset([2, 3, 2])
    ref = fj.featurize_dataset_device(jbasis, geoms, energies, forces)
    stats = {}
    ours = tf.featurize_dataset_device(
        tbasis, [port_atoms(g) for g in geoms], energies, forces,
        device="cpu", stats=stats)
    for a, b in zip(ours, ref):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= JAX_TOL
    assert stats["redos"] == 0 and stats["calls"] == 2


def test_dataset_redoes_overflowed_configurations(tungsten, monkeypatch):
    """Estimated capacities that every list overflows: each
    configuration is built again at its measured count and featurized
    alone, with the same rows as at capacities that hold."""
    _, tbasis = tungsten
    geoms, energies, forces = dataset([2, 2])
    geoms = [port_atoms(g) for g in geoms]
    stats = {}
    full = tf.featurize_dataset_device(tbasis, geoms, energies, forces,
                                       device="cpu", stats=stats)
    assert stats["redos"] == 0
    monkeypatch.setattr(nb, "estimate_capacity", lambda *a, **k: 4)
    stats = {}
    redone = list(tf.featurize_batches(tbasis, geoms, energies, forces,
                                       device="cpu", stats=stats))
    assert stats["redos"] == 2 and stats["calls"] == 3
    assert sorted(i for b in redone for i in b.index) == [0, 1]
    again = tf.featurize_dataset_device(tbasis, geoms, energies, forces,
                                        device="cpu")
    for a, b in zip(again, full):
        assert np.abs(a - b).max() <= 1e-12


def test_featurizer_runs_on_the_card_by_default(tungsten, monkeypatch):
    _, tbasis = tungsten
    geoms, energies, forces = dataset([2])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tf.featurize_dataset_device(tbasis, [port_atoms(geoms[0])],
                                    energies, forces)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tf.featurize_configuration_device(tbasis, port_atoms(geoms[0]))
