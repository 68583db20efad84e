"""
The port's multi-species device dataset path (``featurize_batches`` /
``featurize_dataset_device`` on ``featurize_device_multi``, in
``uf3_tpu_torch/ops/featurize.py``) and the ``featurize`` command's
routes, on the CPU in float64:

- the dataset rows of the random-range Ne/Xe 2+3-body basis and of
  ``benchmarks_data/model_pair.json``'s 2-body Ne/Xe basis against the
  host oracle, ``uf3_tpu``'s ``BasisFeaturizer`` (1e-9), a configuration
  without forces among them;
- per configuration against ``uf3_tpu``'s ``featurize_device_multi``
  (1e-10);
- a batched call against one call per configuration (1e-12), and the
  redo of configurations whose estimated capacities overflow;
- fault 1 of ROADMAP.md section 3: three bcc W 2^3 frames in an
  extended-xyz file, the middle one without forces, through both
  packages' ``featurize`` commands: 49, 1 and 49 rows, equal features,
  on the unary and the multi-species device routes; and the host route
  (knots with no closed form) against ``uf3_tpu``'s ``BasisFeaturizer``.
"""

import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

from uf3_tpu import __main__ as j_main
from uf3_tpu import native as j_native
from uf3_tpu.data.atoms import Atoms as JAtoms
from uf3_tpu.data.atoms import bulk as j_bulk
from uf3_tpu.data.composition import ChemicalSystem as JChem
from uf3_tpu.ops import featurize_jax as fj
from uf3_tpu.regression import least_squares as jls
from uf3_tpu.representation import process as j_process
from uf3_tpu.representation.basis import BSplineBasis as JBasis
from uf3_tpu.util import json_io as j_json
from uf3_tpu_torch.__main__ import main
from uf3_tpu_torch.data import io as data_io
from uf3_tpu_torch.data.atoms import Atoms, bulk
from uf3_tpu_torch.data.composition import ChemicalSystem
from uf3_tpu_torch.ops import featurize as tf
from uf3_tpu_torch.ops import neighbors as nb
from uf3_tpu_torch.representation.basis import BSplineBasis
from uf3_tpu_torch.util import json_io

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_PAIR = os.path.join(REPO, "benchmarks_data", "model_pair.json")
ORACLE_TOL = 1e-9   # against the host featurizer
JAX_TOL = 1e-10     # against uf3_tpu's device featurizer, the same algebra
BATCH_TOL = 1e-12   # a batched call against one call per configuration


def binary_bases():
    """Ne-Xe 2+3-body with asymmetric per-interaction ranges and
    resolutions (``tests/test_torch_featurize.py``'s ``binary``)."""
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
    maps = dict(r_min_map=r_min, r_max_map=r_max, resolution_map=res)
    return (JBasis(chem, **maps),
            BSplineBasis(ChemicalSystem(["Ne", "Xe"], degree=3), **maps))


def pair_bases():
    """The 2-body Ne/Xe basis of ``model_pair.json`` (r 2-8 A)."""
    return (JBasis.from_dict(j_json.load_interaction_map(MODEL_PAIR)),
            BSplineBasis.from_dict(json_io.load_interaction_map(MODEL_PAIR)))


BASES = {"binary 2+3-body": binary_bases, "model_pair 2-body": pair_bases}


@pytest.fixture(scope="module", params=list(BASES))
def bases(request):
    return request.param, BASES[request.param]()


def ne_xe(reps, seed, a=5.2, rattle=0.08) -> JAtoms:
    """fcc Ne at ``a``, half the sites Xe by a seeded draw, rattled."""
    base = j_bulk("Ne", "fcc", a=a) * reps
    numbers = np.asarray(base.get_atomic_numbers()).copy()
    rng = np.random.RandomState(seed)
    numbers[rng.choice(len(numbers), size=len(numbers) // 2,
                       replace=False)] = 54
    geom = JAtoms(numbers=numbers, positions=base.get_positions(),
                  cell=base.get_cell(), pbc=True)
    geom.rattle(rattle, seed=seed)
    return geom


def port_atoms(geom) -> Atoms:
    return Atoms(geom.get_atomic_numbers(), geom.get_positions(),
                 cell=geom.get_cell(), pbc=geom.get_pbc())


def dataset(seed=0):
    """Ne/Xe cells of two shapes (32 and 16 atoms), random energies and
    forces; configuration 2 has no forces."""
    rng = np.random.RandomState(seed)
    geoms = [ne_xe(reps, seed + i) for i, reps in
             enumerate([(2, 2, 2), (2, 2, 1), (2, 2, 2), (2, 2, 1),
                        (2, 2, 2)])]
    energies = [float(rng.normal() - 0.02 * len(g)) for g in geoms]
    forces = [rng.normal(scale=0.1, size=(len(g), 3)) for g in geoms]
    forces[2] = None
    return geoms, energies, forces


def deep_r_cut(self):
    """The ghost supercell's depth for uf3_tpu's host featurizer: twice
    the basis's cutoff.  Its own (the cutoff) drops force terms of
    in-cell atoms in cells smaller than the 3-body legs (ROADMAP.md
    section 3; ``DeepOracle`` in tests/test_torch_featurize.py)."""
    return 2.0 * self.bspline_config.r_cut


class DeepOracle(j_process.BasisFeaturizer):
    r_cut = property(deep_r_cut)


def oracle_rows(jbasis, geoms, energies, forces):
    """uf3_tpu's host featurizer on each configuration, on a supercell
    deep enough, its rows split by ``dataframe_to_tuples``."""
    featurizer = DeepOracle(jbasis)
    rows = {}
    for i, (geom, energy, force) in enumerate(zip(geoms, energies, forces)):
        rows.update(featurizer.evaluate_configuration(
            geom, name=f"c_{i}", energy=energy,
            forces=None if force is None else force.T))
    df = pd.DataFrame.from_dict(rows, orient="index",
                                columns=featurizer.columns)
    df.index = pd.MultiIndex.from_tuples(df.index)
    return jls.dataframe_to_tuples(
        df, n_elements=len(jbasis.element_list))


@pytest.fixture(scope="module")
def rows(bases):
    """The port's dataset rows of ``dataset()`` for each basis."""
    name, (jbasis, tbasis) = bases
    geoms, energies, forces = dataset()
    stats = {}
    ours = tf.featurize_dataset_device(
        tbasis, [port_atoms(g) for g in geoms], energies, forces,
        device="cpu", stats=stats)
    return name, ours, stats


def test_dataset_matches_host_oracle(bases, rows):
    """Rows within 1e-9 of the host oracle's, in its order: energies per
    atom, then the force rows of the configurations that have forces."""
    name, (jbasis, tbasis) = bases
    _, ours, stats = rows
    geoms, energies, forces = dataset()
    ref = oracle_rows(jbasis, geoms, energies, forces)
    assert stats["route"] == "device multi" and stats["redos"] == 0
    assert stats["calls"] == 2   # one per shape
    n_force = 3 * sum(len(g) for g, f in zip(geoms, forces) if f is not None)
    assert ours[2].shape == (n_force, tbasis.n_feats)
    for a, b in zip(ours, ref):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= ORACLE_TOL
    if name == "binary 2+3-body":
        assert len(tf.build_featurize_spec_multi(tbasis).trios) == 6
    else:
        assert tbasis.degree == 2


def test_configuration_matches_uf3_tpu_device(bases, rows):
    """``featurize_device_multi`` on ``uf3_tpu``'s own lists of one
    configuration against ``uf3_tpu``'s ``featurize_device_multi``: the
    uncompressed 2-body blocks and 3-body grids (1e-10); and that
    configuration's dataset rows against its features compressed on the
    host, as ``featurize_configuration_device_multi`` compresses them
    (1e-10)."""
    _, (jbasis, tbasis) = bases
    _, (x_e, _, x_f, _), _ = rows
    geoms, _, _ = dataset()
    geom = geoms[1]
    n = len(geom)
    jspec = fj.build_featurize_spec_multi(jbasis)
    mspec = tf.build_featurize_spec_multi(tbasis)
    lists = [fj._measured_neighbors(geom, max(
        pb.spec.t_max for pb in jspec.pairs))[:4]]
    if jspec.trios:
        lists.append(fj._measured_neighbors(geom, max(
            max(tb.spec_l1.t_max, tb.spec_l2.t_max)
            for tb in jspec.trios))[:4])
    else:
        lists.append((np.zeros((n, 1), dtype=np.int32), np.zeros((n, 1, 3)),
                      np.zeros((n, 1), dtype=bool),
                      np.zeros((n, 1), dtype=np.int32)))
    species = np.searchsorted([10, 54], geom.get_atomic_numbers())
    ref = fj.featurize_device_multi(
        jspec, species, geom.get_positions(), geom.get_cell(),
        *(a for lst in lists for a in lst))
    args = [torch.as_tensor(species), torch.as_tensor(geom.get_positions()),
            torch.as_tensor(geom.get_cell())]
    for idx, shift, mask, rev in lists:
        args += [torch.as_tensor(np.asarray(idx), dtype=torch.int64),
                 torch.as_tensor(np.asarray(shift)),
                 torch.as_tensor(np.asarray(mask)),
                 torch.as_tensor(np.asarray(rev), dtype=torch.int64)]
    ours = tf.featurize_device_multi(mspec, *args)
    for part_ours, part_ref in zip(ours, ref):
        assert len(part_ours) == len(part_ref)
        for a, b in zip(part_ours, part_ref):
            assert a.shape == np.shape(b)
            assert np.abs(a.numpy() - np.asarray(b)).max() <= JAX_TOL
    e2, f2, e3, f3 = (tuple(np.asarray(b) for b in part) for part in ref)
    trios = jbasis.interactions_map[3] if jbasis.degree > 2 else []
    e_jax = np.concatenate(
        [np.bincount(species, minlength=2).astype(float), *e2]
        + [jbasis.compress_3B(g, t) for g, t in zip(e3, trios)])
    f_jax = np.concatenate(
        [np.zeros((n, 3, 2)), *f2]
        + [jbasis.compress_3B_batch(g, t) for g, t in zip(f3, trios)],
        axis=2)
    assert np.abs(x_e[1] * n - e_jax).max() <= JAX_TOL
    offset = 3 * len(geoms[0])
    assert np.abs(x_f[offset:offset + 3 * n]
                  - f_jax.transpose(1, 0, 2).reshape(3 * n, -1)).max() \
        <= JAX_TOL


def test_batch_matches_one_by_one(bases, rows):
    """Configurations of a shape in one call (the dataset path's
    buckets) against one call each, and against ``featurize_device_multi``
    on a stack of two copies of one configuration's lists."""
    _, (_, tbasis) = bases
    _, ours, _ = rows
    geoms, energies, forces = dataset()
    stats = {}
    alone = tf.featurize_dataset_device(
        tbasis, [port_atoms(g) for g in geoms], energies, forces,
        device="cpu", batch_size=1, stats=stats)
    assert stats["calls"] == len(geoms)
    for a, b in zip(ours, alone):
        assert np.abs(a - b).max() <= BATCH_TOL
    # the batched function itself: one configuration twice
    plan = tf.device_plan(tbasis, device="cpu")
    geom = port_atoms(geoms[0])
    cell, pbc = tf._cell_of(geom, torch.float64, "cpu")
    x = tf._positions(geom, cell, pbc, torch.float64, "cpu")
    species = tf._species(geom, plan, "cpu")
    l2 = tf._measured(x, cell, pbc, plan.r2, tf._images(
        cell.numpy(), pbc, plan.r2), False)
    lists = [l2]
    if plan.r3 is not None:
        lists.append(tf._measured(x, cell, pbc, plan.r3, tf._images(
            cell.numpy(), pbc, plan.r3), True))
    one = plan.assemble(x[None], cell[None], species[None],
                        *(tf._stack([n]) for n in lists),
                        *([None] if plan.r3 is None else []))
    two = plan.assemble(torch.stack([x, x]), torch.stack([cell, cell]),
                        torch.stack([species, species]),
                        *(tf._stack([n, n]) for n in lists),
                        *([None] if plan.r3 is None else []))
    for a, b in zip(one, two):
        assert torch.equal(b[0], b[1])
        assert (b[0] - a[0]).abs().max() <= BATCH_TOL


def test_dataset_redoes_overflowed_configurations(bases, rows,
                                                  monkeypatch):
    """Estimated capacities that every list overflows: each
    configuration is built again at its measured count and featurized
    alone, with the same rows."""
    _, (_, tbasis) = bases
    _, ours, _ = rows
    geoms, energies, forces = dataset()
    monkeypatch.setattr(nb, "estimate_capacity", lambda *a, **k: 4)
    stats = {}
    redone = tf.featurize_dataset_device(
        tbasis, [port_atoms(g) for g in geoms], energies, forces,
        device="cpu", stats=stats)
    assert stats["redos"] == len(geoms)
    assert stats["calls"] == 2 + len(geoms)
    for a, b in zip(redone, ours):
        assert np.abs(a - b).max() <= BATCH_TOL


# -- fault 1: configurations without forces ------------------------------
def write_frames(directory):
    """Three rattled bcc W 2^3 frames with energies; the middle one
    without forces (ROADMAP.md section 3's probe)."""
    frames = []
    rng = np.random.RandomState(5)
    for i in range(3):
        geom = bulk("W", "bcc", a=3.1652) * 2
        geom.rattle(0.05, seed=i)
        geom.info["energy"] = float(-8.9 * len(geom) + rng.rand())
        if i != 1:
            force = rng.normal(scale=0.2, size=(len(geom), 3))
            for c, name in enumerate(("fx", "fy", "fz")):
                geom.arrays[name] = force[:, c]
        frames.append(geom)
    os.makedirs(directory)
    data_io.write_xyz(os.path.join(directory, "train.xyz"), frames)


def settings_file(tmp_path, tag, features, degree):
    settings = {
        "elements": ["W"], "degree": degree,
        "data": {"sources": {"path": str(tmp_path / "data"),
                             "pattern": "*.xyz"}},
        "basis": {"r_min": 1.5, "r_max": 5.5, "resolution": 12},
        "features": {"features_path": str(tmp_path / features),
                     "n_cores": 1}}
    path = tmp_path / f"settings_{tag}.json"
    path.write_text(json.dumps(settings))
    return str(path)


@pytest.mark.parametrize("degree, route", [(3, "device"),
                                           (2, "device multi")])
def test_energy_only_configuration_twin(tmp_path, capsys, monkeypatch,
                                        degree, route):
    """Both packages' ``featurize`` commands on the three frames: 49, 1
    and 49 rows, and the same features (1e-9).  ``uf3_tpu`` reads the
    file with its Python parser: its native extxyz tokenizer reads the
    frame without forces as zero forces, and its featurizer runs on a
    supercell deep enough for these 3-body legs in a 6.3 A cell
    (ROADMAP.md section 3)."""
    write_frames(str(tmp_path / "data"))
    ref_path = settings_file(tmp_path, "ref", "features.h5", degree)
    monkeypatch.setattr(j_native, "available", lambda: False)
    monkeypatch.setattr(j_process.BasisFeaturizer, "r_cut",
                        property(deep_r_cut))
    j_main.cmd_featurize(ref_path)
    frames = []
    for table in j_process.analyze_hdf_tables(
            str(tmp_path / "features.h5"))[2]:
        frames.append(j_process.load_feature_db(
            str(tmp_path / "features.h5"), table))
    df = pd.concat(frames)
    names = df.index.get_level_values(0)
    counts = [int(np.sum(names == n)) for n in pd.unique(names)]
    assert counts == [49, 1, 49]
    ref = jls.dataframe_to_tuples(df, n_elements=1)
    path = settings_file(tmp_path, "port", "features.npz", degree)
    main(["featurize", path, "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"route: {route} (" in out
    with np.load(str(tmp_path / "features.npz")) as data:
        stored = {k: data[k] for k in data.files}
    assert list(stored["force_rows"]) == [48, 0, 48]
    assert list(stored["sizes"]) == [16] * 3
    assert list(1 + stored["force_rows"]) == counts
    for key, want in zip(("x_e", "y_e", "x_f", "y_f"), ref):
        assert stored[key].shape == want.shape, key
        assert np.abs(stored[key] - want).max() <= ORACLE_TOL, key


def test_host_route_energy_only_and_no_forces(tmp_path, capsys):
    """A basis whose knots have no closed form takes the host route; the
    frame without forces gives one row there too, and ``fit_forces``
    off gives none at all, as ``uf3_tpu``'s ``BasisFeaturizer``."""
    write_frames(str(tmp_path / "data"))
    ref_basis = JBasis(JChem(["W"], degree=3), r_min_map=1.5,
                       r_max_map=5.5, resolution_map=8)
    knots = {}
    rng = np.random.RandomState(2)
    for key, seq in ref_basis.knots_map.items():
        seqs = [np.array(s, dtype=float) for s in
                (seq if len(key) == 3 else [seq])]
        for s in seqs:
            s[4:-4] += rng.uniform(-0.2, 0.2, len(s) - 8) * (s[4] - s[3])
        if len(key) == 3:
            seqs[1] = seqs[0]
        knots["-".join(key)] = [s.tolist() for s in seqs] \
            if len(key) == 3 else seqs[0].tolist()
    settings = {
        "elements": ["W"], "degree": 3,
        "data": {"sources": {"path": str(tmp_path / "data"),
                             "pattern": "*.xyz"}},
        "basis": {"knots_map": knots},
        "features": {"features_path": str(tmp_path / "features.npz")}}
    path = tmp_path / "settings.json"
    path.write_text(json.dumps(settings))
    main(["featurize", str(path), "--device", "cpu"])
    assert "route: host (" in capsys.readouterr().out
    with np.load(str(tmp_path / "features.npz")) as data:
        stored = {k: data[k] for k in data.files}
    assert list(stored["force_rows"]) == [48, 0, 48]
    ref_basis = JBasis(JChem(["W"], degree=3), knots_map={
        tuple(k.split("-")): v for k, v in knots.items()})
    frames = data_io.read_xyz(str(tmp_path / "data" / "train.xyz"))
    geoms = [JAtoms(numbers=f.get_atomic_numbers(),
                    positions=f.get_positions(), cell=f.get_cell(),
                    pbc=True) for f in frames]
    forces = [np.stack([f.arrays[c] for c in ("fx", "fy", "fz")], 1)
              if "fx" in f.arrays else None for f in frames]
    ref = oracle_rows(ref_basis, geoms, [f.info["energy"] for f in frames],
                      forces)
    for key, want in zip(("x_e", "y_e", "x_f", "y_f"), ref):
        assert stored[key].shape == want.shape, key
        assert np.abs(stored[key] - want).max() <= ORACLE_TOL, key
    settings["features"]["fit_forces"] = False
    path.write_text(json.dumps(settings))
    main(["featurize", str(path), "--device", "cpu"])
    with np.load(str(tmp_path / "features.npz")) as data:
        assert list(data["force_rows"]) == [0, 0, 0]
        assert data["x_f"].shape == (0, ref[0].shape[1])
        assert np.abs(data["x_e"] - ref[0]).max() <= ORACLE_TOL
