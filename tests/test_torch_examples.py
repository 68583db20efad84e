"""
The port's example entry points (``uf3_tpu_torch/examples/``) on the CPU,
in float64, on data the tests make:

- ``tungsten_fit.main`` on an extended-xyz set labeled by the port's
  calculator on ``model_2and3.json``: its coefficients equal those of
  ``python -m uf3_tpu_torch featurize`` / ``fit`` on the same
  configurations (its 80% training share) and basis (1e-8 of the
  largest), its hold-out RMSEs finite, its files written;
- ``nexe_pair_fit.main`` on a LAMMPS run directory of labeled Ne/Xe
  configurations (``write_lammps_run``): each pair's table file is text
  equal to ``uf3_tpu.forcefield.lammps.export_tabulated_potential`` on
  the same knots and coefficients (the date masked), and the run
  directory reads back what was written;
- ``multichip_demo.main(["--cpu"])`` on a gloo group of world size 1, 4
  shards: the halo energy within 1e-8 eV of the single device's.
"""

import json
import os

import numpy as np
import pytest
import torch

from uf3_tpu.forcefield import lammps as j_lammps
from uf3_tpu_torch import __main__ as cli
from uf3_tpu_torch import io
from uf3_tpu_torch.data import io as data_io
from uf3_tpu_torch.data.atoms import bulk
from uf3_tpu_torch.examples import multichip_demo, nexe_pair_fit, \
    tungsten_fit
from uf3_tpu_torch.forcefield.calculator import UFCalculator

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(REPO, "benchmarks_data", "model_2and3.json")
MODEL_PAIR = os.path.join(REPO, "benchmarks_data", "model_pair.json")


def _labeled(calc, geoms):
    for geom in geoms:
        geom.info["energy"] = float(calc.get_potential_energy(geom))
        forces = calc.get_forces(geom)
        for c, name in enumerate(("fx", "fy", "fz")):
            geom.arrays[name] = forces[:, c].copy()
    return geoms


def _tungsten_set(n=15, seed=0):
    rng = np.random.RandomState(seed)
    geoms = []
    for i in range(n):
        geom = bulk("W", "bcc", a=3.1652) * 2
        geom.set_cell(geom.get_cell() * (1.0 + rng.uniform(-0.02, 0.02)),
                      scale_atoms=True)
        geom.rattle(rng.uniform(0.03, 0.12), seed=seed + i)
        geoms.append(geom)
    return _labeled(UFCalculator(MODEL, device="cpu"), geoms)


def test_tungsten_fit_matches_the_fit_command(tmp_path):
    geoms = _tungsten_set()
    data = tmp_path / "data"
    data.mkdir()
    dataset = str(data / "w.xyz")
    data_io.write_xyz(dataset, geoms)
    out = tmp_path / "out"
    model, rmse_e, rmse_f = tungsten_fit.main(
        [dataset, str(tmp_path / "features.npz"), "--out-dir", str(out),
         "--cpu"])
    assert np.isfinite(rmse_e) and np.isfinite(rmse_f) and rmse_f < 0.5
    refit = io.load_model(str(out / "model_2and3_refit.json"))
    assert np.array_equal(refit.coefficients, model.coefficients)
    with np.load(tmp_path / "features.npz") as feats:
        assert feats["x_e"].shape == (len(geoms), model.n_feats)
        assert list(feats["force_rows"]) == [3 * len(g) for g in geoms]
    # the commands on the same basis, regularizer and training share
    split = int(tungsten_fit.TRAIN_SHARE * len(geoms))
    train = tmp_path / "train"
    train.mkdir()
    data_io.write_xyz(str(train / "w.xyz"), geoms[:split])
    settings = {
        "elements": ["W"], "degree": 3,
        "basis": {"r_min": {"W-W": 1.5, "W-W-W": [1.5, 1.5, 1.5]},
                  "r_max": {"W-W": 5.5, "W-W-W": [3.5, 3.5, 7.0]},
                  "resolution": {"W-W": 15, "W-W-W": [6, 6, 12]}},
        "data": {"sources": {"path": str(train), "pattern": "*.xyz"}},
        "features": {"features_path": str(tmp_path / "cmd.npz")},
        "model": {"model_path": str(tmp_path / "cmd.json")},
        "learning": {"features_path": str(tmp_path / "cmd.npz"),
                     "regularizer": {"curvature_2b": 1e-8,
                                     "curvature_3b": 1e-8}}}
    path = str(tmp_path / "settings.json")
    with open(path, "w") as f:
        json.dump(settings, f)
    for command in ("featurize", "fit"):
        cli.main([command, path, "--device", "cpu"])
    ours = io.load_model(str(tmp_path / "cmd.json"))
    assert ours.bspline_config.get_column_names() \
        == model.bspline_config.get_column_names()
    theirs = ours.coefficients
    scale = np.abs(theirs).max()
    assert np.abs(model.coefficients - theirs).max() <= 1e-8 * scale


def test_nexe_pair_fit_tables_match_reference_export(tmp_path):
    rng = np.random.RandomState(1)
    geoms = []
    for i in range(8):
        geom = bulk("Ne", "fcc", a=5.4) * 2
        numbers = geom.get_atomic_numbers().copy()
        numbers[rng.rand(len(geom)) < 0.5] = 54
        geom.numbers = numbers
        geom.rattle(0.05, seed=i)
        geoms.append(geom)
    geoms = _labeled(UFCalculator(MODEL_PAIR, device="cpu"), geoms)
    run = str(tmp_path / "run")
    nexe_pair_fit.write_lammps_run(run, geoms)
    back = data_io.parse_lammps_outputs(run, nexe_pair_fit.ALIASES,
                                        column_subs={"TotEng": "energy"})
    for a, b in zip(back, geoms):
        assert np.array_equal(a.numbers, b.numbers)
        assert np.array_equal(a.positions, b.positions)
        assert np.allclose(a.cell, b.cell, rtol=0, atol=1e-12)
        assert a.info["energy"] == b.info["energy"]
        assert np.array_equal(a.arrays["fx"], b.arrays["fx"])
    out = tmp_path / "out"
    model, paths = nexe_pair_fit.main([run, "--out-dir", str(out), "--cpu"])
    assert [os.path.basename(p) for p in paths] == [
        "table_Ne_Ne.dat", "table_Ne_Xe.dat", "table_Xe_Xe.dat"]
    assert os.path.isfile(out / "model_nexe.json")
    basis = model.bspline_config
    sizes, offsets = basis.get_interaction_partitions()
    for pair, path in zip(basis.chemical_system.interactions_map[2], paths):
        coeff = model.coefficients[offsets[pair]:offsets[pair] + sizes[pair]]
        ref = j_lammps.export_tabulated_potential(
            basis.knots_map[pair], coeff, pair, grid=200)
        with open(path) as f:
            text = f.read()
        mask = lambda t: t.split("\n", 1)[1]  # noqa: E731 (the date line)
        assert mask(text) == mask(ref)
        assert "\nN 200\n" in text and text.count("\n") == 205


def test_multichip_demo_on_gloo():
    out = multichip_demo.main(["--cpu"])
    assert abs(out["e_halo"] - out["e_single"]) <= 1e-8
    assert np.isfinite(out["rmse"]) and out["rmse"] < 0.2
    assert not torch.distributed.is_initialized()


def test_examples_run_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--cpu"):
        multichip_demo.main([])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tungsten_fit.main([os.path.join(REPO, "missing.xyz")])
