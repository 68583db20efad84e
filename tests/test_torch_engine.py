"""
The port's MD engine on its own (uf3_tpu_torch/forcefield/md.py): the
trajectory does not depend on how cycles are grouped into launches,
the triangle-lane trio layout runs to the full lanes' state, the paths
the JAX engine has none of raise NotImplementedError naming their
ROADMAP.md item, the Langevin thermostat and the two barostats hold
their targets (twins of the JAX engine's statistical tests), and the md
command runs on the CPU.  Parity with the JAX engine is in
tests/test_torch_md.py; this file imports no jax.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from uf3_tpu_torch.__main__ import main
from uf3_tpu_torch.data.atoms import bulk
from uf3_tpu_torch.forcefield.md import MDSystem

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of a thread per core oversubscribes them
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(REPO, "benchmarks_data", "model_2and3.json")
BINARY = os.path.join(REPO, "tests", "data", "model_binary.json")
KW = dict(rebuild_every=12, skin=0.5, skin_2b=1.2, capacity_2b=72,
          capacity_3b=16, n_respa=6, respa_mid=3, respa_switch=(2.5, 3.5),
          device="cpu")


def _geom():
    geom = bulk("W", "bcc", a=3.1652) * (8, 8, 8)
    geom.rattle(0.05, seed=1)
    return geom


def test_langevin_launch_chunks_exact():
    """launch_chunks only groups cycles per overflow check: the
    trajectory, noise stream included, does not depend on it."""
    geom = _geom()
    runs = []
    for chunks in (1, 3):
        port = MDSystem(MODEL, geom, dtype=torch.float64, **KW)
        st = port.init_state(temperature=500.0, seed=7)
        runs.append(port.run(st, n_steps=36, dt_fs=2.0,
                             thermostat="langevin", temperature=500.0,
                             launch_chunks=chunks))
    a, b = runs
    assert torch.equal(a.positions, b.positions)
    assert torch.equal(a.velocities, b.velocities)
    assert float(a.energy) == float(b.energy)
    assert np.isfinite(float(a.energy))


def test_options_off_the_bench_path_raise():
    """The engine options off the bench path: the triangle-lane trio
    layout constructs and runs 3-level r-RESPA on the bench split to
    the full lanes' state (tests/test_torch_triangle.py holds it to the
    JAX engine); the paths the JAX engine has none of, a barostat on
    r-RESPA and Nose-Hoover NPT, raise NotImplementedError naming their
    ROADMAP.md item.  static_rebuild and eager_refilter=False construct
    here and run (tests/test_torch_schedules.py); Nose-Hoover,
    regrowth, npt_run and stress run (tests/test_torch_npt.py);
    fused="separate" and binary models run (tests/test_torch_models.py,
    test_torch_multi.py)."""
    geom = _geom()
    runs = []
    for triangle in (True, False):
        port = MDSystem(MODEL, geom, dtype=torch.float64,
                        **dict(KW, trio_triangle=triangle))
        assert port.triangle is triangle
        st = port.init_state(temperature=300.0, seed=3)
        runs.append(port.run(st, n_steps=12, dt_fs=2.0))
    tri, full = runs
    for name in ("positions", "velocities", "forces"):
        assert torch.max(torch.abs(getattr(tri, name)
                                   - getattr(full, name))) < 1e-10
    assert abs(float(tri.energy) - float(full.energy)) < 1e-9
    for ported in (dict(static_rebuild=True), dict(eager_refilter=False)):
        port = MDSystem(MODEL, geom, dtype=torch.float64,
                        **dict(KW, **ported))
        assert port.static_rebuild == ported.get("static_rebuild", False)
        assert port.eager_refilter == ported.get("eager_refilter", True)
    binary = MDSystem(BINARY, bulk("Ne", "fcc", a=5.4) * 3, device="cpu")
    assert binary.degree == 2 and binary.potential.trio is None
    with pytest.raises(ValueError, match="multiple of respa_mid"):
        MDSystem(MODEL, geom, **dict(KW, respa_mid=4))
    port = MDSystem(MODEL, geom, dtype=torch.float64, **KW)
    st = port.init_state()
    with pytest.raises(NotImplementedError,
                       match="barostat on r-RESPA.*ROADMAP.md"):
        port.npt_run(st, n_steps=12, dt_fs=2.0)
    plain = MDSystem(MODEL, bulk("W", "bcc", a=3.1652) * 3,
                     dtype=torch.float64, device="cpu")
    st = plain.init_state()
    with pytest.raises(NotImplementedError, match="nose_hoover.*ROADMAP.md"):
        plain.npt_run(st, n_steps=12, dt_fs=2.0, thermostat="nose_hoover")
    for bad in (dict(thermostat="andersen"), dict(on_overflow="ignore")):
        with pytest.raises(ValueError):
            plain.run(st, n_steps=2, dt_fs=2.0, **bad)
    with pytest.raises(ValueError, match="barostat"):
        plain.npt_run(st, n_steps=2, dt_fs=2.0, barostat="mttk")


# -- statistical twins of the JAX engine's thermostat and barostat tests
# (tests/test_device_potential.py), 54 atoms, f64
def _w54():
    return bulk("W", "bcc", a=3.1652) * 3


def test_langevin_thermostat():
    """900 K velocities cool to 300 K under friction 10/ps in 300 steps
    (twin of test_langevin_thermostat)."""
    port = MDSystem(MODEL, _w54(), dtype=torch.float64, device="cpu",
                    rebuild_every=10)
    state = port.init_state(temperature=900.0, seed=2)
    state = port.run(state, n_steps=300, dt_fs=2.0, thermostat="langevin",
                     temperature=300.0, friction_ps=10.0)
    assert 150.0 < port.temperature(state) < 500.0


def _npt_volume(barostat, pressure, n_steps, seed, tail):
    geom = _w54()
    port = MDSystem(MODEL, geom, dtype=torch.float64, device="cpu",
                    rebuild_every=5, skin=0.5)
    state = port.init_state(temperature=100.0, seed=seed)
    _, cells = port.npt_run(state, n_steps=n_steps, dt_fs=2.0,
                            temperature=100.0, pressure=pressure,
                            tau_p_fs=20.0 if barostat == "berendsen"
                            else 40.0, compressibility=0.2,
                            barostat=barostat)
    return geom.get_volume(), float(np.mean(
        [abs(np.linalg.det(c)) for c in cells[-tail:]]))


def test_berendsen_pressure_coupling():
    """At P = 0 Berendsen holds the volume within 3%; 0.2 eV/A^3
    compresses it by more than 4% (twin of
    test_berendsen_pressure_coupling)."""
    v0, v_zero = _npt_volume("berendsen", 0.0, 100, 4, 1)
    assert abs(v_zero - v0) / v0 < 0.03
    _, v_comp = _npt_volume("berendsen", 0.2, 100, 4, 1)
    assert v_comp < 0.96 * v_zero


def test_scr_npt_ensemble():
    """SCR at 100 K: the mean volume of the last 6 launches stays
    within 4% at P = 0 and drops by more than 3% at 0.2 eV/A^3 (twin of
    test_scr_npt_ensemble)."""
    v0, v_zero = _npt_volume("scr", 0.0, 120, 6, 6)
    assert abs(v_zero - v0) / v0 < 0.04
    _, v_comp = _npt_volume("scr", 0.2, 120, 6, 6)
    assert v_comp < 0.97 * v_zero


def test_npt_launch_chunks_exact():
    """SCR at 500 K: four cycles in one launch give the trajectory,
    noise stream and cell of one cycle per launch (twin of
    test_npt_launch_chunks_exact)."""
    out = []
    for chunks in (1, 4):
        port = MDSystem(MODEL, _w54(), dtype=torch.float64, device="cpu",
                        rebuild_every=12)
        state = port.init_state(temperature=500.0, seed=7)
        out.append(port.npt_run(state, n_steps=48, dt_fs=1.0,
                                temperature=500.0, pressure=0.0,
                                launch_chunks=chunks))
    (a, cells_a), (b, cells_b) = out
    assert torch.equal(a.positions, b.positions)
    assert torch.equal(a.cell, b.cell)
    assert len(cells_a) == 4 and len(cells_b) == 1
    assert np.array_equal(cells_a[-1], cells_b[0])
    assert not np.array_equal(cells_b[0], _w54().cell)


@pytest.mark.parametrize("reps", [8, 10])
def test_float32_lattice_on_bin_faces_does_not_overflow(reps):
    """Perfect bcc W whose lattice planes lie on the cell-list bin
    faces (4^3 or 5^3 bins of 2^3 unit cells), at the engine's defaults
    in float32 (10^3 is the md command's default cell): atoms on a face
    may round into either bin, and the bins are sized for that."""
    geom = bulk("W", "bcc", a=3.1652) * reps
    port = MDSystem(MODEL, geom, dtype=torch.float32, device="cpu")
    assert port._cells_2b[0] == (reps // 2,) * 3
    state = port.init_state(temperature=300.0)
    assert not port.overflowed(state)
    assert int(state.nbr2.mask.sum(1).min()) == 58


def test_md_command_on_the_cpu(capsys, tmp_path):
    """``python -m uf3_tpu_torch md`` prints the JAX command's result
    line; the fit commands take the settings' default HDF5 features
    file and fit the model the same commands fit from an ``.npz``
    (``--static-rebuild`` runs: tests/test_torch_schedules.py;
    ``--traj`` and ``export``: tests/test_torch_batch.py; featurize,
    fit and predict: tests/test_torch_fit.py)."""
    main(["md", MODEL, "--reps", "3", "--steps", "12", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == "54 atoms of W"
    found = re.fullmatch(r"12 steps in \S+ s \((\S+) atom-steps/s\); "
                         r"T = (\S+) K, E = (\S+) eV", out[-1])
    assert found is not None, out[-1]
    rate, temp, energy = (float(x) for x in found.groups())
    assert rate > 0 and 0 < temp < 600 and -620 < energy < -580
    from uf3_tpu_torch.data.io import write_xyz
    rng = np.random.RandomState(0)
    frames = []
    for _ in range(4):
        geom = bulk("W", "bcc", a=3.1652) * 2
        geom.rattle(0.05, seed=int(rng.randint(1000)))
        geom.info["energy"] = -12.0 * len(geom) + rng.normal()
        for name in ("fx", "fy", "fz"):
            geom.arrays[name] = rng.normal(scale=0.1, size=len(geom))
        frames.append(geom)
    (tmp_path / "data").mkdir()
    write_xyz(str(tmp_path / "data" / "w.xyz"), frames)
    coefficients = {}
    for tag in ("h5", "npz"):
        settings = tmp_path / f"settings_{tag}.json"
        features = {} if tag == "h5" else {
            "features_path": str(tmp_path / "features.npz")}
        settings.write_text(json.dumps({
            "elements": ["W"], "degree": 2,
            "basis": {"r_min": 1.5, "r_max": 5.5, "resolution": 8},
            "data": {"sources": {"path": str(tmp_path / "data"),
                                 "pattern": "*.xyz"}},
            "features": features, "learning": features,
            "model": {"model_path": str(tmp_path / f"model_{tag}.json")}}))
        cwd = os.getcwd()
        os.chdir(tmp_path)   # the default features path is relative
        try:
            for command in ("featurize", "fit", "predict"):
                main([command, str(settings), "--device", "cpu"])
        finally:
            os.chdir(cwd)
        with open(tmp_path / f"model_{tag}.json") as f:
            coefficients[tag] = np.array(json.load(f)["coefficients"]
                                         ["W-W"], dtype=float)
    assert (tmp_path / "features.h5").is_file()
    assert "RMSE (energy, eV/atom)" in capsys.readouterr().out
    assert np.abs(coefficients["h5"] - coefficients["npz"]).max() \
        <= 1e-10 * np.abs(coefficients["npz"]).max()
