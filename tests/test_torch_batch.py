"""
The port's checkpoints, trajectories and LAMMPS export
(``uf3_tpu_torch/forcefield/batch.py``, ``data/io.py``,
``forcefield/lammps.py``, ``__main__.py``) in float64 on the CPU,
against the JAX package's on the same inputs:

- the twin of ``test_md_checkpoint_roundtrip``
  (``tests/test_geometry_distances.py:115``); a Langevin run saved,
  loaded and continued, bitwise equal to the uninterrupted run; a
  checkpoint written by ``uf3_tpu.forcefield.batch`` loads its arrays
  unchanged (its JAX key needs a seed);
- the twin of ``test_trajectory_writer``
  (``tests/test_device_potential.py:838``), ``MDSystem.to_atoms``, and
  the port's ``write_xyz`` text equal to ``uf3_tpu.data.io``'s;
- every test of ``TestLammpsExport`` (``tests/test_auxiliary.py``): the
  port's ``.uf3``, table and data files equal the JAX package's text
  (the DATE field masked), the round trips, ``UFLammps``' native
  backend against the reference's, its ``lammps`` backend's guard
  where no ``lammps`` module imports;
- ``python -m uf3_tpu_torch export`` against ``python -m uf3_tpu
  export`` (the export half of ``tests/test_cli.py``), and ``md
  --traj``.

No JAX engine runs here: the JAX side is host code.
"""

import os
import re
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uf3_tpu.data import io as j_io
from uf3_tpu.data.atoms import bulk as jbulk
from uf3_tpu.forcefield import batch as j_batch
from uf3_tpu.forcefield import lammps as j_lammps
from uf3_tpu.regression import least_squares as ls
from uf3_tpu_torch import io
from uf3_tpu_torch.__main__ import main
from uf3_tpu_torch.data import io as t_io
from uf3_tpu_torch.data.atoms import Atoms, bulk
from uf3_tpu_torch.forcefield import batch as t_batch
from uf3_tpu_torch.forcefield import lammps
from uf3_tpu_torch.forcefield.calculator import UFCalculator
from uf3_tpu_torch.forcefield.md import MDSystem
from uf3_tpu_torch.representation import splines as t_sp

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of a thread per core oversubscribes them
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(REPO, "benchmarks_data", "model_2and3.json")
BINARY = os.path.join(REPO, "tests", "data", "model_binary.json")
DATE = re.compile(r"DATE: [0-9/: -]+")


def _masked(text: str) -> str:
    return DATE.sub("DATE: -", text)


def _w(reps, rattle=None, seed=3):
    geom = bulk("W", "bcc", a=3.1652) * reps
    if rattle is not None:
        geom.rattle(rattle, seed=seed)
    return geom


def _arrays(state):
    return {name: getattr(state, name).numpy() for name in
            ("positions", "velocities", "forces", "energy", "xi", "cell")}


# -- checkpoints ------------------------------------------------------------
def test_md_checkpoint_roundtrip(tmp_path):
    system = MDSystem(MODEL, _w(3), dtype=torch.float64, device="cpu")
    state = system.init_state(temperature=300.0, seed=4)
    state = system.run(state, n_steps=5, dt_fs=1.0)
    path = str(tmp_path / "ckpt.npz")
    t_batch.save_md_checkpoint(path, state)
    restored = t_batch.load_md_checkpoint(path, system)
    for name, value in _arrays(state).items():
        assert np.array_equal(getattr(restored, name).numpy(), value), name
    assert restored.f_short is None and restored.f_mid is None
    assert not bool(system._overflow_flag(restored))
    restored = system.run(restored, n_steps=5, dt_fs=1.0)
    assert np.isfinite(float(restored.energy))


@pytest.mark.parametrize("respa", [False, True], ids=["verlet", "respa"])
def test_checkpoint_continues_bitwise(tmp_path, respa):
    """Langevin, saved after 24 steps and loaded, continues as the
    uninterrupted run for 24 more: the generator's state is stored, and
    each cycle starts from a full build at the same positions
    (``static_rebuild``), so plain Verlet continues bitwise.  On the
    adaptive schedules the rebuilt lists order their slots otherwise
    than the kept ones, and with r-RESPA the loaded state carries no
    split forces: the next launch recomputes them on the loaded lists
    where the uninterrupted run carries the last cycle's, the same sums
    in another order, so that continuation agrees to 1e-13."""
    kw = dict(rebuild_every=12, static_rebuild=True, device="cpu")
    if respa:
        kw.update(n_respa=6, respa_mid=3, respa_switch=(2.5, 3.5))
    run = dict(dt_fs=2.0, thermostat="langevin", temperature=800.0)
    system = MDSystem(MODEL, _w(3, rattle=0.05), dtype=torch.float64, **kw)
    state = system.init_state(temperature=800.0, seed=9)
    state = system.run(state, n_steps=24, **run)
    path = str(tmp_path / "ckpt.npz")
    t_batch.save_md_checkpoint(path, state)
    straight = system.run(state, n_steps=24, **run)
    loaded = t_batch.load_md_checkpoint(path, system)
    resumed = system.run(loaded, n_steps=24, **run)
    for name, value in _arrays(straight).items():
        ours = getattr(resumed, name).numpy()
        if respa:
            assert np.abs(ours - value).max() <= 1e-13, name
        else:
            assert np.array_equal(ours, value), name
    assert torch.equal(resumed.generator.get_state(),
                       straight.generator.get_state())
    assert not np.array_equal(straight.positions.numpy(),
                              state.positions.numpy())


def test_loads_a_uf3_tpu_checkpoint(tmp_path):
    """A checkpoint written by ``uf3_tpu.forcefield.batch`` (a JAX rbg
    key beside the arrays) loads its arrays unchanged; its key cannot
    become a torch generator, so the load needs a seed."""
    system = MDSystem(MODEL, _w(3, rattle=0.05), dtype=torch.float64,
                      device="cpu")
    state = system.init_state(temperature=300.0, seed=1)
    state = system.run(state, n_steps=6, dt_fs=1.0, thermostat="langevin")
    arrays = _arrays(state)
    jax_state = SimpleNamespace(key=jax.random.key(5, impl="rbg"),
                                **{k: jnp.asarray(v)
                                   for k, v in arrays.items()})
    path = str(tmp_path / "jax.npz")
    j_batch.save_md_checkpoint(path, jax_state)
    with pytest.raises(ValueError, match="seed"):
        t_batch.load_md_checkpoint(path, system)
    loaded = t_batch.load_md_checkpoint(path, system, seed=7)
    for name, value in arrays.items():
        assert np.array_equal(getattr(loaded, name).numpy(), value), name
    expected = torch.Generator().manual_seed(7).get_state()
    assert torch.equal(loaded.generator.get_state(), expected)
    assert np.isfinite(float(system.run(loaded, n_steps=6, dt_fs=1.0,
                                        thermostat="langevin").energy))


# -- trajectories -----------------------------------------------------------
def test_trajectory_writer(tmp_path):
    """run(callback=TrajectoryWriter(...)) writes parseable extxyz
    frames with energy, step, cell, and forces, one per launch."""
    geom = _w(3)
    system = MDSystem(MODEL, geom, dtype=torch.float64, rebuild_every=6,
                      device="cpu")
    state = system.init_state(temperature=300.0, seed=0)
    traj_path = str(tmp_path / "traj.xyz")
    writer = t_batch.TrajectoryWriter(traj_path, system)
    state = system.run(state, n_steps=18, dt_fs=1.0, callback=writer)
    assert writer.frames_written == 3
    frames = t_io.read_xyz(traj_path)
    assert len(frames) == 3
    last = frames[-1]
    assert len(last) == len(geom)
    assert np.allclose(last.get_positions(), state.positions.numpy(),
                       atol=1e-9)
    assert np.allclose(np.stack([last.arrays[c] for c in ("fx", "fy", "fz")],
                                axis=1), state.forces.numpy(), atol=1e-9)
    assert np.isclose(last.info.get("energy", np.nan), float(state.energy),
                      atol=1e-6)
    # the JAX package reads the same file to the same frames
    ref = j_io.read_xyz(traj_path)
    assert np.array_equal(ref[-1].get_positions(), last.get_positions())
    # one frame per `every` steps: after the launches that end at steps
    # 6, 18 and 30
    every_path = str(tmp_path / "every.xyz")
    writer = t_batch.TrajectoryWriter(every_path, system, every=12)
    system.run(state, n_steps=36, dt_fs=1.0, callback=writer)
    assert writer.frames_written == len(t_io.read_xyz(every_path)) == 3


def test_to_atoms():
    geom = _w(2)
    geom.info["energy"] = -1.0
    system = MDSystem(MODEL, geom, dtype=torch.float64, device="cpu")
    state = system.init_state(temperature=300.0, seed=0)
    out = system.to_atoms(geom, state)
    assert np.array_equal(out.positions, state.positions.numpy())
    assert np.array_equal(out.arrays["velocities"],
                          state.velocities.numpy())
    assert out.info == geom.info and out is not geom
    assert "velocities" not in geom.arrays


def test_write_xyz_matches_uf3_tpu(tmp_path):
    """The port's ``write_xyz`` writes the JAX package's text: a
    periodic frame with energy and forces, a cluster without."""
    from uf3_tpu.data.atoms import Atoms as JAtoms
    rng = np.random.RandomState(2)
    geoms = []
    for pbc in (True, False):
        n = 5
        numbers = rng.choice([10, 54, 74], size=n)
        positions = rng.normal(size=(n, 3)) * 3
        cell = np.diag([7.0, 8.0, 9.0]) + rng.normal(size=(3, 3)) * 0.1
        arrays = {}
        info = {}
        if pbc:
            forces = rng.normal(size=(n, 3))
            arrays = {"fx": forces[:, 0], "fy": forces[:, 1],
                      "fz": forces[:, 2]}
            info = {"energy": -12.345678901234}
        geoms.append((numbers, positions, cell, pbc, info, arrays))
    ours, ref = str(tmp_path / "ours.xyz"), str(tmp_path / "ref.xyz")
    t_io.write_xyz(ours, [Atoms(*g[:4], info=g[4], arrays=g[5])
                          for g in geoms])
    j_io.write_xyz(ref, [JAtoms(numbers=g[0], positions=g[1], cell=g[2],
                                pbc=g[3], info=g[4], arrays=g[5])
                         for g in geoms])
    assert open(ours).read() == open(ref).read()
    back = t_io.read_xyz(ours)
    assert [len(g) for g in back] == [5, 5]
    assert back[0].info["energy"] == -12.3456789012  # 10 decimals
    assert not back[1].pbc.any()


# -- LAMMPS export ----------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    return io.load_model(MODEL), ls.WeightedLinearModel.from_json(MODEL)


def _pair_coefficients(model):
    config = model.bspline_config
    pair = config.interactions_map[2][0]
    sizes, offsets = config.get_interaction_partitions()
    return pair, config.knots_map[pair], model.coefficients[
        offsets[pair]:offsets[pair] + sizes[pair]]


class TestLammpsExport:
    def test_tabulated_export(self, models):
        pair, knots, coeff = _pair_coefficients(models[0])
        text = lammps.export_tabulated_potential(knots, coeff, pair, grid=50)
        lines = text.splitlines()
        assert lines[3] == "UF_W-W"
        assert lines[4] == "N 50"
        body = [ln.split() for ln in lines[6:]]
        assert len(body) == 50
        r = float(body[10][1])
        expected = 2 * t_sp.evaluate_spline(np.array([r]), knots, coeff)[0]
        assert np.isclose(float(body[10][2]), expected, atol=1e-5)
        ref = j_lammps.export_tabulated_potential(knots, coeff, pair,
                                                  grid=50)
        assert _masked(text) == _masked(ref)

    def test_uf3_pot_file(self, models, tmp_path):
        model, ref_model = models
        path = lammps.write_uf3_lammps_pot_files(
            model=model, pot_dir=str(tmp_path / "ours"), author="test")
        text = open(path).read()
        assert "2B W W" in text and "3B W W W" in text
        assert len(text.split("#UF3 POT")) == 3
        config = model.bspline_config
        trio = config.interactions_map[3][0]
        shape = tuple(len(s) - 4 for s in config.knots_map[trio])
        assert f"{shape[0]} {shape[1]} {shape[2]}" in text
        assert "{" not in text
        ref = j_lammps.write_uf3_lammps_pot_files(
            model=ref_model, pot_dir=str(tmp_path / "ref"), author="test")
        assert os.path.basename(path) == os.path.basename(ref)
        assert _masked(text) == _masked(open(ref).read())

    def test_uf3_pot_round_trip(self, models, tmp_path):
        """export -> parse -> evaluate on the port's calculator: the
        same forces in f64 within 1e-10, and the coefficients, 1-body
        offsets aside (the file format has none), bit for bit."""
        model = models[0]
        path = lammps.write_uf3_lammps_pot_files(model=model,
                                                 pot_dir=str(tmp_path))
        model2 = lammps.model_from_uf3_pot_file(path)
        geom = _w(2, rattle=0.05)
        calc, calc2 = (UFCalculator(m, device="cpu") for m in (model, model2))
        assert np.abs(calc.get_forces(geom)
                      - calc2.get_forces(geom)).max() < 1e-10
        assert abs(calc.get_potential_energy(geom, force_consistent=True)
                   - calc2.get_potential_energy(geom)) < 1e-10
        n1 = len(model.bspline_config.element_list)
        assert np.array_equal(model.coefficients[n1:],
                              model2.coefficients[n1:])
        ref = j_lammps.model_from_uf3_pot_file(path)
        assert np.array_equal(model2.coefficients, ref.coefficients)

    def test_uf3_pot_round_trip_binary(self, tmp_path):
        model = io.load_model(BINARY)
        path = lammps.write_uf3_lammps_pot_files(model=model,
                                                 pot_dir=str(tmp_path))
        model2 = lammps.model_from_uf3_pot_file(path)
        n1 = len(model.bspline_config.element_list)
        assert np.array_equal(model.coefficients[n1:],
                              model2.coefficients[n1:])
        assert (model2.bspline_config.chemical_system.element_list
                == model.bspline_config.chemical_system.element_list)
        ref = j_lammps.write_uf3_lammps_pot_files(
            model=ls.WeightedLinearModel.from_json(BINARY),
            pot_dir=str(tmp_path / "ref"))
        assert _masked(open(path).read()) == _masked(open(ref).read())

    def test_tabulated_round_trip(self, models, tmp_path):
        pair, knots, coeff = _pair_coefficients(models[0])
        path = str(tmp_path / "W_W.table")
        lammps.export_tabulated_potential(knots, coeff, pair, grid=64,
                                          filename=path, rounding=10)
        parsed = lammps.read_tabulated_potential(path)
        assert parsed["keyword"] == "UF_W-W"
        r = np.clip(parsed["r"], knots[0], knots[-1] - 1e-12)
        expected = 2 * t_sp.evaluate_spline(r, knots, coeff)
        assert np.allclose(parsed["energy"], expected, atol=1e-8)
        expected_f = -2 * t_sp.evaluate_spline(r, knots, coeff, nu=1)
        assert np.allclose(parsed["force"], expected_f, atol=1e-8)
        ref = j_lammps.read_tabulated_potential(path)
        for key in ("r", "energy", "force"):
            assert np.array_equal(parsed[key], ref[key])

    def test_write_lammps_data(self, tmp_path):
        geom = bulk("W", "bcc", a=3.16) * 2
        path = str(tmp_path / "data.lammps")
        lammps.write_lammps_data(path, geom, ["W"])
        text = open(path).read()
        assert "16 atoms" in text and "1 atom types" in text
        ref = str(tmp_path / "ref.lammps")
        j_lammps.write_lammps_data(ref, jbulk("W", "bcc", a=3.16) * 2, ["W"])
        assert text == open(ref).read()

    def test_uflammps_native_backend(self, models):
        """UFLammps' native backend (backend='auto' here, where no
        LAMMPS library imports) evaluates and box-relaxes as the
        reference's does."""
        model, ref_model = models
        calc = lammps.UFLammps(model, device="cpu")
        assert calc.backend == "native"
        geom = _w(2, rattle=0.02, seed=4)
        results = calc.evaluate(geom)
        ref_calc = j_lammps.UFLammps(ref_model, backend="native")
        ref_geom = jbulk("W", "bcc", a=3.1652) * 2
        ref_geom.rattle(0.02, seed=4)
        ref = ref_calc.evaluate(ref_geom)
        assert abs(results["energy"] - ref["energy"]) \
            <= 1e-9 * abs(ref["energy"])
        assert np.abs(results["forces"] - ref["forces"]).max() <= 5e-9
        assert np.abs(results["stress"] - ref["stress"]).max() <= 1e-8
        assert results["volume"] == ref["volume"]
        f0 = float(np.abs(results["forces"]).max())
        relaxed = calc.relax(geom, ftol=0.02)
        assert float(np.abs(relaxed["forces"]).max()) < min(0.02, f0)
        ref_relaxed = ref_calc.relax(ref_geom, ftol=0.02)
        assert relaxed["nsteps"] == ref_relaxed["nsteps"]
        assert np.abs(geom.positions - ref_geom.positions).max() < 1e-6
        cmds = calc.setup_commands("dummy.data")
        assert any("pair_style" in c for c in cmds)
        assert calc.pot_path is not None

    def test_read_tabulated_potential_rejects_empty(self):
        with pytest.raises(ValueError, match="no 4-column"):
            lammps.read_tabulated_potential("UF3_W\nN 25\n")

    def test_uflammps_lammps_backend_guard(self, models, tmp_path,
                                           monkeypatch):
        """With no ``lammps`` module, backend='lammps' constructs and
        exports the potential file, and its first evaluate raises the
        reference's ImportError (``tests/test_auxiliary.py``'s
        guard); the command sequence matches the pair_style uf3
        contract and the reference's."""
        monkeypatch.setitem(sys.modules, "lammps", None)
        calc = lammps.UFLammps(models[0], backend="lammps", device="cpu",
                               pot_dir=str(tmp_path / "port"))
        assert calc.backend == "lammps" and os.path.isfile(calc.pot_path)
        with pytest.raises(ImportError, match="backend='native'") as ours:
            calc.evaluate(bulk("W", "bcc", a=3.1652) * 2)
        ref = j_lammps.UFLammps(models[1], backend="lammps",
                                pot_dir=str(tmp_path / "ref"))
        with pytest.raises(ImportError) as theirs:
            ref.evaluate(jbulk("W", "bcc", a=3.1652) * 2)
        assert str(ours.value) == str(theirs.value)
        calc = lammps.UFLammps(models[0], backend="native", device="cpu")
        calc.pot_path = str(tmp_path / "W.uf3")
        cmds = calc.setup_commands("structure.data")
        assert cmds[0] == "units metal"
        assert any(c.startswith("pair_style\tuf3 3") for c in cmds)
        assert any("pair_coeff" in c and "W" in c for c in cmds)
        ref = j_lammps.UFLammps(models[1], backend="native")
        ref.pot_path = calc.pot_path
        assert cmds == ref.setup_commands("structure.data")


# -- the command line ---------------------------------------------------------
def _run(package, *args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-m", package, *args], cwd=cwd,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def test_export_command_matches_uf3_tpu(tmp_path):
    """``python -m uf3_tpu_torch export`` (host code, no device) writes
    the ``.uf3`` file and prints the lines of ``python -m uf3_tpu
    export``; reading the file back gives the same forces."""
    ours = _run("uf3_tpu_torch", "export", MODEL, "--out", "ours",
                cwd=tmp_path)
    ref = _run("uf3_tpu", "export", MODEL, "--out", "ref", cwd=tmp_path)
    assert ours.replace("ours", "ref") == ref
    text = (tmp_path / "ours" / "W.uf3").read_text()
    assert _masked(text) == _masked((tmp_path / "ref" / "W.uf3").read_text())
    model2 = lammps.model_from_uf3_pot_file(str(tmp_path / "ours" / "W.uf3"))
    geom = _w(2, rattle=0.05)
    forces = [UFCalculator(m, device="cpu").get_forces(geom)
              for m in (MODEL, model2)]
    assert np.abs(forces[0] - forces[1]).max() < 1e-10


def test_md_traj_command(tmp_path, capsys):
    """``md --traj`` writes one frame per launch (every 20 steps at the
    engine's defaults), the last at the run's final energy."""
    path = str(tmp_path / "md.xyz")
    main(["md", MODEL, "--reps", "3", "--steps", "40", "--device", "cpu",
          "--traj", path])
    out = capsys.readouterr().out.strip().splitlines()
    energy = float(re.search(r"E = (\S+) eV", out[-1]).group(1))
    frames = t_io.read_xyz(path)
    assert len(frames) == 2 and all(len(f) == 54 for f in frames)
    assert abs(frames[-1].info["energy"] - energy) < 1e-3
