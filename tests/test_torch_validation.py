"""
The port's physics checks of the main path (uf3_tpu_torch/benchmarks/
{validate_final,validate_respa,validate_respa_mid,probe_stale,
probe_stale_error}.py) against the same procedures run through the JAX
engine (uf3_tpu/forcefield/md.py), on bcc W 4^3 = 128 atoms in float64,
from the same numpy velocities and with no Langevin warm-up (JAX's rbg
stream cannot be reproduced).  The probes' Langevin launches run at zero
friction, which draws noise and scales it by zero in both engines.  The
scripts of benchmarks/ re-execute the interpreter at import and fix the
box at 17^3, so the procedures are written out here.

One JAX engine at the probes' cadence (6/3/24) serves validate_final,
validate_respa_mid, probe_stale and probe_stale_error, and one at 6/24
without a mid level serves validate_respa, so that each launch shape
compiles once.  Tolerances: drifts 1e-9 eV/atom, list drifts 1e-9 A,
fresh forces 1e-9 eV/A, frozen-list errors 1e-10 eV/A.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uf3_tpu.data.atoms import bulk
from uf3_tpu.forcefield import units
from uf3_tpu.forcefield.md import MDSystem as JaxMDSystem
from uf3_tpu.regression import least_squares as ls
from uf3_tpu_torch.benchmarks import (common, probe_stale,
                                      probe_stale_error, validate_final,
                                      validate_respa, validate_respa_mid)

from test_torch_md import MODEL, port_model

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of a thread per core oversubscribes them
torch.set_num_threads(1)

REPS = (4, 4, 4)
CADENCE = dict(n_respa=6, respa_mid=3, rebuild_every=24)
ENGINE = dict(skin=0.5, skin_2b=1.2, capacity_2b=72, capacity_3b=16)
CPU = dict(reps=REPS, device="cpu", dtype=torch.float64)
ARTIFACTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks_data", "artifacts")
DRIFT_TOL = 1e-9      # eV/atom
LIST_DRIFT_TOL = 1e-9  # A
FORCE_TOL = 1e-9      # eV/A
ERROR_TOL = 1e-10     # eV/A


def velocities(temperature):
    """Maxwell-Boltzmann velocities of the 128 W atoms (internal units),
    zero total momentum, from RandomState(0)."""
    v = np.random.RandomState(0).normal(
        0.0, np.sqrt(units.kB * temperature / 183.84), (128, 3))
    return v - v.mean(axis=0)


V300 = velocities(300.0)
# hot enough that launches trip the staleness flag and the 2-body list
# is rebuilt in full: the probes' flags and branches are then exercised
V_HOT = velocities(1300.0)


def jax_engine(**kw) -> JaxMDSystem:
    geom = bulk("W", "bcc", a=common.LATTICE_A) * REPS
    return JaxMDSystem(ls.WeightedLinearModel.from_json(MODEL), geom,
                       dtype=jnp.float64, **ENGINE, **kw)


def commit(state):
    """The state on the device, committed, so that every launch after
    the first reuses one compiled shape."""
    return jax.device_put(state, jax.devices()[0])


def jax_energy(system, state) -> float:
    """(E_pot + E_kin) / N, as the reference's drift reads it."""
    return (float(state.energy) + system.kinetic_energy(state)) \
        / state.positions.shape[0]


def jax_nve_trace(system, v0, blocks, block_steps, launch_chunks=1):
    """Drift after each NVE block from ``v0``, eV/atom."""
    state = commit(system.init_state(velocities=v0))
    e0 = jax_energy(system, state)
    trace = []
    for _ in range(blocks):
        state = commit(system.run(state, n_steps=block_steps, dt_fs=2.0,
                                  launch_chunks=launch_chunks))
        trace.append(jax_energy(system, state) - e0)
    return trace


LANGEVIN0 = dict(dt_fs=2.0, thermostat="langevin", temperature=300.0,
                 friction_ps=0.0)


def list_drift(positions, nbr) -> float:
    delta = np.asarray(positions) - np.asarray(nbr.reference_positions)
    return float(np.sqrt((delta * delta).sum(axis=1).max()))


def jax_probe_stale(system, v0, launches):
    """The reference's rows (benchmarks/probe_stale.py:49-61), zero
    friction, no warm-up."""
    state = commit(system.init_state(velocities=v0))
    rows = []
    for _ in range(launches):
        state = commit(system.run(state, n_steps=24, **LANGEVIN0))
        rows.append({"stale": bool(state.stale),
                     "max_drift3": list_drift(state.positions, state.nbr3),
                     "max_drift2": list_drift(state.positions, state.nbr2)})
    return rows


def jax_probe_stale_error(system, v0, max_samples):
    """The reference's procedure (benchmarks/probe_stale_error.py:58-88)
    with zero friction: per sample the drift, the frozen-list error, the
    rms force and the fresh forces."""
    state = commit(system.init_state(velocities=v0))
    x0 = state.positions
    nbr2_0, nbr3_0 = system.build_lists(x0, state.cell, wrapped=False)
    samples, drift = [], 0.0
    while drift < 2.2 * 0.5 * system.skin and len(samples) < max_samples:
        state = commit(system.run(state, n_steps=24, **LANGEVIN0))
        x1 = state.positions
        drift = float(jnp.max(jnp.sqrt(jnp.sum((x1 - x0) ** 2, axis=-1))))
        _, f_stale, _ = system.energy_forces(x1, nbr2_0, nbr3_0,
                                             cell=state.cell)
        nbr2_f, nbr3_f = system.build_lists(x1, state.cell, wrapped=False)
        _, f_fresh, _ = system.energy_forces(x1, nbr2_f, nbr3_f,
                                             cell=state.cell)
        samples.append((drift, float(jnp.max(jnp.abs(f_stale - f_fresh))),
                        float(jnp.sqrt(jnp.mean(f_fresh ** 2))),
                        np.asarray(f_fresh)))
    return samples


STALE_LAUNCHES = 5
PROBE_SAMPLES = 3


@pytest.fixture(scope="module")
def jax_ref():
    """Every JAX reference in one fixture: the suite clears JAX's
    compile caches after each test (tests/conftest.py), and one engine
    at the probes' cadence (6/3/24) then compiles each launch shape
    once for validate_final, validate_respa_mid, probe_stale and
    probe_stale_error; validate_respa takes one at 6/24 without a mid
    level."""
    jax3 = jax_engine(**CADENCE)
    jax2 = jax_engine(n_respa=6, rebuild_every=24)
    return {
        "final": jax_nve_trace(jax3, V300, blocks=3, block_steps=24,
                               launch_chunks=4),
        "mid": jax_nve_trace(jax3, V300, blocks=1, block_steps=24),
        "respa": jax_nve_trace(jax2, V300, blocks=1, block_steps=24),
        "stale": jax_probe_stale(jax3, V_HOT, STALE_LAUNCHES),
        "stale_error": jax_probe_stale_error(jax3, V300, PROBE_SAMPLES),
    }


@pytest.fixture(scope="module")
def port_final():
    return validate_final.run(6, 3, 24, warm_steps=0, blocks=3,
                              block_steps=24, model=port_model(),
                              velocities=V300, **CPU)


def test_validate_final_matches_jax(jax_ref, port_final):
    trace = jax_ref["final"]
    port = port_final["drift_trace_ev_per_atom"]
    assert np.abs(np.asarray(port) - trace).max() < DRIFT_TOL, (port, trace)
    assert port_final["final_drift_ev_per_atom"] == abs(port[-1])
    slope = np.polyfit([1.0, 2.0, 3.0], trace, 1)[0]
    assert abs(port_final["secular_heating_ev_per_atom_over_run"]
               - 3 * abs(slope)) < DRIFT_TOL
    assert port_final["shadow_amplitude_ev_per_atom"] \
        == max(abs(t) for t in port)
    assert port_final["n_steps"] == 72
    # the energies moved: the check compares something
    assert min(abs(t) for t in trace) > 1e-7


@pytest.fixture(scope="module")
def port_respa():
    return validate_respa.run(((6, 24),), warm_cycles=0, nve_cycles=1,
                              model=port_model(), velocities=V300, **CPU)


def test_validate_respa_matches_jax(jax_ref, port_respa):
    entry = port_respa["respa6_rb24"]
    trace = jax_ref["respa"]
    assert abs(entry["nve_drift_eV_per_atom"] - abs(trace[0])) < DRIFT_TOL
    assert entry["nve_steps"] == 24
    assert not entry["overflow"]
    assert entry["atom_steps_per_s_nve"] > 0
    assert abs(trace[0]) > 1e-7


@pytest.fixture(scope="module")
def port_mid(tmp_path_factory):
    out = tmp_path_factory.mktemp("respa_mid") / "validate_respa_mid.json"
    # an earlier sweep's entry stays in the artifact beside the new one
    out.write_text(json.dumps({"respa6_rb36_mid2": {"kept": True}}))
    return validate_respa_mid.run(((6, 24, 3),), warm_cycles=0,
                                  nve_cycles=1, window_steps=24,
                                  model=port_model(), velocities=V300,
                                  out_path=str(out), **CPU), out


def test_validate_respa_mid_matches_jax(jax_ref, port_mid):
    result, out = port_mid
    entry = result["respa6_rb24_mid3"]
    trace = jax_ref["mid"]
    assert abs(entry["nve_drift_eV_per_atom"] - abs(trace[0])) < DRIFT_TOL
    assert entry["nve_steps"] == 24 and not entry["overflow"]
    assert entry["atom_steps_per_s_nvt"] > 0
    assert json.loads(out.read_text()) == result
    assert result["respa6_rb36_mid2"] == {"kept": True}


@pytest.fixture(scope="module")
def port_stale():
    return probe_stale.run(warm_steps=0, launches=STALE_LAUNCHES,
                           model=port_model(), velocities=V_HOT,
                           friction_ps=0.0, **CPU)


def test_probe_stale_matches_jax(jax_ref, port_stale):
    rows = jax_ref["stale"]
    port = port_stale["per_launch"]
    assert [r["stale"] for r in port] == [r["stale"] for r in rows]
    for got, want in zip(port, rows):
        for key in ("max_drift3", "max_drift2"):
            assert abs(got[key] - want[key]) < LIST_DRIFT_TOL, (key, got,
                                                                want)
    # the flag tripped on some launch and not on another
    assert len({r["stale"] for r in rows}) == 2, rows


PROBE_ENGINE = dict(rebuild_every=24, n_respa=6, respa_mid=3)


@pytest.fixture(scope="module")
def port_stale_error():
    seen = []
    result = probe_stale_error.run(
        warm_steps=0, max_samples=PROBE_SAMPLES, model=port_model(),
        velocities=V300, friction_ps=0.0, engine=PROBE_ENGINE,
        callback=lambda sample, x1, forces, state: seen.append(
            forces.numpy().copy()), **CPU)
    return result, seen


def test_probe_stale_error_matches_jax(jax_ref, port_stale_error):
    result, forces = port_stale_error
    want = jax_ref["stale_error"]
    assert len(result["samples"]) == len(want) == PROBE_SAMPLES
    # no full rebuild in the window: the reference's drift is the true one
    assert result["rebuild_branches"]["full"] == 0
    for got, f_port, (drift, err, rms, f_jax) in zip(result["samples"],
                                                     forces, want):
        assert abs(got["max_drift_A"] - drift) < LIST_DRIFT_TOL
        assert got["past_stale_line"] == (drift > 0.25)
        assert np.abs(f_port - f_jax).max() < FORCE_TOL
        assert abs(got["max_abs_force_error_eV_A"] - err) < ERROR_TOL
        assert abs(got["rms_force_eV_A"] - rms) < FORCE_TOL
    assert result["skin_3b"] == 0.5 and result["stale_threshold_A"] == 0.25


def test_probe_stale_error_follows_atoms_across_a_wrap():
    """A full rebuild inside the probe's window (every cycle, with
    ``static_rebuild``) wraps atoms that crossed a face by a lattice
    vector; the probe's drift, positions and errors stay those of the
    run without a full rebuild (the 2-body skin holds at 300 K), which
    never wraps."""
    runs = {}
    for static in (True, False):
        seen = []
        result = probe_stale_error.run(
            warm_steps=0, max_samples=PROBE_SAMPLES, model=port_model(),
            velocities=V300, friction_ps=0.0,
            engine=dict(PROBE_ENGINE, static_rebuild=static),
            callback=lambda sample, x1, forces, state: seen.append(
                (x1.numpy().copy(), forces.numpy().copy(),
                 state.positions.numpy().copy())), **CPU)
        runs[static] = result, seen
    (wrapped, seen_w), (plain, seen_p) = runs[True], runs[False]
    assert wrapped["rebuild_branches"]["full"] == 3
    assert plain["rebuild_branches"]["full"] == 0
    cell = np.asarray(common.bcc_w(REPS).get_cell())
    # the wrapped state's positions jumped by a cell length somewhere
    jumps = [np.abs(state - x1).max() for x1, _, state in seen_w]
    assert max(jumps) > 0.5 * cell[0, 0], jumps
    for got, want, (x1_w, f_w, _), (x1_p, f_p, _) in zip(
            wrapped["samples"], plain["samples"], seen_w, seen_p):
        assert abs(got["max_drift_A"] - want["max_drift_A"]) \
            < LIST_DRIFT_TOL
        assert got["max_drift_A"] < 0.5
        assert np.abs(x1_w - x1_p).max() < LIST_DRIFT_TOL
        assert np.abs(f_w - f_p).max() < FORCE_TOL
        assert got["max_abs_force_error_eV_A"] < ERROR_TOL
        assert abs(got["max_abs_force_error_eV_A"]
                   - want["max_abs_force_error_eV_A"]) < ERROR_TOL


def test_lists_at_positions_out_of_the_cell():
    """``lists_at`` on atoms moved by whole lattice vectors gives the
    forces and energy of the lists built in the cell, and the same
    displacements slot by slot."""
    from uf3_tpu_torch.forcefield.md import MDSystem
    from uf3_tpu_torch.ops import neighbors as nb
    geom = common.bcc_w(REPS)
    geom.rattle(0.05, seed=1)
    system = MDSystem(port_model(), geom, dtype=torch.float64, device="cpu",
                      **ENGINE, **CADENCE)
    cell = system.cell
    x = nb.wrap_positions(torch.as_tensor(geom.get_positions()), cell,
                          system.pbc)
    n = torch.as_tensor(np.random.RandomState(2).randint(-2, 3, (128, 3)),
                        dtype=torch.float64)
    moved = x + nb.cell_transform(n, cell)
    lists = system.build_lists(x, cell)
    carried = probe_stale_error.lists_at(system, moved, cell)
    e_in, f_in, _ = system.energy_forces(x, *lists, cell=cell)
    e_out, f_out, _ = system.energy_forces(moved, *carried, cell=cell)
    assert abs(float(e_in - e_out)) < 1e-9
    assert float(torch.max(torch.abs(f_in - f_out))) < FORCE_TOL
    for inside, out in zip(lists, carried):
        d_in = nb.displacements(x, cell, inside.idx, inside.shift)
        d_out = nb.displacements(moved, cell, out.idx, out.shift)
        assert torch.equal(inside.idx, out.idx)
        assert float(torch.max(torch.abs(d_in - d_out))) < 1e-12
        assert torch.equal(out.reference_positions, moved)


def reference(name):
    with open(os.path.join(ARTIFACTS, name)) as f:
        return json.load(f)


CARD = set(common.CARD_FIELDS)


def test_validate_final_keys_match_the_reference(port_final):
    ref = reference("validate_final_12_6_36_lo25.json")
    assert set(port_final) == set(ref) | CARD
    assert set(port_final["config"]) == set(ref["config"])
    assert len(port_final["drift_trace_ev_per_atom"]) == 3


def test_validate_respa_keys_match_the_reference(port_respa):
    ref = reference("validate_respa.json")
    assert set(port_respa) == {"n_atoms", "platform", "respa6_rb24"} | CARD
    assert set(port_respa["respa6_rb24"]) == set(ref["respa3_rb18"])
    assert set(ref) >= {"n_atoms", "platform"}


def test_validate_respa_mid_keys_match_the_reference(port_mid):
    result, _ = port_mid
    ref = reference("validate_respa_mid.json")
    assert set(result) == {"n_atoms", "platform", "respa6_rb24_mid3",
                           "respa6_rb36_mid2"} | CARD
    # each entry names its card and commit: merged sweeps may differ
    assert set(result["respa6_rb24_mid3"]) \
        == set(ref["respa6_rb24_mid3"]) | {"card", "commit"}


def test_probe_stale_keys_match_the_reference(port_stale):
    ref = reference("probe_stale.json")
    assert set(port_stale) == set(ref) | CARD
    assert set(port_stale["per_launch"][0]) == set(ref["per_launch"][0])


def test_probe_stale_error_keys_match_the_reference(port_stale_error):
    result, _ = port_stale_error
    ref = reference("probe_stale_error.json")
    # the dtype and the rebuild branches of the window are the port's
    assert set(result) == set(ref) | CARD | {"dtype", "rebuild_branches"}
    assert set(result["samples"][0]) == set(ref["samples"][0])
    assert result["dtype"] == "float64" and result["platform"] == "cpu"


MAINS = {
    "validate_final": (validate_final, ["12", "6", "36", "2.5"],
                       "validate_final_12_6_36_lo25.json"),
    "validate_respa": (validate_respa, [], "validate_respa.json"),
    "validate_respa_mid": (validate_respa_mid, ["6:24:3"],
                           "validate_respa_mid.json"),
    "probe_stale": (probe_stale, [], "probe_stale.json"),
    "probe_stale_error": (probe_stale_error, ["0.5"],
                          "probe_stale_error.json"),
}


@pytest.mark.parametrize("name", sorted(MAINS))
def test_main_needs_the_card_unless_asked_for_the_cpu(name, monkeypatch,
                                                      tmp_path):
    """Without a card ``main`` raises; with ``--device cpu`` it passes
    the command line's arguments to the script's function (stubbed here:
    the runs above are the checks) and writes its artifact by the
    reference's name."""
    module, args, artifact = MAINS[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        module.main(args + ["--out-dir", str(tmp_path)])
    calls = []

    def stub(*a, **kw):
        calls.append((a, kw))
        if kw.get("out_path"):
            with open(kw["out_path"], "w") as f:
                json.dump({"stub": True}, f)
        return common.stamp({"stub": True, "dtype": "float64"},
                            torch.device(kw["device"]), "test")

    monkeypatch.setattr(module, "run", stub)
    module.main(args + ["--device", "cpu", "--reps", "2", "2", "2",
                        "--out-dir", str(tmp_path)])
    (a, kw), = calls
    assert kw["device"] == "cpu"
    assert os.path.exists(tmp_path / artifact)
    if name == "validate_final":
        assert a[:5] == (12, 6, 36, 2.5, (2, 2, 2))
    if name == "validate_respa_mid":
        assert a[:2] == ([(6, 24, 3)], (2, 2, 2))
    if name == "probe_stale_error":
        assert a[:2] == (0.5, (2, 2, 2)) and kw["dtype"] is None
