"""
The port's last measurement scripts (uf3_tpu_torch/benchmarks/
{anatomy_3l,probe_rebuild2,md_scaling,featurize_throughput,
fit_wallclock,melting_run}.py) against the JAX package in float64 on the
CPU.  The scripts of benchmarks/ re-execute the interpreter at import
(all but melting_run.py), so the JAX side is built here from uf3_tpu's
functions, as those scripts build it.

- The 3-level anatomy's phase bodies on bcc W 4^3, at the positions and
  lists of the JAX engine after md_scaling's warm-up (144 steps of the
  bench engine, 12/6/36, from numpy velocities at zero friction, which
  the port's warm-up must follow within 1e-9 A): each force within
  1e-10 eV/A of the JAX function the reference body calls, the triggers
  as ``needs_rebuild``'s, the refilter's neighbor sets as
  ``filter_neighbor_list``'s; the cycle weights; a two-cycle run.
- The full rebuild at 7^3 = 686 atoms (the smallest bcc W cell on which
  the engine takes the cell list): the sets and overflow flags of JAX's
  ``build_neighbor_list_cells`` + ``filter_neighbor_list`` and of the
  native host cell list.
- The fit data bit for bit, features on a 6-configuration cut within
  1e-10 of ``featurize_dataset_device``, and the energies and forces of
  the fitted model on them within 1e-8 relative of the model
  ``WeightedLinearModel.fit`` fits.
- ``melting_run``'s ``main`` beside the reference's (importable: it
  execs only as a script) with ``run_trial`` stubbed in both.

Every JAX reference is computed in one module fixture: the suite clears
JAX's caches after every test (tests/conftest.py).
"""

import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uf3_tpu.data.atoms import bulk
from uf3_tpu.data.composition import ChemicalSystem
from uf3_tpu.forcefield import units
from uf3_tpu.forcefield.md import MDSystem as JaxMDSystem
from uf3_tpu.ops import neighbors as jnb
from uf3_tpu.ops import pallas_trio as pt
from uf3_tpu.ops.featurize_jax import featurize_dataset_device
from uf3_tpu.regression import least_squares as ls
from uf3_tpu.representation.basis import BSplineBasis
from uf3_tpu_torch.benchmarks import (anatomy_3l, bench, budget_step,
                                      common, featurize_throughput,
                                      fit_wallclock, md_scaling, melting_run,
                                      probe_rebuild2, throughput_gate)
from uf3_tpu_torch.examples import melting_point
from uf3_tpu_torch.forcefield.md import MDSystem
from uf3_tpu_torch.ops import neighbors as tnb

from test_torch_md import MODEL, port_model

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of a thread per core oversubscribes them
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = (4, 4, 4)
REBUILD_REPS = (7, 7, 7)
FORCE_TOL = 1e-10     # eV/A
POSITION_TOL = 1e-9   # A
FEATURE_TOL = 1e-10
PREDICTION_TOL = 1e-8  # relative
FIT_CONFIGS = 6
WARM = dict(dt_fs=2.0, thermostat="langevin", temperature=300.0,
            friction_ps=0.0)


def velocities(n_atoms, temperature=300.0):
    """Maxwell-Boltzmann velocities of W (internal units), zero total
    momentum, from RandomState(0)."""
    v = np.random.RandomState(0).normal(
        0.0, np.sqrt(units.kB * temperature / 183.84), (n_atoms, 3))
    return v - v.mean(axis=0)


V300 = velocities(128)


def jax_bcc(reps):
    return bulk("W", "bcc", a=common.LATTICE_A) * tuple(reps)


def port_list(nbr) -> tnb.NeighborList:
    """A JAX NeighborList as the port's, on the CPU."""
    sel = None if nbr.sel is None \
        else torch.tensor(np.asarray(nbr.sel), dtype=torch.int64)
    return tnb.NeighborList(
        idx=torch.tensor(np.asarray(nbr.idx), dtype=torch.int64),
        shift=torch.tensor(np.asarray(nbr.shift)),
        mask=torch.tensor(np.asarray(nbr.mask)),
        rev=torch.tensor(np.asarray(nbr.rev), dtype=torch.int64),
        overflow=torch.tensor(bool(nbr.overflow)),
        reference_positions=torch.tensor(
            np.asarray(nbr.reference_positions)), sel=sel)


def sets(nbr) -> np.ndarray:
    return probe_rebuild2.neighbor_sets(np.asarray(nbr.idx),
                                        np.asarray(nbr.shift),
                                        np.asarray(nbr.mask))


def moved(x, atom, dx):
    """``x`` with one atom moved by ``dx`` A along x."""
    y = np.array(x)
    y[atom, 0] += dx
    return y


def trigger_points(x):
    """Positions at which the staleness flags are read: the warm
    positions, one atom moved past the 3-body skin (0.5 A) only, and
    past the 2-body one (1.2 A)."""
    return [np.asarray(x), moved(x, 5, 0.6), moved(x, 5, 1.3)]


def jax_anatomy(model, x, cell, nbr2, nbr3):
    """What the reference's phase bodies compute
    (benchmarks/anatomy_3l.py:104-186) at ``x`` on the lists, with the
    reference's engine at 9/3/27 (its switch and skins)."""
    system = JaxMDSystem(model, jax_bcc(REPS), dtype=jnp.float64,
                         rebuild_every=27, n_respa=9, respa_mid=3,
                         **anatomy_3l.ENGINE)
    spec, coeff = system.pair_fast
    tb = system.trio_bundle
    r_lo, r_hi = system.respa_switch
    trio = dict(spec_l=tb.spec_l, spec_n=tb.spec_n, l_basis=tb.l_basis,
                n_basis=tb.n_basis, block_atoms=64, with_energy=False,
                active_bc=tb.active_bc, window=tb.window)
    out = {
        "switch": (r_lo, r_hi),
        "pair_short": pt.pair_short_forces(
            coeff, x, cell, nbr3, spec_pair=spec, n_basis_pair=spec.n_basis,
            with_energy=False, r_lo=r_lo, r_hi=r_hi)[1],
        "gather": jnb.displacements(x, cell, nbr3.idx, nbr3.shift),
        "tail": pt.pair_tail_forces(
            coeff, x, cell, nbr2, spec_pair=spec, n_basis_pair=spec.n_basis,
            with_energy=False, r_lo=r_lo, r_hi=r_hi)[1],
        "refilter": jnb.filter_neighbor_list(
            nbr2, x, cell, system.r_cut_3b + system.skin,
            system.capacity_3b),
        "stale": [bool(jnb.needs_rebuild(nbr2, jnp.asarray(y),
                                         system.skin_2b)
                       | jnb.needs_rebuild(nbr3, jnp.asarray(y),
                                           system.skin))
                  for y in trigger_points(x)]}
    for name, triangle in (("trio", False), ("trio_triangle", True)):
        out[name] = pt.trio_forces_unrolled(
            tb.grid, x, cell, nbr3.idx, nbr3.shift, nbr3.mask, nbr3.rev,
            triangle=triangle, **trio)[1]
    return {k: v if k in ("refilter", "stale", "switch") else np.asarray(v)
            for k, v in out.items()}


def jax_rebuild():
    """The reference's full build (benchmarks/probe_rebuild2.py:108-118)
    on the wrapped bcc W 7^3 lattice, at the port's bin geometry."""
    geom = jax_bcc(REBUILD_REPS)
    x = jnp.asarray(np.asarray(geom.positions))
    cell = np.asarray(geom.cell)
    pbc = tuple(bool(p) for p in geom.pbc)
    r2, r3 = 5.5 + 1.2, 3.5 + 0.5
    grid, bin_capacity, topology = MDSystem._cell_list_geometry(
        np.asarray(geom.positions), cell, pbc, r2)
    nbr2 = jnb.build_neighbor_list_cells(
        x, jnp.asarray(cell), pbc, r2, 72, grid, bin_capacity, topology,
        with_rev=False, assume_wrapped=True)
    nbr3 = jnb.filter_neighbor_list(nbr2, x, jnp.asarray(cell), r3, 16)
    return nbr2, nbr3


def jax_fit_dataset(n_configs, reps_of):
    """The reference scripts' dataset (benchmarks/fit_wallclock.py:48-58,
    featurize_throughput.py:33-43)."""
    rng = np.random.RandomState(0)
    geometries, energies, forces = [], [], []
    for i in range(n_configs):
        geom = jax_bcc(reps_of(i))
        geom.rattle(0.02 + 0.08 * (i % 5) / 4, seed=i)
        geometries.append(geom)
        energies.append(float(rng.normal(-11.0, 0.1) * len(geom)))
        forces.append(rng.normal(size=(3, len(geom))) * 0.5)
    return geometries, energies, forces


def fit_reps(i):
    return (3, 3, 3) if i % 3 else (4, 4, 4)


def jax_basis():
    return BSplineBasis(
        ChemicalSystem(["W"], degree=3),
        r_min_map={("W", "W"): 1.5, ("W", "W", "W"): [1.5, 1.5, 1.5]},
        r_max_map={("W", "W"): 5.5, ("W", "W", "W"): [3.5, 3.5, 7.0]},
        resolution_map={("W", "W"): 25, ("W", "W", "W"): [6, 6, 12]})


@pytest.fixture(scope="module")
def jax_ref():
    """Every JAX reference in one fixture: the bench engine's warm-up
    (md_scaling) and the anatomy's bodies on its last positions and
    lists, the full rebuild at 7^3, the fit data, features and
    coefficients."""
    model = ls.WeightedLinearModel.from_json(MODEL)
    system = JaxMDSystem(model, jax_bcc(REPS), dtype=jnp.float64,
                         **common.BENCH)
    state = jax.device_put(system.init_state(velocities=V300),
                           jax.devices()[0])
    for _ in range(md_scaling.WARM_STEPS // 36):
        state = jax.device_put(system.run(state, n_steps=36, **WARM),
                               jax.devices()[0])
    x = np.asarray(state.positions)
    cell = np.asarray(state.cell)
    out = {"warm_positions": x, "cell": cell, "nbr2": state.nbr2,
           "nbr3": state.nbr3,
           "anatomy": jax_anatomy(model, jnp.asarray(x), jnp.asarray(cell),
                                  state.nbr2, state.nbr3),
           "rebuild": jax_rebuild()}
    data = jax_fit_dataset(FIT_CONFIGS, fit_reps)
    rows = featurize_dataset_device(jax_basis(), *data)
    fit = ls.WeightedLinearModel(jax_basis(), c2=1e-8, c3=1e-8)
    fit.fit(*(np.asarray(r) for r in rows), weight=0.5)
    out.update(fit_data=data, fit_rows=[np.asarray(r) for r in rows],
               coefficients=np.asarray(fit.coefficients))
    return out


# -- md_scaling ----------------------------------------------------------
@pytest.fixture(scope="module")
def port_scaling():
    keep = {}
    result = md_scaling.run((4,), window_steps=36, windows=1, device="cpu",
                            model=port_model(), velocities=V300,
                            friction_ps=0.0, keep=keep)
    return result, keep["sizes"][0]


def test_md_scaling_warm_up_follows_jax(jax_ref, port_scaling):
    _, kept = port_scaling
    got = kept["warm_positions"].numpy()
    assert np.abs(got - jax_ref["warm_positions"]).max() < POSITION_TOL
    # the atoms moved: the check compares something
    assert np.abs(got - common.bcc_w(REPS).get_positions()).max() > 0.05


def test_md_scaling_rows(tmp_path):
    out = tmp_path / "md_scaling.json"
    result = md_scaling.run((3, 4), warm_steps=36, window_steps=36,
                            windows=3, device="cpu", model=port_model(),
                            commit="test", out_path=str(out))
    reference = json.load(open(os.path.join(
        REPO, "benchmarks_data", "artifacts", "md_scaling.json")))
    assert set(result) >= set(reference) | set(common.CARD_FIELDS)
    assert json.loads(out.read_text()) == result
    assert [row["n_atoms"] for row in result["sizes"]] == [54, 128]
    for row in result["sizes"]:
        assert set(row) >= set(reference["sizes"][0])
        rates = row["window_atom_steps_per_s"]
        assert len(rates) == 3 and sorted(rates)[1] == pytest.approx(
            row["atom_steps_per_s"], rel=1e-12)
        assert row["atom_steps_per_s_min"] == pytest.approx(min(rates))
        assert row["atom_steps_per_s_max"] == pytest.approx(max(rates))
        assert row["ms_per_step"] == pytest.approx(
            1e3 * row["n_atoms"] / row["atom_steps_per_s"])
        assert not row["overflow"] and row["busy_share"] is None
    assert result["platform"] == "cpu" and result["card"] is None


# -- anatomy_3l ----------------------------------------------------------
@pytest.fixture(scope="module")
def port_parts(jax_ref):
    """The port's anatomy parts at 9/3/27 on the JAX engine's last
    positions and lists."""
    system = MDSystem(port_model(), common.bcc_w(REPS), dtype=torch.float64,
                      device="cpu", **anatomy_3l.engine(anatomy_3l.CADENCE))
    state = system.init_state(velocities=V300)
    state = state._replace(positions=torch.tensor(jax_ref["warm_positions"]),
                           nbr2=port_list(jax_ref["nbr2"]),
                           nbr3=port_list(jax_ref["nbr3"]))
    return anatomy_3l.Parts.from_state(system, state)


def _close(got, want, tol=FORCE_TOL):
    got = got.numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= tol, np.abs(got - want).max()
    assert np.abs(want).max() > 1e-3   # the check compares something


def test_anatomy_forces_match_jax(jax_ref, port_parts):
    p, ref = port_parts, jax_ref["anatomy"]
    assert (p.r_lo, p.r_hi) == ref["switch"] == (3.0, 3.5)
    x = p.positions
    _close(anatomy_3l.inner_force(p, x), ref["pair_short"])
    _close(anatomy_3l.inner_math(p, p.d0), ref["pair_short"])
    _close(anatomy_3l.gather(p, x), ref["gather"])
    _close(anatomy_3l.trio_force(p, x, p.d0), ref["trio"])
    _close(anatomy_3l.trio_force(p, x, p.d0, triangle=True),
           ref["trio_triangle"])
    _close(anatomy_3l.tail_force(p, x), ref["tail"])


def test_anatomy_triggers_and_refilter_match_jax(jax_ref, port_parts):
    p, ref = port_parts, jax_ref["anatomy"]
    flags = [bool(anatomy_3l.stale_flag(p, torch.tensor(y)))
             for y in trigger_points(p.positions.numpy())]
    assert flags == ref["stale"] and False in flags and True in flags
    got, want = anatomy_3l.refilter(p, p.positions), ref["refilter"]
    assert probe_rebuild2.same_sets(sets(got), sets(want))
    assert bool(got.overflow) == bool(want.overflow) is False
    assert torch.equal(got.reference_positions, p.positions)


def test_anatomy_bodies_chain_and_draw_from_the_state_generator(port_parts):
    x = port_parts.positions
    for name, fn in anatomy_3l.bodies(port_parts).items():
        before = port_parts.generator.get_state()
        y = fn(x)
        assert y.shape == x.shape and bool(torch.isfinite(y).all()), name
        assert float(torch.abs(y - x).max()) < 1e-20, name
        drew = not torch.equal(before, port_parts.generator.get_state())
        assert drew == (name == "langevin"), name


@pytest.mark.parametrize("cadence, weights", [((9, 3, 27), (27, 9, 3)),
                                              ((12, 6, 36), (36, 6, 3))])
def test_anatomy_cycle_weights(cadence, weights):
    w = anatomy_3l.cycle_weights(cadence, dict(keep=1, refilter=2, full=1))
    assert (w["inner_force_fresh_gather"], w["trio_map_comps_reuse"],
            w["tail_force"]) == weights
    assert w["stale_check_both"] == w["langevin"] == cadence[2]
    assert (w["rebuild_3b_filter"], w["rebuild_full_standalone"]) == (
        0.5, 0.25)
    ms = dict.fromkeys(w, 1.0)
    assert anatomy_3l.cycle_model(ms, w, cadence[2]) == pytest.approx(
        sum(w.values()) / cadence[2])
    assert anatomy_3l.cycle_model(dict(ms, langevin=None), w,
                                  cadence[2]) is None
    # the bench cadence takes the bench engine, switch included
    engine = anatomy_3l.engine(cadence)
    assert (engine == common.BENCH) == (cadence == (12, 6, 36))


def test_anatomy_two_cycle_run():
    keep = {}
    result = anatomy_3l.run(reps=REPS, warm_steps=27, windows=1,
                            window_cycles=2, scan_len=2, device="cpu",
                            model=port_model(), commit="test", keep=keep)
    reference = json.load(open(os.path.join(
        REPO, "benchmarks_data", "artifacts", "anatomy_3l.json")))
    assert set(result) >= set(reference) | set(common.CARD_FIELDS)
    assert set(result["config"]) >= set(reference["config"])
    # one refilter a cycle and no full build at 300 K
    assert result["rebuild_branches"] == dict(keep=0, refilter=2, full=0)
    assert result["window_steps"] == 54
    # as many windows again after the phases
    assert len(result["e2e_after_phases_windows_ms_per_step"]) == 1
    assert result["e2e_after_phases_ms_per_step"] > 0
    phases = set(reference["scan_chained_ms"]) - {"null_scan",
                                                  "langevin_rbg"}
    assert set(result["host_ms"]) == phases | {"langevin"}
    assert all(v > 0 for v in result["host_ms"].values())
    assert all(v is None for v in result["scan_chained_ms"].values())
    assert result["node_floor_ms"] is None
    assert set(result["net_of_null_ms"]) == set(reference["net_of_null_ms"]) \
        - {"langevin_rbg"} | {"langevin"}
    weights = result["cycle_weights"]
    assert weights["rebuild_3b_filter"] == 1.0
    assert weights["rebuild_full_standalone"] == 0.0
    model = sum(w * result["host_ms"][k] for k, w in weights.items()) / 27
    assert result["cycle_model_ms_per_step"] == pytest.approx(model)
    assert result["unmodeled_ms_per_step"] == pytest.approx(
        result["e2e_ms_per_step"] - model)
    assert result["cycle_model_device_ms_per_step"] is None
    assert result["unmodeled_device_ms_per_step"] is None
    assert keep["system"].rebuild_branches["full"] == 0


# -- probe_rebuild2 --------------------------------------------------------
@pytest.fixture(scope="module")
def port_rebuild():
    keep = {}
    result = probe_rebuild2.run(sizes=(REBUILD_REPS,), device="cpu",
                                model=port_model(), calls=1, keep=keep)
    return result, keep["sizes"][0]


def test_probe_rebuild2_matches_jax_and_native(jax_ref, port_rebuild):
    result, kept = port_rebuild
    (entry,) = result["sizes"]
    # the smallest bcc W cell that takes the cell list at 6.7 A
    assert entry["n_atoms"] == 686 and entry["grid"] == [3, 3, 3]
    small = MDSystem(port_model(), common.bcc_w((6, 6, 6)),
                     dtype=torch.float64, device="cpu", **common.BENCH)
    assert small._cells_2b is None
    assert kept["system"]._cells_2b is not None
    assert np.array_equal(kept["positions"].numpy(),
                          common.bcc_w(REBUILD_REPS).get_positions())
    for got, want in zip(kept["lists"], jax_ref["rebuild"]):
        assert probe_rebuild2.same_sets(sets(got), sets(want))
        assert bool(got.overflow) == bool(want.overflow) is False
    assert entry["lists_equal_native"]
    for name, count in (("2b", 64), ("3b", 14)):
        check = entry["native"][name]
        assert check["flags_equal"] and check["sets_equal"], name
        assert check["native_max_count"] == count and not check["overflow"]
    assert entry["host_ms"] > 0 and entry["device_busy_ms"] is None
    assert entry["host_syncs"] is None


def test_probe_rebuild2_native_check_sees_a_lost_pair(port_rebuild):
    """The cross-check fails where the card's list lost a neighbor, and
    where the overflow flags differ."""
    _, kept = port_rebuild
    nbr2, nbr3 = kept["lists"]
    mask = nbr2.mask.clone()
    mask[7, int(torch.nonzero(mask[7])[0])] = False
    check = probe_rebuild2.native_check(
        kept["system"], kept["positions"], (nbr2._replace(mask=mask), nbr3))
    assert not check["2b"]["sets_equal"] and check["3b"]["sets_equal"]
    check = probe_rebuild2.native_check(
        kept["system"], kept["positions"],
        (nbr2, nbr3._replace(overflow=torch.tensor(True))))
    assert not check["3b"]["flags_equal"]


# -- featurize_throughput and fit_wallclock --------------------------------
@pytest.mark.parametrize("script, n, reps_of", [
    (fit_wallclock, FIT_CONFIGS, fit_reps),
    (featurize_throughput, 3, lambda i: (4, 4, 4))])
def test_fit_data_bit_for_bit(script, n, reps_of):
    geoms, energies, forces = script.build_dataset(n)
    ref = jax_fit_dataset(n, reps_of)
    for got, want in zip(geoms, ref[0]):
        assert np.array_equal(got.get_positions(), np.asarray(want.positions))
        assert np.array_equal(got.get_cell(), np.asarray(want.cell))
    assert energies == ref[1]
    for got, want in zip(forces, ref[2]):
        assert np.array_equal(np.asarray(got).T, want)


def test_fit_wallclock_matches_jax(jax_ref):
    keep = {}
    result = fit_wallclock.run(FIT_CONFIGS, device="cpu", commit="test",
                               keep=keep)
    for got, want in zip(keep["rows"], jax_ref["fit_rows"]):
        assert got.shape == want.shape
        assert np.abs(got - want).max() < FEATURE_TOL
    # the fitted model's energies and forces on the rows: the 1-body
    # offset and a constant added to every pair coefficient trade off
    # (each cell holds nearly the same count of pairs per atom, and a
    # constant shift of a B-spline moves no force), so along that
    # direction the coefficients rest on the last bits of the Gram
    # matrix, which the two packages sum in other orders
    coefficients = np.asarray(keep["model"].coefficients)
    want = jax_ref["coefficients"]
    for x in (jax_ref["fit_rows"][0], jax_ref["fit_rows"][2]):
        predicted = x @ want
        assert np.abs(x @ coefficients - predicted).max() \
            < PREDICTION_TOL * np.abs(predicted).max()
    reference = json.load(open(os.path.join(
        REPO, "benchmarks_data", "artifacts", "fit_wallclock.json")))
    target = {"round2_target_ms_per_config", "meets_target"}
    assert set(result) == set(reference) - target | set(common.CARD_FIELDS)
    assert (result["n_configs"], result["n_atoms_total"]) == (6, 4 * 54
                                                             + 2 * 128)
    assert result["n_force_rows"] == 3 * result["n_atoms_total"]
    assert result["total_s"] == result["featurize_s"] + result["solve_s"]


def test_featurize_throughput_runs(tmp_path):
    keep = {}
    result = featurize_throughput.run(2, device="cpu", commit="test",
                                      keep=keep)
    x_e, y_e, x_f, y_f = keep["rows"]
    assert result["x_e_shape"] == list(x_e.shape) == [2, x_f.shape[1]]
    assert result["x_f_shape"] == [2 * 3 * 128, x_f.shape[1]]
    assert result["featurize_ms_per_config"] == pytest.approx(
        500 * result["featurize_s"])
    assert result["platform"] == "cpu" and result["commit"] == "test"


# -- the mains ---------------------------------------------------------------
MAINS = {
    "anatomy_3l": (anatomy_3l, ["--cadence", "12", "6", "36", "--reps", "2",
                                "2", "2"], "anatomy_3l_12_6_36.json"),
    "probe_rebuild2": (probe_rebuild2, ["--reps", "7", "7", "7"],
                       "probe_rebuild2.json"),
    "md_scaling": (md_scaling, ["3"], "md_scaling.json"),
    "featurize_throughput": (featurize_throughput, ["5"],
                             "featurize_throughput.json"),
    "fit_wallclock": (fit_wallclock, ["7"], "fit_wallclock.json"),
    # bench prints its line and writes no artifact
    "bench": (bench, ["--reps", "7", "7", "7"], None),
    "throughput_gate": (throughput_gate, ["--reps", "4", "4", "4"],
                        "bench_test.json"),
    "budget_step": (budget_step, ["--reps", "4", "4", "4"],
                    "budget_step.json"),
}


@pytest.mark.parametrize("name", sorted(MAINS))
def test_main_needs_the_card_unless_asked_for_the_cpu(name, monkeypatch,
                                                      tmp_path):
    """Without a card ``main`` raises; with ``--device cpu`` it passes
    the command line's arguments to ``run`` (stubbed: the runs above are
    the checks) and writes the artifact by its name."""
    module, args, artifact = MAINS[name]
    if artifact is not None:
        args = args + ["--out-dir", str(tmp_path)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        module.main(args)
    calls = []

    def stub(*a, **kw):
        calls.append((a, kw))
        common.resolve_device(kw["device"])
        result = common.stamp({"stub": True, "gated": False},
                              torch.device("cpu"), "test")
        if kw.get("out_path"):
            common.write_artifact(result, str(tmp_path), artifact)
        return result

    monkeypatch.setattr(module, "run", stub)
    assert module.main(args + ["--device", "cpu"])["stub"]
    (a, kw), = calls
    assert kw["device"] == "cpu"
    if artifact is not None:
        assert json.loads((tmp_path / artifact).read_text())["stub"]
    expected = {"anatomy_3l": ((12, 6, 36), (2, 2, 2)),
                "probe_rebuild2": (((7, 7, 7),),),
                "md_scaling": ((3,),), "featurize_throughput": (5,),
                "fit_wallclock": (7,), "bench": ((7, 7, 7),),
                "throughput_gate": ((4, 4, 4),),
                "budget_step": ((4, 4, 4),)}[name]
    assert a == expected


# -- melting_run -----------------------------------------------------------
def reference_melting_run():
    """``benchmarks/melting_run.py`` as a module (it re-executes only
    when run as a script)."""
    spec = importlib.util.spec_from_file_location(
        "reference_melting_run", os.path.join(REPO, "benchmarks",
                                              "melting_run.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


VERDICTS = {2500.0: "grew", 3000.0: "flat", 3500.0: "shrank",
            4000.0: "shrank", 4500.0: "grew"}


def stub_trial(model, trial_t, reps, n_obs, **kw):
    return {"T": trial_t, "n_atoms": 2 * int(np.prod(reps)),
            "obs_steps": n_obs, "verdict": VERDICTS[trial_t]}


def run_both(monkeypatch, tmp_path, temps, before=None):
    """Both mains on ``temps`` with ``run_trial`` stubbed alike, each
    appending to its own copy of ``before``; returns (reference's,
    port's) artifacts."""
    reference = reference_melting_run()
    monkeypatch.setattr(reference, "run_trial", stub_trial)
    monkeypatch.setattr(melting_point, "run_trial", stub_trial)
    paths = [tmp_path / "reference.json", tmp_path / "port.json"]
    if before is not None:
        for path in paths:
            path.write_text(json.dumps(before))
    args = [str(t) for t in temps] + ["--reps", "4", "2", "2", "--obs",
                                      "64"]
    monkeypatch.setattr(sys, "argv", ["melting_run.py"] + args
                        + ["--out", str(paths[0])])
    reference.main()
    melting_run.main(args + ["--out", str(paths[1]), "--device", "cpu",
                             "--commit", "test"])
    return [json.loads(path.read_text()) for path in paths]


def _trials(artifact):
    return [{k: v for k, v in t.items() if k not in ("card", "commit")}
            for t in artifact["trials"]]


def test_melting_run_matches_the_reference(monkeypatch, tmp_path):
    before = {"trials": [stub_trial(None, 3000.0, (4, 2, 2), 64)]}
    ref, port = run_both(monkeypatch, tmp_path, [2500.0, 3500.0], before)
    assert _trials(port) == _trials(ref) == ref["trials"]
    assert [t["T"] for t in port["trials"]] == [3000.0, 2500.0, 3500.0]
    assert port["melting_point_bracket_K"] \
        == ref["melting_point_bracket_K"] == [2500.0, 3500.0]
    # the appended trials carry their card and commit
    assert [t.get("commit") for t in port["trials"]] == [None, "test",
                                                         "test"]
    assert port["trials"][1]["card"] == "cpu"
    assert set(port) == set(ref) | set(common.CARD_FIELDS)


def test_melting_run_writes_no_reversed_bracket(monkeypatch, tmp_path):
    ref, port = run_both(monkeypatch, tmp_path, [4000.0, 4500.0])
    assert _trials(port) == _trials(ref)
    # 4,000 K shrank and 4,500 K grew: the reference writes the reversed
    # pair, the port no bracket
    assert ref["melting_point_bracket_K"] == [4500.0, 4000.0]
    assert "melting_point_bracket_K" not in port
    assert melting_run.bracket(port["trials"]) is None
    assert melting_run.bracket(port["trials"][:1] + [
        stub_trial(None, 4500.0, (1, 1, 1), 1) | {"verdict": "shrank"},
        stub_trial(None, 2500.0, (1, 1, 1), 1)]) == [2500.0, 4000.0]
