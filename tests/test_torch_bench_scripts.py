"""
The port's headline scripts (uf3_tpu_torch/benchmarks/{bench,
throughput_gate,budget_step}.py) and ``ops.trio.trio_bound`` on the CPU.

- ``bench`` at bcc W 7^3 with short windows: the root ``bench.py``'s
  keys and baseline (read from its source: it re-executes the
  interpreter at import), the median between the slowest and the
  fastest window, a raise on a forced overflow; ``md_scaling`` through
  the shared loop: the same trajectory and row as the loop it had.
- ``throughput_gate``: the breakdown's force call against the JAX
  engine's ``energy_forces`` at the same positions and lists (1e-10
  eV/A), its refilter and full build against JAX's as neighbor sets
  with the overflow flags; the artifact's keys against the reference's
  source and the trio kernel's key beside the reference's five; every
  exit path of the verdict; the rate's threshold and each phase's
  device limit from the committed gate artifact, a phase over its limit
  failing a gated run.
- ``budget_step``: the implementation-independent counts equal to
  ``benchmarks/budget_step.py``'s (loaded through importlib with its
  argv set: it parses argv at import), the shares from a card artifact
  at this run's size only, the newest artifact by its timestamp.
- ``trio_bound`` in ``ops/trio.py``: the flop and bytes the smoke
  printed before the move (9,826 atoms, the bench list, float32 rows).

The JAX references are computed in one module fixture: the suite clears
JAX's caches after every test (tests/conftest.py).
"""

import ast
import importlib.util
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uf3_tpu.data.atoms import bulk
from uf3_tpu.forcefield.md import MDSystem as JaxMDSystem
from uf3_tpu.regression import least_squares as ls
from uf3_tpu_torch.benchmarks import (anatomy_3l, bench, budget_step,
                                      common, md_scaling, probe_rebuild2,
                                      throughput_gate)
from uf3_tpu_torch.forcefield.md import MDSystem
from uf3_tpu_torch.ops import neighbors as tnb
from uf3_tpu_torch.ops import trio
from uf3_tpu_torch.ops.potential import UF3Potential

from test_torch_md import MODEL, port_model

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of a thread per core oversubscribes them
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = (4, 4, 4)
FORCE_TOL = 1e-10   # eV/A
SHORT = dict(warm_steps=36, window_steps=36)


def reference_source(path) -> ast.Module:
    with open(os.path.join(REPO, path)) as f:
        return ast.parse(f.read())


def dict_keys(tree: ast.Module, name: str) -> list:
    """The constant keys of the dict literal assigned to ``name``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(isinstance(t, ast.Name) and t.id == name
                        for t in node.targets):
            return [k.value for k in node.value.keys]
    raise KeyError(name)


def constant(tree: ast.Module, name: str):
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name
                for t in node.targets):
            return ast.literal_eval(node.value)
    raise KeyError(name)


def nested_dict_keys(tree: ast.Module, name: str, key: str) -> list:
    """The keys of the dict literal under ``key`` in the dict literal
    assigned to ``name``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(isinstance(t, ast.Name) and t.id == name
                        for t in node.targets):
            for k, v in zip(node.value.keys, node.value.values):
                if k.value == key and isinstance(v, ast.Dict):
                    return [kk.value for kk in v.keys]
    raise KeyError((name, key))


def sets(nbr) -> np.ndarray:
    return probe_rebuild2.neighbor_sets(np.asarray(nbr.idx),
                                        np.asarray(nbr.shift),
                                        np.asarray(nbr.mask))


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


# -- bench -----------------------------------------------------------------
def test_bench_line_has_the_reference_keys():
    tree = reference_source("bench.py")
    assert bench.BASELINE_ATOM_STEPS == constant(tree, "BASELINE_ATOM_STEPS")
    line = bench.run((7, 7, 7), warm_steps=12, window_steps=12, windows=3,
                     device="cpu", commit="test")
    assert set(dict_keys(tree, "result")) <= set(line)
    assert set(common.CARD_FIELDS) <= set(line)
    assert line["n_atoms"] == 686 and line["unit"] == "atom-steps/s"
    assert "686 atoms, cpu" in line["metric"]
    rates = line["window_atom_steps_per_s"]
    assert len(rates) == 3
    assert line["value_min"] <= line["value"] <= line["value_max"]
    assert line["value"] == pytest.approx(sorted(rates)[1], rel=1e-12)
    assert line["vs_baseline"] == pytest.approx(
        line["value"] / bench.BASELINE_ATOM_STEPS, rel=1e-12)
    assert isinstance(line["stale"], bool) and not line["overflow"]


@pytest.mark.parametrize("warm_steps", [36, 0])
def test_bench_raises_on_a_forced_overflow(monkeypatch, warm_steps):
    """A 3-body capacity that holds the lattice's 14 neighbors but not
    a 5,000 K state's: the run raises, in the warm-up or, with none, in
    the windows, whose flags are queued."""
    monkeypatch.setitem(common.BENCH, "capacity_3b", 14)
    monkeypatch.setattr(bench, "TEMPERATURE", 5000.0)
    with pytest.raises(RuntimeError, match="overflow"):
        bench.run(REPS, warm_steps=warm_steps, window_steps=36, windows=1,
                  device="cpu")


def old_md_scaling_loop(system, state, warm_steps, window_steps, windows):
    """md_scaling.run's loop before it went through bench.run_windows
    (the clock reads left out)."""
    kw = dict(dt_fs=2.0, thermostat="langevin", temperature=300.0,
              friction_ps=2.0)
    window = dict(kw, n_steps=window_steps, launch_chunks=10, sync=False)
    state = system.run(state, n_steps=warm_steps, **kw)
    assert not system.overflowed(state)
    warm_positions = state.positions.clone()
    state = system.run(state, **window)
    for _ in range(windows):
        state = system.run(state, **window)
    return state, warm_positions


def test_md_scaling_unchanged_through_the_shared_loop():
    keep = {}
    result = md_scaling.run((3,), windows=2, device="cpu", commit="test",
                            keep=keep, **SHORT)
    (kept,) = keep["sizes"]
    system = MDSystem(common.MODEL, common.bcc_w((3, 3, 3)),
                      dtype=torch.float64, device="cpu", **common.BENCH)
    state = system.init_state(temperature=300.0, seed=0)
    state, warm = old_md_scaling_loop(system, state, 36, 36, 2)
    assert torch.equal(kept["warm_positions"], warm)
    assert torch.equal(kept["state"].positions, state.positions)
    assert torch.equal(kept["state"].velocities, state.velocities)
    (row,) = result["sizes"]
    assert list(row) == [
        "n_atoms", "atom_steps_per_s", "ms_per_step", "overflow", "stale",
        "atom_steps_per_s_min", "atom_steps_per_s_max",
        "window_atom_steps_per_s", "busy_share", "traced_atom_steps_per_s"]
    assert row["overflow"] == system.overflowed(state)
    assert row["stale"] == bool(state.stale)


# -- throughput_gate against JAX -------------------------------------------
@pytest.fixture(scope="module")
def jax_gate():
    """The JAX engine's force call, full build and refilter at rattled
    bcc W 4^3 positions (some outside the cell), on the bench engine in
    float64."""
    geom = bulk("W", "bcc", a=common.LATTICE_A) * REPS
    x = geom.get_positions() + np.random.RandomState(3).normal(
        0.0, 0.08, (len(geom), 3))
    cell = np.asarray(geom.cell)
    model = ls.WeightedLinearModel.from_json(MODEL)
    system = JaxMDSystem(model, geom, dtype=jnp.float64, **common.BENCH)
    xj = jnp.asarray(x)
    wrapped = system._wrap(xj, jnp.asarray(cell))
    nbr2, nbr3 = system.build_lists(wrapped, jnp.asarray(cell), wrapped=True)
    forces = system.energy_forces(wrapped, nbr2, nbr3, with_energy=False)[1]
    from uf3_tpu.ops import neighbors as jnb
    refilter = jnb.filter_neighbor_list(
        nbr2, wrapped, jnp.asarray(cell), system.r_cut_3b + system.skin,
        system.capacity_3b)
    return {"x": x, "wrapped": np.asarray(wrapped), "cell": cell,
            "nbr2": nbr2, "nbr3": nbr3, "forces": np.asarray(forces),
            "refilter": refilter}


@pytest.fixture(scope="module")
def port_gate(jax_gate):
    """The port's bench engine and the gate's parts at the JAX engine's
    wrapped positions and lists."""
    system = MDSystem(port_model(), common.bcc_w(REPS), dtype=torch.float64,
                      device="cpu", **common.BENCH)
    state = system.init_state()
    state = state._replace(positions=torch.tensor(jax_gate["wrapped"]),
                           nbr2=port_list(jax_gate["nbr2"]),
                           nbr3=port_list(jax_gate["nbr3"]))
    return system, anatomy_3l.Parts.from_state(system, state)


def test_gate_fused_forces_match_jax(jax_gate, port_gate):
    system, p = port_gate
    got = throughput_gate.fused_forces(system, p, p.positions).numpy()
    want = jax_gate["forces"]
    assert np.abs(got - want).max() <= FORCE_TOL, np.abs(got - want).max()
    assert np.abs(want).max() > 1e-2   # the check compares something


def test_gate_rebuilds_match_jax(jax_gate, port_gate):
    system, p = port_gate
    refilter = anatomy_3l.refilter(p, p.positions)
    assert np.array_equal(sets(refilter), sets(jax_gate["refilter"]))
    assert bool(refilter.overflow) == bool(jax_gate["refilter"].overflow)
    # the full build from positions partly outside the cell
    x = torch.tensor(jax_gate["x"])
    nbr2, nbr3 = anatomy_3l.full_build(p, x)
    for got, want in ((nbr2, jax_gate["nbr2"]), (nbr3, jax_gate["nbr3"])):
        assert np.array_equal(sets(got), sets(want))
        assert bool(got.overflow) == bool(want.overflow)
    assert (sets(nbr3) >= 0).sum() > 0


# -- throughput_gate: the artifact and the verdict -------------------------
@pytest.fixture(scope="module")
def gate_artifact():
    return throughput_gate.run(REPS, windows=3, device="cpu", commit="test",
                               scan_len=2, **SHORT)


def test_gate_artifact_has_the_reference_keys(gate_artifact):
    tree = reference_source("benchmarks/throughput_gate.py")
    reference = dict_keys(tree, "artifact")
    assert list(throughput_gate.REFERENCE_KEYS) == reference
    assert set(reference) | set(common.CARD_FIELDS) <= set(gate_artifact)
    assert tuple(dict_keys(tree, "breakdown_ms")) == throughput_gate.PHASES
    # the reference's five keys, then the trio kernel's own
    assert throughput_gate.BREAKDOWN == throughput_gate.PHASES + ("trio",)
    assert tuple(gate_artifact["breakdown_ms"]) == throughput_gate.BREAKDOWN
    assert set(nested_dict_keys(tree, "artifact", "config")) \
        <= set(gate_artifact["config"])
    assert all(v is None for v in gate_artifact["breakdown_ms"].values())
    assert all(v > 0 for v in gate_artifact["breakdown_host_ms"].values())
    assert gate_artifact["platform"] == "cpu"
    assert not gate_artifact["gated"]       # the CPU is never gated
    assert gate_artifact["value_min"] <= gate_artifact["value"] \
        <= gate_artifact["value_max"]


def test_gate_threshold_from_the_committed_artifact():
    with open(os.path.join(common.ARTIFACTS,
                           throughput_gate.GATE_ARTIFACT)) as f:
        committed = json.load(f)
    assert committed["platform"] == "gpu" and committed["card"]
    # the artifact was written by this gate: its factors are the code's
    assert committed["host_factor"] == throughput_gate.HOST_FACTOR
    assert committed["device_factor"] == throughput_gate.DEVICE_FACTOR
    assert tuple(committed["breakdown_ms"]) == throughput_gate.BREAKDOWN
    assert throughput_gate.GATE_MEDIAN == committed["value"]
    assert throughput_gate.THRESHOLD_ATOM_STEPS == pytest.approx(
        throughput_gate.HOST_FACTOR * committed["value"], rel=1e-12)
    assert throughput_gate.DEVICE_LIMIT_MS == pytest.approx(
        {k: 1.15 * v for k, v in committed["breakdown_ms"].items()},
        rel=1e-12)
    # the least median the bench path recorded on the card passes
    assert throughput_gate.THRESHOLD_ATOM_STEPS < 2741033.8


@pytest.mark.parametrize("stale, probe, passes", [
    (False, None, True),
    (True, throughput_gate.STALE_PROBE, True),    # the f64 probe: 1.8e-15
    (True, "missing", False),
    (True, 1e-5, False),
    (True, 9.54e-7, True),
])
def test_gate_stale_policy(stale, probe, passes, tmp_path):
    if probe == "missing":
        probe = str(tmp_path / "probe_stale_error_float64.json")
    elif isinstance(probe, float):
        path = tmp_path / "probe.json"
        path.write_text(json.dumps(
            {"max_force_error_past_stale_line_eV_A": probe}))
        probe = str(path)
    elif probe is None:
        probe = str(tmp_path / "never_read.json")
    verdict = throughput_gate.judge(1e8, stale, probe)
    assert verdict["passed"] is passes and verdict["stale_ok"] is passes
    if stale and passes:
        assert verdict["stale_force_error_bound_eV_A"] < 1e-5


def test_gate_reads_the_float64_probe():
    assert os.path.basename(throughput_gate.STALE_PROBE) \
        == "probe_stale_error_float64.json"
    with open(throughput_gate.STALE_PROBE) as f:
        probe = json.load(f)
    assert probe["dtype"] == "float64"
    assert throughput_gate.stale_bound() \
        == probe["max_force_error_past_stale_line_eV_A"] < 1e-5


def test_gate_exit_paths(monkeypatch, tmp_path):
    """Gated and under the threshold: exit 1; with ``--no-gate``, or on
    the CPU: no exit, the artifact written."""
    assert throughput_gate.gated(torch.device("cuda"), False)
    assert not throughput_gate.gated(torch.device("cuda"), True)
    assert not throughput_gate.gated(torch.device("cpu"), False)
    low = throughput_gate.THRESHOLD_ATOM_STEPS / 2
    seen = []

    def stub(reps, device=None, no_gate=False, commit=None):
        # a card's run, under the threshold
        seen.append(no_gate)
        return dict(throughput_gate.judge(low, False), value=low,
                    gated=throughput_gate.gated(torch.device("cuda"),
                                                no_gate),
                    commit="test")

    monkeypatch.setattr(throughput_gate, "run", stub)
    argv = ["--out-dir", str(tmp_path)]
    with pytest.raises(SystemExit) as exit_info:
        throughput_gate.main(argv)
    assert exit_info.value.code == 1
    out = throughput_gate.main(argv + ["--no-gate"])
    assert not out["passed"] and not out["gated"] and seen == [False, True]
    assert json.loads((tmp_path / "bench_test.json").read_text())["value"] \
        == low


LIMITS = throughput_gate.DEVICE_LIMIT_MS


@pytest.mark.parametrize("device_ms, slow", [
    (None, set()),                                       # the CPU
    ({k: None for k in LIMITS}, set()),
    ({k: v / 1.15 for k, v in LIMITS.items()}, set()),   # the artifact's
    ({k: v for k, v in LIMITS.items()}, set()),          # at the limit
    ({"trio": 1.001 * LIMITS["trio"]}, {"trio"}),        # past the limit
    ({"fused_forces": 2 * LIMITS["fused_forces"],
      "rebuild_full": 0.5 * LIMITS["rebuild_full"]}, {"fused_forces"}),
    ({"a_phase_the_artifact_lacks": 1e9}, set()),
])
def test_gate_device_ms(device_ms, slow):
    """A phase's device ms over 1.15 x the committed artifact's fails the
    run whatever its rate; none measured (the CPU) gates nothing."""
    verdict = throughput_gate.judge(1e8, False, device_ms=device_ms)
    assert set(verdict["slow_phases"]) == slow
    assert verdict["passed"] is not slow
    assert verdict["device_limit_ms"] == LIMITS


def test_gate_exits_on_a_slow_phase(monkeypatch, tmp_path, capsys):
    """Gated, at a passing rate, with one phase over its limit: exit 1
    naming the phase."""
    rate = 2 * throughput_gate.THRESHOLD_ATOM_STEPS

    def stub(reps, device=None, no_gate=False, commit=None):
        return dict(throughput_gate.judge(
            rate, False, device_ms={"rebuild_full":
                                    1.2 * LIMITS["rebuild_full"]}),
            value=rate, gated=not no_gate, commit="test")

    monkeypatch.setattr(throughput_gate, "run", stub)
    with pytest.raises(SystemExit) as exit_info:
        throughput_gate.main(["--out-dir", str(tmp_path)])
    assert exit_info.value.code == 1
    err = capsys.readouterr().err
    assert "THROUGHPUT GATE FAILED: rebuild_full" in err
    assert "atom-steps/s" not in err.split("FAILED")[1]


# -- budget_step -------------------------------------------------------------
def reference_budget(monkeypatch):
    """``benchmarks/budget_step.py`` as a module (it reads argv at
    import)."""
    monkeypatch.setattr(sys, "argv", ["budget_step.py"])
    spec = importlib.util.spec_from_file_location(
        "reference_budget_step", os.path.join(REPO, "benchmarks",
                                              "budget_step.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("args", [
    dict(n_atoms=9826), dict(n_atoms=686, coord_3b=12, coord_2b=58),
    dict(n_atoms=31104, c_window=7, n_b=4)])
def test_budget_useful_flops_match_the_reference(args, monkeypatch):
    ref = reference_budget(monkeypatch)
    assert budget_step.useful_flops_per_step(**args) \
        == ref.useful_flops_per_step(**args)


@pytest.mark.parametrize("args", [
    (9826, 72, 16), (9826, 72, 16, False), (686, 88, 20)])
def test_budget_hbm_bytes_match_the_reference(args, monkeypatch):
    ref = reference_budget(monkeypatch)
    assert budget_step.hbm_bytes_per_step(*args) \
        == ref.hbm_bytes_per_step(*args)


def write(path, artifact):
    path.write_text(json.dumps(artifact))


def test_budget_shares_from_a_card_artifact_only(tmp_path):
    cpu = budget_step.run(REPS, device="cpu", artifacts=str(tmp_path),
                          commit="test")
    assert cpu["measured"]["e2e_ms_per_step"] is None
    assert cpu["measured"]["useful_share_of_peak"] is None
    phases = cpu["phases"]
    assert set(phases) == {"inner", "trio", "tail"}
    assert all(p["flop"] > 0 and p["bytes"] > 0 for p in phases.values())
    # the inner rows' live lanes: the short side's support, r < r_hi
    assert 0 < phases["inner"]["live_lanes"] <= 128 * 16
    assert phases["tail"]["live_lanes"] > phases["inner"]["live_lanes"]
    assert cpu["per_step_floor_ms"] == pytest.approx(
        phases["inner"]["ms"] + phases["trio"]["ms"] / 6
        + phases["tail"]["ms"] / 12, rel=1e-12)
    # an older card artifact whose file is newer, a newer one, and a
    # card artifact at another size: the newest by timestamp is read
    card = {"platform": "gpu", "card": "a card", "breakdown_ms": {},
            "config": {"n_atoms": 128}}
    write(tmp_path / "bench_new.json", dict(card, value=2.56e6,
                                            timestamp="2026-01-02T00:00:00"))
    write(tmp_path / "bench_old.json", dict(card, value=1.28e6,
                                            timestamp="2026-01-01T00:00:00"))
    write(tmp_path / "bench_other.json", dict(
        card, value=1e7, timestamp="2025-01-01T00:00:00",
        config={"n_atoms": 9826}))
    out = budget_step.run(REPS, device="cpu", artifacts=str(tmp_path))
    found = out["measured"]
    assert found["gate_artifact"] == "bench_new.json"
    assert found["e2e_ms_per_step"] == pytest.approx(0.05, rel=1e-12)
    sol = out["speed_of_light_ms"]
    assert found["useful_share_of_peak"] == pytest.approx(
        sol["useful_at_peak"] / 0.05, rel=1e-12)
    assert found["port_flop_share_of_peak"] == pytest.approx(
        sol["port_flop_at_peak"] / 0.05, rel=1e-12)
    assert found["floor_share_of_step"] == pytest.approx(
        out["per_step_floor_ms"] / 0.05, rel=1e-12)
    assert out["useful_physics_flops_per_step"] \
        == budget_step.useful_flops_per_step(128)


# -- trio_bound --------------------------------------------------------------
def test_trio_bound_as_the_smoke_printed_it():
    """At the bench list of 9,826 atoms (float32 rows of the float64
    engine's lattice state, as ``compare_trio`` builds them) the card
    printed 2.467e+08 flop and 5.819e+06 bytes before the move; the
    exact counts of the smoke's own function on this CPU are pinned."""
    base = UF3Potential.from_json(common.MODEL)
    system = MDSystem(base, common.bcc_w((17, 17, 17)), dtype=torch.float64,
                      device="cpu", **common.BENCH)
    # init_state's positions and lists, without its force call
    x = system._wrap(system._positions0, system.cell)
    _, nbr3 = system.build_lists(x, system.cell)
    cache = tnb.list_cache(nbr3, system.cell, torch.float64)
    d = tnb.cached_displacements(x, nbr3, cache)
    pot32 = UF3Potential.from_json(common.MODEL).to(dtype=torch.float32)
    d32, v32 = d.float(), cache.valid.float()
    ms, by, flop, n_bytes = trio.trio_bound(pot32, d32, v32, False)
    assert (f"{flop:.4g}", f"{n_bytes:.4g}", f"{ms:.5f}", by) == (
        "2.467e+08", "5.819e+06", "0.00368", "operations")
    assert (flop, n_bytes) == (246671904.0, 5818756)
    pinned = {(False, True): 291616028.0, (True, False): 175020712.0}
    for (triangle, energy), want in pinned.items():
        got = trio.trio_bound(pot32, d32, v32, energy, triangle=triangle)
        assert (got[2], got[3]) == (want, 5818756)
    got = trio.trio_bound(base, d, cache.valid, True,
                          peak=trio.PEAK_FLOPS[torch.float64])
    assert got[2:] == (291616028.0, 11637512)
    # the smoke imports this function and keeps no copy of its own
    tree = reference_source("chip_smoke.py")
    assert not any(isinstance(n, ast.FunctionDef) and n.name == "trio_bound"
                   for n in ast.walk(tree))
    assert any(isinstance(n, ast.ImportFrom)
               and n.module == "uf3_tpu_torch.ops.trio"
               and [a.name for a in n.names] == ["trio_bound"]
               for n in ast.walk(tree))
