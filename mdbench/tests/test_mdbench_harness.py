"""The harness: its files against BENCHMARK.json, the format's names
and units, the frozen arithmetic on known inputs, the check that decides
``correct`` (a sound run passes; the TF32 control and a broken program
fail), and what a run may load and open.  CPU at 128 atoms unless marked
``cuda``."""

import json
import math
import os
import re
import subprocess
import sys

import pytest
import torch

from mdbench import faults, harness, reference, yardstick

ROOT = harness.ROOT
BENCH = harness.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
NUMBERS = ("force_max_err_eV_A", "step_force_max_err_eV_A",
           "energy_err_eV_atom", "missing_pairs", "frozen_atoms",
           "pe_temperature_gap")
TINY = dict(reps=(4, 4, 4), warmup_launches=1)


# -- files and names ------------------------------------------------------
def test_files_are_found_by_name_and_agree():
    for c in BENCH["configs"]:
        path = harness.config_path(c["name"])
        assert os.path.relpath(path, ROOT) == c["file"]
        data = harness._json(path)
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
        reference.load(path)
    for w in BENCH["workloads"]:
        data = harness.workload(w["traffic"])
        assert w["traffic"] == w["name"] == data["name"]
        assert data["config"] == w["config"]
        assert data["why"] == w["why"]
        assert set(data["limits"]) == set(NUMBERS)
    for m in BENCH["per_layer"]:
        assert callable(harness.reader(m["name"]))
    names = {"configs": {c["name"] for c in BENCH["configs"]},
             "workloads": {w["traffic"] for w in BENCH["workloads"]},
             "metrics": {m["name"] for m in BENCH["per_layer"]}}
    for folder, expected in names.items():
        found = {os.path.splitext(f)[0] for f in os.listdir(
            os.path.join(harness.HERE, folder))
            if f.endswith((".json", ".py")) and f != "__init__.py"}
        assert found == expected, folder


def test_names_units_and_keys_follow_the_format():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = 24
    assert (2 + 14 * cells) * (BENCH["run_seconds"] + 60) \
        + cells * 2 * 90 + 1200 <= 43200
    seen = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["name"] not in seen
        seen.add(m["name"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in seen
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_each_cell_reports_what_its_metrics_move():
    for cell in CELLS:
        e2e = harness.end_to_end_names(BENCH, cell)
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = harness.per_layer_names(BENCH, cell)
        assert layers
        for name in layers:
            m = next(p for p in BENCH["per_layer"] if p["name"] == name)
            assert m["moves"] in e2e


# -- the frozen arithmetic ------------------------------------------------
def ev(name, device, start, end, annotation=False):
    return yardstick.Event(name, device, annotation, start, end)


def test_busy_union_top_ops_and_gaps():
    events = [ev(yardstick.WINDOW, False, 0.0, 100.0),
              ev("k1", True, 10.0, 20.0), ev("k2", True, 15.0, 30.0),
              ev("k1", True, 50.0, 60.0), ev("k3", True, 95.0, 120.0),
              ev("range", True, 0.0, 100.0, annotation=True),
              ev("aten::topk", False, 30.0, 50.0),
              ev("cudaStreamSynchronize", False, 35.0, 45.0),
              ev("cudaLaunchKernel", False, 8.0, 9.0),
              ev("cudaMemcpyAsync", False, 49.0, 49.5),
              ev("cudaLaunchKernel", False, 101.0, 102.0)]
    lo, hi = yardstick.window_of(events)
    assert yardstick.busy_intervals(events, lo, hi) == [
        (10.0, 30.0), (50.0, 60.0), (95.0, 100.0)]
    assert yardstick.busy_us(events, lo, hi) == 35.0
    assert yardstick.top_ops(events, 2) == [["k3", 25e-6], ["k1", 20e-6]]
    gaps = dict(yardstick.idle_gaps(events, lo, hi))
    # 0-10 and 60-95 have no host event over their middle; 30-50 is the
    # synchronize inside topk
    assert gaps == {"no host event": 45e-6,
                    "cudaStreamSynchronize": 20e-6}
    assert yardstick.launch_calls(events, lo, hi) == 2


def test_useful_flop_is_the_reference_count():
    n = 250_000
    flop = yardstick.useful_flops(torch.full((n,), 14),
                                  torch.full((n,), 65))
    assert flop == n * 91 * 228 + n * 65 * 40 == 5_837_000_000


def test_frozen_trio_bound_matches_the_program_it_was_copied_from():
    from uf3_tpu_torch.data.atoms import Atoms
    from uf3_tpu_torch.forcefield.md import MDSystem
    from uf3_tpu_torch.ops import neighbors as nb
    from uf3_tpu_torch.ops.trio import trio_bound
    numbers, x, cell = harness.lattice(
        dict(structure="bcc", a=3.1652, Z=74, reps=[5, 5, 5]))
    path = harness.config_path("uf3-W-2b3b")
    system = MDSystem(path, Atoms(numbers, x, cell), dtype=torch.float32,
                      device="cpu")
    state = system.init_state(temperature=300.0, seed=3)
    cache = nb.list_cache(state.nbr3, system.cell, torch.float32)
    d = nb.cached_displacements(state.positions, state.nbr3, cache)
    tables = yardstick.TrioTables(harness._json(path))
    for energy in (False, True):
        ms, kind, flop, n_bytes = trio_bound(system.potential, d,
                                             cache.valid, energy)
        got = yardstick.trio_bound(tables, d, cache.valid, energy, block=37)
        assert got["flop"] == pytest.approx(flop, rel=1e-12)
        assert got["bytes"] == n_bytes
        assert got["ms"] == pytest.approx(ms, rel=1e-12)
        assert got["bound_by"] == kind


# -- the check that decides `correct` ---------------------------------------
def tiny_run(cell, hook=None, seed=2 ** 31 + 77, trace=False):
    return harness.run_cell(cell, seed, 0.2, trace, device="cpu",
                            program_hook=hook, **TINY)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_the_control_is_not(cell):
    from mdbench import calibrate
    seed = 2 ** 31 + 5
    out = calibrate.readings(cell, [seed], [seed], 0.2, device="cpu",
                             **TINY)
    assert out["all_program_correct"], out["program"]
    assert out["no_control_correct"], out["control"]
    assert set(out["lower"]) == set(NUMBERS)
    assert out["upper"]["force_max_err_eV_A"] \
        > out["limits"]["force_max_err_eV_A"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", faults.NAMES)
def test_a_broken_program_is_not_correct(cell, fault, monkeypatch):
    hook = faults.hook(fault, monkeypatch, harness.workload(cell))
    try:
        line, judged = tiny_run(cell, hook)
    except RuntimeError as err:
        # atoms that lost their forces ran into a neighbour list's
        # capacity: the program's own check stopped the run, which then
        # prints no result
        assert "capacity" in str(err)
        return
    assert line["correct"] is False
    assert line["failed"] >= 1


# -- what a run loads and opens ----------------------------------------------
PROBE = r"""
import json, os, sys
opened = []
def hook(event, args):
    if event == "open" and isinstance(args[0], (str, bytes)):
        opened.append(os.path.realpath(os.fsdecode(args[0])))
sys.addaudithook(hook)
sys.path.insert(0, {root!r})
from mdbench import harness, run
line, _ = harness.run_cell({cell!r}, 11, 0.2, True, device="cpu",
                           reps=(4, 4, 4), warmup_launches=1)
print(json.dumps(dict(forbidden=run.forbidden_modules(),
                      modules=sorted(sys.modules), opened=opened,
                      metrics=sorted(line["metrics"]))))
"""


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_loads_no_jax_and_reads_no_reference_benchmarks(cell):
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=ROOT, cell=cell)],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    tops = {m.split(".")[0] for m in seen["modules"]}
    assert not tops & {"jax", "jaxlib", "flax", "uf3_tpu"}
    assert seen["forbidden"] == []
    assert "uf3_tpu_torch" in tops
    for folder in ("benchmarks", "benchmarks_data"):
        base = os.path.realpath(os.path.join(ROOT, folder)) + os.sep
        assert not [p for p in seen["opened"] if p.startswith(base)]
    assert "full_builds_per_kstep" in seen["metrics"]


def test_forbidden_names_are_compared_whole():
    from mdbench import run
    assert run.forbidden_modules(
        ["uf3_tpu_torch", "uf3_tpu_torch.ops.trio", "jax.numpy", "jaxlib",
         "uf3_tpu", "uf3_tpu.ops", "flaxen", "flax"]) == [
        "flax", "jax", "jaxlib", "uf3_tpu"]


def test_run_gives_no_result_without_a_card_or_the_program(tmp_path):
    args = ["--workload", CELLS[0], "--seed", str(2 ** 31 + 3),
            "--seconds", "1", "--trace", "0"]
    if not torch.cuda.is_available():
        out = subprocess.run([sys.executable, "mdbench/run.py"] + args,
                             capture_output=True, text=True, cwd=ROOT,
                             timeout=120)
        assert out.returncode == 3 and out.stdout.strip() == ""
    # a folder with only BENCHMARK.json and the benchmark's own files
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "mdbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "mdbench/run.py"] + args,
                         capture_output=True, text=True, cwd=tmp_path,
                         timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


# -- on the card ----------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_card_at_a_small_size(cell, cuda_device):
    line, judged = harness.run_cell(cell, 2 ** 31 + 101, 0.5, True,
                                    device=cuda_device, reps=(12, 12, 12),
                                    warmup_launches=1)
    assert line["correct"], judged
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0
    for name, m in line["metrics"].items():
        assert math.isfinite(m["value"])
        if m["unit"] == "%":
            assert 0.0 <= m["value"] <= 100.0, name
