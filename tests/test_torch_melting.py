"""
The port's melting-point example (``uf3_tpu_torch/examples/
melting_point.py``) against the JAX package's protocol
(``benchmarks/melting_run.py``):

- the twin of ``tests/test_melting_order.py``: the order profile
  separates a rattled bcc solid from a uniform liquid and is invariant
  under isotropic rescaling;
- ``order_profile`` and ``solid_fraction`` equal the reference's (1e-12)
  on lattice, rattled, liquid-like and NPT-scaled cells, ``reps`` given
  and derived;
- ``run_trial`` runs on the CPU at a tiny box (reps (4, 2, 2), float64,
  the preparation cut to 1%, 32 release steps) and writes every key the
  reference's log has; half the box pinned; the melt at max(1.5 T,
  8,000 K).  At 4 atoms a bin the liquid's profile sits at its noise
  floor ~0.5, above the 0.25 threshold, so the start band is opened to
  [0, 1] there to reach the release stage.
"""

import os
import re
import sys

import numpy as np
import pytest
import torch

from uf3_tpu_torch.examples import melting_point as mp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "benchmarks"))

import melting_run as ref  # noqa: E402

torch.set_num_threads(1)


def _half_solid(reps=(12, 6, 6), seed=0, rattle=0.08):
    rng = np.random.RandomState(seed)
    cell = np.diag([reps[i] * mp.A0 for i in range(3)])
    basis = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]])
    pts = [(np.array([i, j, k]) + b) * mp.A0
           for i in range(reps[0] // 2) for j in range(reps[1])
           for k in range(reps[2]) for b in basis]
    solid = np.array(pts) + rng.normal(scale=rattle, size=(len(pts), 3))
    liquid = rng.uniform(size=(len(pts), 3)) @ np.diag(
        [cell[0, 0] / 2, cell[1, 1], cell[2, 2]])
    liquid[:, 0] += cell[0, 0] / 2
    return np.vstack([solid, liquid]), cell


def test_order_profile_separates_phases():
    """The twin of ``tests/test_melting_order.py:18``."""
    pos, cell = _half_solid()
    prof = mp.order_profile(pos, cell, n_bins=24)
    left, right = prof[:12], prof[12:]
    assert left.min() > 0.6
    assert right.mean() < 0.18
    assert 0.35 <= mp.solid_fraction(prof) <= 0.65
    prof2 = mp.order_profile(pos * 1.03, cell * 1.03, n_bins=24)
    assert np.allclose(prof2, prof, atol=1e-12)


def _cells():
    reps = (8, 4, 4)
    lattice = mp.bulk("W", "bcc", a=mp.A0) * reps
    rattled = lattice.copy()
    rattled.rattle(0.1, seed=3)
    rng = np.random.RandomState(5)
    liquid = rng.uniform(size=(len(lattice), 3)) @ lattice.cell
    half, half_cell = _half_solid(reps=(8, 4, 4), seed=7)
    return reps, {
        "lattice": (lattice.positions, lattice.cell),
        "rattled": (rattled.positions, rattled.cell),
        "liquid": (liquid, lattice.cell),
        "half solid": (half, half_cell),
        # the barostat's isotropic growth past half a cell at 8 reps
        "NPT-scaled": (rattled.positions * 1.07, rattled.cell * 1.07),
        "shifted": (rattled.positions - 0.3 * mp.A0, rattled.cell),
    }


@pytest.mark.parametrize("name", ["lattice", "rattled", "liquid",
                                  "half solid", "NPT-scaled", "shifted"])
def test_order_profile_matches_reference(name):
    reps, cells = _cells()
    pos, cell = cells[name]
    for n_bins in (16, 7):
        for given in (reps, None):
            ours = mp.order_profile(pos, cell, n_bins, reps=given)
            theirs = ref.order_profile(pos, cell, n_bins, reps=given)
            assert np.allclose(ours, theirs, rtol=0, atol=1e-12)
            for threshold in (0.25, 0.5):
                assert mp.solid_fraction(ours, threshold) \
                    == ref.solid_fraction(theirs, threshold)
    assert mp.A0 == ref.A0


def _reference_log_keys():
    with open(os.path.join(REPO, "benchmarks", "melting_run.py")) as f:
        source = f.read()
    body = source[source.index("def run_trial"):source.index("def main")]
    keys = set(re.findall(r'log\["(\w+)"\]', body))
    keys |= set(re.findall(r'log = \{"(\w+)": \w+, "(\w+)"',
                           body)[0])
    return keys


def test_run_trial_on_the_cpu(monkeypatch):
    monkeypatch.setattr(mp, "START_BAND", (0.0, 1.0))
    trial_t, reps = 3000.0, (4, 2, 2)
    log = mp.run_trial(mp.MODEL, trial_t, reps, 32, seed=0, prep_scale=0.01,
                       dtype=torch.float64, device="cpu", verbose=False)
    keys = _reference_log_keys()
    assert {"T", "n_atoms", "melt_t", "profile_hot", "verdict",
            "solid_fraction_series", "obs_atom_steps_per_s"} <= keys
    assert keys <= set(log), keys - set(log)
    n = 2 * np.prod(reps)
    assert log["n_atoms"] == n and log["T"] == trial_t
    # half the box, give or take one plane of atoms at each boundary
    assert abs(log["n_pinned"] - n / 2) <= 2 * n / (2 * reps[0])
    assert log["melt_t"] == max(1.5 * trial_t, 8000.0)
    assert log["verdict"] in ("grew", "shrank", "flat")
    assert log["obs_steps"] == log["obs_steps_run"] == 32
    assert len(log["solid_fraction_series"]) == 2
    assert len(log["profile_hot"]) == len(log["profile_after_melt"]) \
        == 2 * reps[0]
    assert log["obs_atom_steps_per_s"] > 0
    assert np.isfinite(log["cell_x_after_equil"]) \
        and np.isfinite(log["t_mobile_hot"])


def test_main_prints_the_log(capsys, monkeypatch):
    monkeypatch.setattr(mp, "run_trial", lambda *a, **k: dict(
        T=a[1], n_atoms=16, verdict="prep_failed", device=k["device"]))
    log = mp.main(["4000", "64", "--reps", "4", "2", "2", "--cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert log["device"] == "cpu" and log["T"] == 4000.0
    assert out[0] == "T = 4000 K, 16 atoms: verdict = prep_failed"
    assert out[-1].startswith("{") and '"verdict": "prep_failed"' in out[-1]
