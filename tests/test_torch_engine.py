"""
The port's MD engine on its own (uf3_tpu_torch/forcefield/md.py): the
trajectory does not depend on how cycles are grouped into launches,
and every option off the benchmark path raises NotImplementedError
naming its ROADMAP.md item.  Parity with the JAX engine is in
tests/test_torch_md.py; this file imports no jax.
"""

import os

import numpy as np
import pytest
import torch

from uf3_tpu_torch.data.atoms import bulk
from uf3_tpu_torch.forcefield.md import MDSystem

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of a thread per core oversubscribes them
torch.set_num_threads(1)

MODEL = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks_data", "model_2and3.json")
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
    geom = _geom()
    for bad in (dict(fused="separate"), dict(trio_triangle=True),
                dict(static_rebuild=True), dict(eager_refilter=False),
                dict(skin_2b=0.5), dict(respa_mid=1), dict(n_respa=1)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            MDSystem(MODEL, geom, dtype=torch.float64, **dict(KW, **bad))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        MDSystem(MODEL, bulk("W", "bcc", a=3.1652) * 4, **KW)
    with pytest.raises(ValueError, match="multiple of respa_mid"):
        MDSystem(MODEL, geom, **dict(KW, respa_mid=4))
    port = MDSystem(MODEL, geom, dtype=torch.float64, **KW)
    st = port.init_state()
    for kwargs in (dict(thermostat="nose_hoover"),
                   dict(on_overflow="regrow"), dict(n_steps=9)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            port.run(st, **dict(dict(n_steps=12, dt_fs=2.0), **kwargs))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        port.npt_run(st, n_steps=12, dt_fs=2.0)
