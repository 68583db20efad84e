"""
The engine's rebuild schedules (uf3_tpu_torch/forcefield/md.py
``_rebuild_switch``) against the JAX engine's, in float64 on the CPU,
from the same numpy inputs:

- ``static_rebuild=True`` (a full rebuild every cycle, no decision)
  follows the adaptive schedule's trajectory on the bench configuration
  (twin of test_static_rebuild_matches_adaptive, 1e-8 A as there);
- ``static_rebuild=True`` and ``eager_refilter=False`` (two-tier skins
  1.2/0.5 A: keep, refilter at 0.4 of the 3-body skin, or a full
  rebuild at half the 2-body skin) against the JAX engine's NVE
  trajectories on 54 atoms of bcc W from 2,500 K velocities, 1e-9,
  with the branch each cycle took counted;
- ``python -m uf3_tpu_torch md ... --static-rebuild --device cpu``.

JAX is run once, in one module fixture.
"""

import functools
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uf3_tpu.data import elements
from uf3_tpu.data.atoms import bulk
from uf3_tpu.forcefield import units
from uf3_tpu.forcefield.md import MDSystem as JaxMDSystem
from uf3_tpu.ops import pallas_trio as pt
from uf3_tpu.ops import potential as jpot
from uf3_tpu.regression import least_squares as ls
from uf3_tpu_torch.__main__ import main
from uf3_tpu_torch.forcefield.md import MDSystem
from uf3_tpu_torch.ops.potential import UF3Potential

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of a thread per core oversubscribes them
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(REPO, "benchmarks_data", "model_2and3.json")
# two-tier skins and a short cycle: at 2,500 K the 54-atom cell takes
# all three branches of the legacy schedule within 60 steps
SMALL = dict(skin=0.5, skin_2b=1.2, rebuild_every=4)
SCHEDULES = {"static_rebuild": dict(static_rebuild=True),
             "legacy_refilter": dict(eager_refilter=False)}
N_STEPS, DT_FS = 60, 2.0

@functools.lru_cache(maxsize=None)
def port_model() -> UF3Potential:
    """The port's potential of MODEL through the weights converter from
    the JAX package's own pair and trio bundles, so that both engines run
    the same leg specs (``UF3Potential.from_json`` evaluates the file's
    own knots, where the JAX package rebuilds them from the first knot
    gap: ROADMAP.md section 3; tests/test_torch_fit.py holds it to the
    host oracle)."""
    model = ls.WeightedLinearModel.from_json(MODEL)
    params, _ = jpot.build_potential(model, dtype=jnp.float64)
    trio = pt.build_trio_pallas(model, dtype=jnp.float64)
    spec, coefficients = pt.build_pair_fast(model, dtype=jnp.float64)
    return UF3Potential.from_jax_arrays(
        trio._replace(grid=np.asarray(trio.grid)),
        (spec, np.asarray(coefficients)), np.asarray(params.offsets_1b),
        np.asarray(params.z_to_species), float(params.r_cut_2b),
        float(params.r_cut_3b))



def _velocities(geom, temperature, seed=0):
    masses = elements.atomic_masses[geom.get_atomic_numbers()][:, None]
    v = np.random.RandomState(seed).normal(
        0.0, 1.0, (len(geom), 3)) * np.sqrt(units.kB * temperature / masses)
    return v - v.mean(axis=0)


@pytest.fixture(scope="module")
def ref():
    """The JAX engine's NVE runs under each schedule, as numpy."""
    model = ls.WeightedLinearModel.from_json(MODEL)
    geom = bulk("W", "bcc", a=3.1652) * 3
    v0 = _velocities(geom, 2500.0)
    out = dict(geom=geom, v0=v0)
    for name, kw in SCHEDULES.items():
        system = JaxMDSystem(model, geom, dtype=jnp.float64, **SMALL, **kw)
        st = system.run(system.init_state(velocities=v0), n_steps=N_STEPS,
                        dt_fs=DT_FS)
        out[name] = dict(positions=np.array(st.positions),
                         velocities=np.array(st.velocities),
                         forces=np.array(st.forces),
                         energy=float(st.energy), stale=bool(st.stale))
    return out


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_jax(ref, name):
    """60 NVE steps of 2 fs in 15 cycles of 4: positions (modulo the
    lattice: the static schedule wraps every cycle), velocities, forces
    and energy within 1e-9 of the JAX engine's under the same schedule.
    The static schedule rebuilds in full every cycle; the legacy one
    keeps, refilters and rebuilds."""
    port = MDSystem(port_model(), ref["geom"], dtype=torch.float64, device="cpu",
                    **SMALL, **SCHEDULES[name])
    assert port.two_tier
    st = port.run(port.init_state(velocities=ref["v0"]), n_steps=N_STEPS,
                  dt_fs=DT_FS)
    want, cell = ref[name], ref["geom"].cell
    frac = (want["positions"] - st.positions.numpy()) @ np.linalg.inv(cell)
    assert np.abs((frac - np.round(frac)) @ cell).max() < 1e-9
    assert np.abs(want["velocities"] - st.velocities.numpy()).max() < 1e-9
    assert np.abs(want["forces"] - st.forces.numpy()).max() < 1e-9
    assert abs(want["energy"] - float(st.energy)) < 1e-9
    assert bool(st.stale) == want["stale"]
    assert not port.overflowed(st)
    branches = port.rebuild_branches
    assert sum(branches.values()) == N_STEPS // SMALL["rebuild_every"]
    if name == "static_rebuild":
        assert branches["full"] == 15
    else:
        assert min(branches.values()) > 0, branches


def test_static_rebuild_matches_adaptive():
    """Twin of test_static_rebuild_matches_adaptive: on the bench
    configuration (3-level r-RESPA 6/3/12, skins 1.2/0.5 A, 72/16 slots,
    1,024 atoms) a full rebuild every cycle follows the adaptive
    schedule's trajectory: positions modulo the lattice within 1e-8 A;
    the adaptive run refilters and the static one rebuilds every
    cycle."""
    geom = bulk("W", "bcc", a=3.1652) * (8, 8, 8)
    kw = dict(dtype=torch.float64, device="cpu", rebuild_every=12, skin=0.5,
              skin_2b=1.2, capacity_2b=72, capacity_3b=16, n_respa=6,
              respa_mid=3, respa_switch=(2.5, 3.5))
    v0 = _velocities(geom, 300.0, seed=3)
    runs = []
    for static in (False, True):
        port = MDSystem(MODEL, geom, static_rebuild=static, **kw)
        st = port.run(port.init_state(velocities=v0), n_steps=36,
                      dt_fs=2.0)
        assert not port.overflowed(st)
        runs.append((port, st))
    (sys_a, st_a), (sys_s, st_s) = runs
    d = (st_a.positions - st_s.positions).numpy() @ np.linalg.inv(geom.cell)
    d -= np.round(d)
    assert np.abs(d @ geom.cell).max() < 1e-8
    assert sys_s.rebuild_branches == dict(keep=0, refilter=0, full=3)
    assert sys_a.rebuild_branches["refilter"] > 0


def test_md_command_static_rebuild(capsys):
    """``python -m uf3_tpu_torch md benchmarks_data/model_2and3.json
    --static-rebuild --device cpu`` (the flag also spelled
    ``--static_rebuild``) on a small cell exits with its result line."""
    main(["md", MODEL, "--reps", "3", "--steps", "24", "--static_rebuild",
          "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == "54 atoms of W"
    found = re.fullmatch(r"24 steps in \S+ s \((\S+) atom-steps/s\); "
                         r"T = (\S+) K, E = (\S+) eV", out[-1])
    assert found is not None, out[-1]
    assert all(np.isfinite(float(x)) for x in found.groups())
