"""
The port's default MD path against the JAX engine, in float64 on the
CPU, from the same numpy inputs: the O(N^2) minimum-image, explicit-
image and non-periodic neighbor builders (neighbor SETS per row plus
the overflow flag: torch.topk and lax.top_k order equal distances
differently), ``trio_short_forces``, the 2-level r-RESPA force split,
and NVE trajectories of plain velocity Verlet, 2-level and 3-level
r-RESPA with one-tier skins, and a run whose last steps are plain
Verlet (within 1e-8 A and 1e-8 eV).

Cells: 54 atoms (bcc W 3^3, periodic, narrower than twice the cutoff:
the images builder), 128 atoms (4^3: the minimum-image builder) and a
250-atom cluster (5^3 with pbc off).  Three JAX systems, built once per
module, hold every JAX result the tests read.
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uf3_tpu.data.atoms import bulk
from uf3_tpu.forcefield import units
from uf3_tpu.forcefield.md import MDSystem as JaxMDSystem
from uf3_tpu.ops import neighbors as jnb
from uf3_tpu.ops import pallas_trio as pt
from uf3_tpu.ops import potential as jpot
from uf3_tpu.regression import least_squares as ls
from uf3_tpu_torch.forcefield.md import MDSystem
from uf3_tpu_torch.ops import neighbors as tnb
from uf3_tpu_torch.ops.pair import pair_tail_forces
from uf3_tpu_torch.ops.trio import trio_short_forces
from uf3_tpu_torch.ops.potential import UF3Potential

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of a thread per core oversubscribes them
torch.set_num_threads(1)

MODEL = os.path.join("benchmarks_data", "model_2and3.json")
R2, R3 = 5.5 + 0.5, 3.5 + 0.5  # cutoffs + the default one-tier skin
RESPA2 = dict(n_respa=3, rebuild_every=6)
RESPA3 = dict(n_respa=4, respa_mid=2, rebuild_every=8, capacity_2b=64,
              capacity_3b=20)
POS_TOL = ENERGY_TOL = 1e-8

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



def _geom(reps, rattle=0.05, seed=3, pbc=True):
    geom = bulk("W", "bcc", a=3.1652) * reps
    if rattle:
        geom.rattle(rattle, seed=seed)
    geom.pbc = np.array([pbc] * 3)
    return geom


def _velocities(n_atoms, temperature=1000.0, seed=0):
    rng = np.random.RandomState(seed)
    v = rng.normal(0.0, np.sqrt(units.kB * temperature / 183.84),
                   (n_atoms, 3))
    return v - v.mean(axis=0)


def _snap(state):
    """The numbers of a state the tests compare, as numpy."""
    return dict(positions=np.array(state.positions),
                velocities=np.array(state.velocities),
                forces=np.array(state.forces), energy=float(state.energy),
                stale=bool(state.stale))


def _same_trajectory(ref, state, geom):
    """Positions within POS_TOL modulo lattice translations (the
    engines wrap at their own rebuilds), velocities, forces, energy and
    the staleness flag."""
    d = ref["positions"] - state.positions.numpy()
    if np.any(geom.pbc):
        frac = d @ np.linalg.inv(geom.cell)
        d = (frac - np.round(frac)) @ geom.cell
    assert np.abs(d).max() < POS_TOL
    assert np.abs(ref["velocities"] - state.velocities.numpy()).max() \
        < POS_TOL
    assert np.abs(ref["forces"] - state.forces.numpy()).max() < 1e-8
    assert abs(ref["energy"] - float(state.energy)) < ENERGY_TOL
    assert ref["stale"] == bool(state.stale)


class _Counted:
    """Counts the port system's full list builds."""

    def __init__(self, system):
        self.builds = 0
        build = system.build_lists

        def counted(*args, **kwargs):
            self.builds += 1
            return build(*args, **kwargs)
        system.build_lists = counted


@pytest.fixture(scope="module")
def model():
    return ls.WeightedLinearModel.from_json(MODEL)


def _entry(system, state, geom, **extra):
    """A JAX system's entry state as numpy, with its lists."""
    return dict(geom=geom, positions=np.array(state.positions),
                nbr2=state.nbr2, nbr3=state.nbr3,
                images=system._images_2b,
                capacities=(system.capacity_2b, system.capacity_3b),
                **extra)


@pytest.fixture(scope="module")
def plain(model):
    """Plain velocity Verlet, every engine argument at its default, on
    the perfect 128-atom lattice (full of equal distances): 24 steps =
    launches of 20 and 4 steps."""
    geom = _geom(4, rattle=0.0)
    system = JaxMDSystem(model, geom, dtype=jnp.float64)
    v0 = _velocities(len(geom))
    st0 = system.init_state(velocities=v0)
    run = system.run(st0, n_steps=24, dt_fs=2.0)
    return _entry(system, st0, geom, v0=v0, run24=_snap(run))


@pytest.fixture(scope="module")
def respa2(model):
    """2-level r-RESPA at n_respa=3 on the rattled 54-atom cell:
    trio_short_forces on the entry lists, 36 steps, and 26 steps (four
    outer launches, then 2 plain Verlet steps) followed by 6 more."""
    geom = _geom(3)
    system = JaxMDSystem(model, geom, dtype=jnp.float64, **RESPA2)
    v0 = _velocities(len(geom), seed=1)
    st0 = system.init_state(velocities=v0)
    spec_pair, pair_coeff = system.pair_fast
    tb = system.trio_bundle
    r_lo, r_hi = system.respa_switch
    short = pt.trio_short_forces(
        pair_coeff, tb.grid, st0.positions, system.cell, st0.nbr3,
        spec_pair=spec_pair, n_basis_pair=system.n_basis_short,
        spec_l=tb.spec_l, spec_n=tb.spec_n, l_basis=tb.l_basis,
        n_basis=tb.n_basis, active_bc=tb.active_bc, window=tb.window,
        r_lo=r_lo, r_hi=r_hi)
    st26 = system.run(st0, n_steps=26, dt_fs=2.0)
    return _entry(system, st0, geom, v0=v0,
                  short=[np.array(x) for x in short],
                  run36=_snap(system.run(st0, n_steps=36, dt_fs=2.0)),
                  run26=_snap(st26),
                  run26_6=_snap(system.run(st26, n_steps=6, dt_fs=2.0)))


@pytest.fixture(scope="module")
def respa3(model):
    """3-level r-RESPA 4/2 with one-tier skins on the rattled 250-atom
    cluster: 24 steps in one launch of three rebuild cycles."""
    geom = _geom(5, rattle=0.1, seed=5, pbc=False)
    system = JaxMDSystem(model, geom, dtype=jnp.float64, **RESPA3)
    v0 = _velocities(len(geom), seed=2)
    st0 = system.init_state(velocities=v0)
    run = system.run(st0, n_steps=24, dt_fs=2.0, launch_chunks=3)
    return _entry(system, st0, geom, v0=v0, run24=_snap(run))


# -- neighbor builders ------------------------------------------------------
def _rows(idx, shift, mask):
    """Per-row sorted keys of the (atom, image shift) set; -1 pads."""
    idx, shift, mask = (np.asarray(idx), np.asarray(shift),
                        np.asarray(mask))
    code = ((shift + 2) @ np.array([25, 5, 1])).astype(np.int64)
    key = np.where(mask, idx.astype(np.int64) * 125 + code, -1)
    return np.sort(key, axis=1)


def _same_sets(nj, nt):
    a = _rows(nj.idx, nj.shift, nj.mask)
    b = _rows(nt.idx, nt.shift, nt.mask)
    return a.shape == b.shape and np.array_equal(a, b)


# fixture -> (engine keywords, the builder the cell takes)
ENGINES = {"plain": ({}, "min_image"), "respa2": (RESPA2, "images"),
           "respa3": (RESPA3, "min_image")}


@pytest.mark.parametrize("name", list(ENGINES))
def test_engine_lists_match_jax(name, request):
    """Each engine's entry lists from the same positions: the images
    builder on the 54-atom cell, the minimum-image builder on the
    perfect 128-atom lattice, the minimum-image builder without images
    on the cluster; then the filtered 3-body list.  The default
    one-tier capacities are 78 pair and 23 3-body slots for bcc W (the
    KMAX = 32 instance of the trio kernel)."""
    fx = request.getfixturevalue(name)
    kw, builder = ENGINES[name]
    geom = fx["geom"]
    port = MDSystem(MODEL, geom, dtype=torch.float64, device="cpu", **kw)
    assert (port.capacity_2b, port.capacity_3b) == fx["capacities"]
    assert port._images_2b == fx["images"]
    assert port._cells_2b is None and not port.two_tier
    assert (port._images_2b is not None) == (builder == "images")
    if name == "plain":
        assert fx["capacities"] == (78, 23)
    x = torch.tensor(fx["positions"])
    nbr2, nbr3 = port.build_lists(x)
    for nj, nt in ((fx["nbr2"], nbr2), (fx["nbr3"], nbr3)):
        assert _same_sets(nj, nt)
        assert bool(nj.overflow) is bool(nt.overflow) is False
    assert int(nbr3.mask.sum(1).min()) >= (14 if any(geom.pbc) else 3)
    if not any(geom.pbc):  # a cluster is never wrapped
        assert torch.equal(port._wrap(x + 50.0, port.cell), x + 50.0)


def test_low_capacity_images_builder_matches_jax():
    """A capacity below the ~58 neighbors within 6 A: both builders
    keep the nearest 40 and flag the overflow, and the filter passes
    the flag on."""
    geom = _geom(3)
    pos, cell = np.asarray(geom.positions), np.asarray(geom.cell)
    pbc = (True, True, True)
    images = tnb.images_required(cell, pbc, R2)
    assert images == jnb.images_required(cell, pbc, R2) == (1, 1, 1)
    assert tnb.images_required(cell * 2.0, pbc, R2) == (0, 0, 0)
    nj = jnb.build_neighbor_list_images(
        jnp.asarray(pos), jnp.asarray(cell), pbc, R2, 40, images=images,
        with_rev=False)
    nt = tnb.build_neighbor_list_images(
        torch.tensor(pos), torch.tensor(cell), pbc, R2, 40, images=images)
    assert _same_sets(nj, nt)
    assert bool(nj.overflow) is bool(nt.overflow) is True
    assert bool(torch.all(nt.mask))
    ft = tnb.filter_neighbor_list(nt, torch.tensor(pos), torch.tensor(cell),
                                  R3, 23)
    assert bool(ft.overflow)


# -- forces -----------------------------------------------------------------
def _port_list(nbr):
    """A JAX NeighborList as the port's, on the CPU."""
    return tnb.NeighborList(
        idx=torch.tensor(np.asarray(nbr.idx), dtype=torch.int64),
        shift=torch.tensor(np.asarray(nbr.shift)),
        mask=torch.tensor(np.asarray(nbr.mask)),
        rev=torch.tensor(np.asarray(nbr.rev), dtype=torch.int64),
        overflow=torch.tensor(bool(nbr.overflow)),
        reference_positions=torch.tensor(
            np.asarray(nbr.reference_positions)),
        sel=torch.tensor(np.asarray(nbr.sel), dtype=torch.int64))


def test_trio_short_forces_match_jax(respa2):
    port = MDSystem(port_model(), respa2["geom"], dtype=torch.float64,
                    device="cpu", **RESPA2)
    r_lo, r_hi = port.respa_switch
    out = trio_short_forces(port.potential,
                            torch.tensor(respa2["positions"]), port.cell,
                            _port_list(respa2["nbr3"]), port.n_basis_short,
                            r_lo=r_lo, r_hi=r_hi)
    e2, e3, forces = (x.numpy() for x in out)
    e2_j, e3_j, forces_j = respa2["short"]
    assert abs(float(e2) - float(e2_j)) < 1e-10
    assert np.abs(e3 - e3_j).max() < 1e-10
    assert np.abs(forces - forces_j).max() < 1e-10
    assert np.abs(forces_j).max() > 1e-1


def test_respa2_force_split_exact(respa2):
    """S(r) + (1 - S(r)) = 1: the 2-level split reconstructs the full
    force and energy (twin of test_respa_force_split_exact)."""
    port = MDSystem(MODEL, respa2["geom"], dtype=torch.float64,
                    device="cpu", **RESPA2)
    state = port.init_state()
    f_short, f_tail = port._respa_split_forces(state)
    assert torch.max(torch.abs(f_short + f_tail - state.forces)) < 1e-9
    r_lo, r_hi = port.respa_switch
    e_s, e3, _ = trio_short_forces(port.potential, state.positions,
                                   state.cell, state.nbr3,
                                   port.n_basis_short, r_lo=r_lo, r_hi=r_hi)
    spec = port.potential.pair_spec
    e_t, _ = pair_tail_forces(port.potential.pair_coefficients,
                              state.positions, state.cell, state.nbr2,
                              spec_pair=spec, n_basis_pair=spec.n_basis,
                              r_lo=r_lo, r_hi=r_hi)
    e_split = float(port._e1() + e_s + e_t + torch.sum(e3))
    assert abs(e_split - float(state.energy)) < 1e-9


# -- trajectories -----------------------------------------------------------
def test_plain_verlet_defaults_match_jax(plain):
    geom = plain["geom"]
    port = MDSystem(port_model(), geom, dtype=torch.float64, device="cpu")
    builds = _Counted(port)
    st = port.run(port.init_state(velocities=plain["v0"]), n_steps=24,
                  dt_fs=2.0)
    _same_trajectory(plain["run24"], st, geom)
    assert builds.builds == 2  # init, and a full rebuild after 20 steps
    assert st.f_short is None and not port.overflowed(st)


def test_respa2_matches_jax(respa2):
    geom = respa2["geom"]
    port = MDSystem(port_model(), geom, dtype=torch.float64, device="cpu",
                    **RESPA2)
    builds = _Counted(port)
    st = port.run(port.init_state(velocities=respa2["v0"]), n_steps=36,
                  dt_fs=2.0)
    _same_trajectory(respa2["run36"], st, geom)
    assert builds.builds > 1
    assert st.f_short is not None and st.f_mid is None


def test_leftover_plain_steps_and_carried_forces_match_jax(respa2):
    """26 steps at n_respa=3 run 24 as r-RESPA and 2 as plain Verlet,
    whose state carries no split forces: the next r-RESPA launch
    recomputes them at the current positions."""
    geom = respa2["geom"]
    port = MDSystem(port_model(), geom, dtype=torch.float64, device="cpu",
                    **RESPA2)
    done = []
    st = port.run(port.init_state(velocities=respa2["v0"]), n_steps=26,
                  dt_fs=2.0, callback=lambda s, n: done.append(n))
    assert done == [6, 12, 18, 24, 26]
    _same_trajectory(respa2["run26"], st, geom)
    assert st.f_short is None and st.f_tail is None
    st = port.run(st, n_steps=6, dt_fs=2.0)
    _same_trajectory(respa2["run26_6"], st, geom)


def test_respa3_one_tier_cluster_matches_jax(respa3):
    geom = respa3["geom"]
    port = MDSystem(port_model(), geom, dtype=torch.float64, device="cpu",
                    **RESPA3)
    st = port.run(port.init_state(velocities=respa3["v0"]), n_steps=24,
                  dt_fs=2.0)
    _same_trajectory(respa3["run24"], st, geom)
    assert st.f_mid is not None


def test_langevin_launch_chunks_exact_plain():
    """Plain Verlet under Langevin: launch_chunks only groups cycles
    per overflow check, and a cycle that computes no energy keeps the
    energy it started with (twin of test_launch_chunks_exact_nonrespa)."""
    geom = _geom(3)
    runs = []
    for chunks in (1, 4):
        port = MDSystem(MODEL, geom, dtype=torch.float64, device="cpu",
                        rebuild_every=6)
        st = port.init_state(temperature=500.0, seed=7)
        runs.append(port.run(st, n_steps=24, dt_fs=1.0,
                             thermostat="langevin", temperature=500.0,
                             launch_chunks=chunks))
    a, b = runs
    assert torch.equal(a.positions, b.positions)
    assert torch.equal(a.velocities, b.velocities)
    assert float(a.energy) == float(b.energy)
    fresh, _, _ = port.energy_forces(b.positions, b.nbr2, b.nbr3)
    assert abs(float(fresh) - float(b.energy)) < 1e-10
    kept = port._verlet_cycle(b, 3, 1.0, None, 500.0, 2.0,
                              compute_energy=False)
    assert float(kept.energy) == float(b.energy)
    assert not torch.equal(kept.positions, b.positions)
