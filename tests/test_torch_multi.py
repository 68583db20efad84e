"""
The port's fused multi-species route (uf3_tpu_torch/ops/multi.py and
its use in MDSystem) against the JAX package's, in float64 on the CPU,
from the same numpy inputs, on the random Ne/Xe 2+3-body model (r 1-5
A, resolution 8, coefficients from RandomState(11) at scale 0.05: the
model of the JAX package's test_multi_fused_matches_factorized) on fcc
3^3 (108 atoms, a = 5.4 A, half Xe by a seeded draw, rattled 0.08 A):

- ``build_trio_multi`` and ``build_pair_multi`` against JAX's: the
  ordered types, their specs, windows, live blocks and grids, the pair
  specs, coefficients and pair-type table (1e-14);
- ``pair_forces_multi`` and ``trio_forces_multi`` (on the CPU the plain
  version of the multi-species trio pass: the species-gated pass of
  each of the 8 ordered types, summed, with the virial from the summed
  partials) against JAX's on the JAX lists (1e-10), each ordered type
  with s_m != s_n included;
- ``MDSystem.energy_forces`` on the fused route against JAX's (its
  1-body, pair and trio terms as the JAX engine sums them) and against
  the port's factorized path (1e-9), the potential built by
  ``from_model`` and by ``from_jax_multi``;
- 20 NVE steps and SCR NPT at T = 0 (the virial every step) against
  the JAX engine's trajectories (1e-9);
- r-RESPA on a multi-species model raises: the reference has no such
  path.

JAX is run once, in one module fixture.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uf3_tpu.data import elements
from uf3_tpu.forcefield import units
from uf3_tpu.forcefield.md import MDSystem as JaxMDSystem
from uf3_tpu.ops import pallas_trio as pt
from uf3_tpu.ops import spline_jax as sj
from uf3_tpu_torch.forcefield.md import MDSystem
from uf3_tpu_torch.ops import multi
from uf3_tpu_torch.ops import neighbors as tnb
from uf3_tpu_torch.ops.potential import UF3Potential

from test_torch_factorized import (_binary_geom, port_list,
                                   random_binary_model)

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of a thread per core oversubscribes them
torch.set_num_threads(1)

TOL = 1e-10
NPT = dict(n_steps=12, dt_fs=1.0, temperature=0.0, pressure=0.01,
           tau_p_fs=40.0, compressibility=0.5)


def _velocities(geom, temperature, seed=0):
    masses = elements.atomic_masses[geom.get_atomic_numbers()][:, None]
    v = np.random.RandomState(seed).normal(
        0.0, 1.0, (len(geom), 3)) * np.sqrt(units.kB * temperature / masses)
    return v - v.mean(axis=0)


def _snap(state):
    return dict(positions=np.array(state.positions),
                velocities=np.array(state.velocities),
                forces=np.array(state.forces), energy=float(state.energy),
                cell=np.array(state.cell))


def _np(out):
    return tuple(np.asarray(x) for x in out)


@pytest.fixture(scope="module")
def ref():
    """Every JAX result the tests read, as numpy."""
    jax_model, _ = random_binary_model()
    geom = _binary_geom(3, 5.4, 11)
    system = JaxMDSystem(jax_model, geom, dtype=jnp.float64,
                         rebuild_every=5)
    v0 = _velocities(geom, 10.0)
    state = system.init_state(velocities=v0)
    pos, cell, species = state.positions, system.cell, system.species
    nbr2, nbr3 = state.nbr2, state.nbr3
    specs, coeffs, ptable, _ = system.pair_multi
    cache2 = pt.build_pair_cache(nbr2.idx, nbr2.shift, nbr2.mask, cell,
                                 jnp.float64, species=species,
                                 pair_type=ptable)
    tm = system.trio_multi
    out = dict(
        geom=geom, v0=v0, system=system, pos=np.asarray(pos),
        nbr2=port_list(nbr2), nbr3=port_list(nbr3),
        trio_multi=tm, pair_multi=system.pair_multi,
        pair=_np(pt.pair_forces_multi(
            coeffs, pos, cell, nbr2.idx, nbr2.shift, nbr2.mask, specs=specs,
            with_virial=True, cache=cache2)),
        trio=_np(pt.trio_forces_multi(
            tm.grids, species, pos, cell, nbr3.idx, nbr3.shift, nbr3.mask,
            nbr3.rev, descs=tm.descs, with_virial=True)),
        offsets_1b=np.asarray(system.params.offsets_1b),
        z_to_species=np.asarray(system.params.z_to_species),
        r_cuts=(float(system.params.r_cut_2b),
                float(system.params.r_cut_3b)))
    # the JAX engine's energy_forces on this route, from its two passes
    # (as it composes them) without a third compile
    (e2, f2, v2), (e3, f3, v3) = out["pair"], out["trio"]
    v6 = v2 + v3
    out["total"] = (
        float(np.sum(out["offsets_1b"][np.asarray(species)]) + e2
              + np.sum(e3)), f2 + f3,
        np.array([[v6[0], v6[5], v6[4]], [v6[5], v6[1], v6[3]],
                  [v6[4], v6[3], v6[2]]]))
    out["nve"] = _snap(system.run(state, n_steps=20, dt_fs=1.0))
    npt_system = JaxMDSystem(jax_model, geom, dtype=jnp.float64,
                             rebuild_every=6)
    st, cells = npt_system.npt_run(npt_system.init_state(velocities=v0),
                                   **NPT)
    out["npt"] = _snap(st)
    out["npt_cells"] = [np.array(c) for c in cells]
    return out


def _from_jax(r) -> UF3Potential:
    tm, pm = r["trio_multi"], r["pair_multi"]
    return UF3Potential.from_jax_multi(
        tm.descs, [np.asarray(g) for g in tm.grids],
        (pm[0], [np.asarray(c) for c in pm[1]], np.asarray(pm[2])),
        r["offsets_1b"], r["z_to_species"], *r["r_cuts"])


def _fields(spec):
    return tuple(getattr(spec, f) for f in spec._fields)


def _same_spec(a, b):
    """The port's leg spec ``a`` against the JAX package's ``b``: the
    port's carries the file's knots, which its kernels' tables and plain
    versions evaluate on (ROADMAP.md section 3); the JAX package's none."""
    assert b.knots is None and len(a.knots) == a.n_int + 1
    assert abs(a.knots[0] - a.t_min) < 1e-14 \
        and abs(a.knots[-1] - a.t_max) < 1e-14
    a = a._replace(knots=None)
    for x, y in zip(_fields(a), _fields(b)):
        if isinstance(x, float):
            assert abs(x - y) < 1e-14
        else:
            assert x == y


def test_builders_match_jax(ref):
    """The ordered types (both leg orders of each (c, m, n) with
    m != n), specs, windows, live blocks and grids, and the pair specs,
    cardinal coefficients and pair-type table, from the port's own
    basis, against JAX's build_trio_multi / build_pair_multi."""
    _, model = random_binary_model()
    config = model.bspline_config
    tm = multi.build_trio_multi(config, model.coefficients)
    pm = multi.build_pair_multi(config, model.coefficients)
    jt, jp = ref["trio_multi"], ref["pair_multi"]
    assert len(tm.descs) == len(jt.descs) == 8
    assert sum(d.s_m != d.s_n for d in tm.descs) == 4
    for ours, theirs, g_ours, g_theirs in zip(tm.descs, jt.descs, tm.grids,
                                              jt.grids):
        for leg in ("spec_l1", "spec_l2", "spec_n"):
            _same_spec(getattr(ours, leg), getattr(theirs, leg))
        assert (ours.s_c, ours.s_m, ours.s_n) == (theirs.s_c, theirs.s_m,
                                                  theirs.s_n)
        assert ours.window == tuple(theirs.window)
        assert ours.active_bc == tuple(theirs.active_bc)
        assert np.abs(g_ours - np.asarray(g_theirs)).max() < 1e-14
    assert multi.mirrored(tm.descs, tm.grids)
    for ours, theirs in zip(pm.specs, jp[0]):
        _same_spec(ours, theirs)
    assert len(pm.coefficients) == len(jp[1]) == 3
    sizes, offsets = config.get_interaction_partitions()
    for ours, pair in zip(pm.coefficients, config.interactions_map[2]):
        # the file's own coefficients between the three at each end,
        # which are matched on their end interval alone, making the
        # file's spline piece by piece to 1e-14 of its largest term (the
        # JAX package's forward recursion carries its rounding along the
        # leg: 6e-14 of the coefficients here)
        clamped = model.coefficients[offsets[pair]:offsets[pair]
                                     + sizes[pair]]
        assert np.array_equal(ours[3:-3], clamped[3:-3])
        beta = sj.basis_monomial_table(config.knots_map[pair])
        poly = np.stack([clamped[i:i + 4] @ beta[i]
                         for i in range(len(beta))])
        recon = np.stack([ours[i:i + 4] @ pt.CARDINAL_M
                          for i in range(len(beta))])
        assert np.abs(recon - poly).max() <= 1e-14 * np.abs(poly).max()
    assert np.array_equal(pm.pair_type, np.asarray(jp[2]))
    # a degree-2 model has no multi-species trio
    assert multi.build_trio_multi(_degree2_config(), np.zeros(0)) is None


def _degree2_config():
    from uf3_tpu_torch.data.composition import ChemicalSystem
    from uf3_tpu_torch.representation.basis import BSplineBasis
    return BSplineBasis(ChemicalSystem(["Ne", "Xe"], degree=2),
                        r_min_map=1.0, r_max_map=5.0, resolution_map=8)


def _port_system(r, model=None, rebuild_every=5, **kw):
    return MDSystem(random_binary_model()[1] if model is None else model,
                    r["geom"], dtype=torch.float64, device="cpu",
                    rebuild_every=rebuild_every, **kw)


def test_pair_and_trio_passes_match_jax(ref):
    """pair_forces_multi and trio_forces_multi (the plain version of the
    all-types pass: the species-gated pass once per ordered type,
    summed) on the JAX lists: energy, forces and virial within 1e-10."""
    r = ref
    port = _port_system(r)
    pot = port.potential
    pos = torch.tensor(r["pos"])
    cache2, cache3 = port.list_caches(r["nbr2"], r["nbr3"], port.cell)
    d2 = tnb.cached_displacements(pos, r["nbr2"], cache2)
    pair = multi.pair_forces_multi([t.coefficients for t in pot.pair_types],
                                   pot.pair_multi.specs, d2, cache2,
                                   with_virial=True)
    trio = multi.trio_forces_multi(pot, port.species, pos, r["nbr3"], cache3,
                                   with_virial=True)
    for want, ours in ((r["pair"], pair), (r["trio"], trio)):
        for a, b in zip(want, ours):
            assert a.shape == tuple(b.shape)
            assert np.abs(a - b.numpy()).max() < TOL
    assert np.abs(r["trio"][1]).max() > 1e-2
    assert np.abs(r["trio"][2]).max() > 1e-2
    # the per-type passes: the center gate leaves the other species'
    # rows untouched
    d3 = tnb.cached_displacements(pos, r["nbr3"], cache3)
    for t, desc in enumerate(pot.trio_multi.descs):
        e, fc, part = multi.trio_multi_partials_torch(
            d3, cache3.valid, cache3.s_slot, port.species,
            pot.trio_types[t].grid, desc)
        other = port.species != desc.s_c
        assert float(torch.abs(part[other]).max()) == 0.0
        assert float(torch.abs(fc[other]).max()) == 0.0
        assert float(torch.abs(part[~other]).max()) > 0.0


@pytest.mark.parametrize("built", ["from_model", "from_jax_multi"])
def test_fused_route_matches_jax_and_factorized(ref, built):
    """The engine's fused multi-species route against JAX's
    energy_forces (the same route) and against the port's factorized
    path on the same lists: energy, forces and virial within 1e-9."""
    r = ref
    model = None if built == "from_model" else _from_jax(r)
    port = _port_system(r, model)
    assert port._multi_route() and port.potential.trio is None
    pos = torch.tensor(r["pos"])
    energy, forces, virial = port.energy_forces(pos, r["nbr2"], r["nbr3"],
                                                with_virial=True)
    e_j, f_j, v_j = r["total"]
    assert abs(float(energy) - float(e_j)) < 1e-9
    assert np.abs(forces.numpy() - f_j).max() < 1e-9
    assert np.abs(virial.numpy() - v_j).max() < 1e-9
    oracle = _port_system(r)
    e_f, f_f, v_f = oracle.energy_forces_virial(pos, r["nbr2"], r["nbr3"])
    assert abs(float(energy) - float(e_f)) < 1e-9
    assert torch.max(torch.abs(forces - f_f)) < 1e-9
    assert torch.max(torch.abs(virial - v_f)) < 1e-9
    assert float(torch.abs(forces).max()) > 1e-2


def _same(want, state, cell, tol=1e-9):
    d = want["positions"] - state.positions.numpy()
    frac = d @ np.linalg.inv(cell)
    assert np.abs((frac - np.round(frac)) @ cell).max() < tol
    assert np.abs(want["velocities"] - state.velocities.numpy()).max() < tol
    assert np.abs(want["forces"] - state.forces.numpy()).max() < tol
    assert abs(want["energy"] - float(state.energy)) < tol


def test_nve_matches_jax(ref):
    """20 NVE steps of 1 fs in launches of one 5-step cycle, from the
    same numpy velocities at 10 K: positions, velocities, forces and
    energy within 1e-9."""
    r = ref
    port = _port_system(r)
    state = port.init_state(velocities=r["v0"])
    st = port.run(state, n_steps=20, dt_fs=1.0)
    _same(r["nve"], st, r["geom"].cell)
    assert not port.overflowed(st)
    assert np.abs(r["nve"]["positions"] - r["pos"]).max() > 1e-3


def test_scr_npt_matches_jax(ref):
    """SCR NPT at T = 0 (deterministic), the multi route's virial every
    step: the cell after each launch and the final state within 1e-9."""
    r = ref
    port = _port_system(r, rebuild_every=6)
    state, cells = port.npt_run(port.init_state(velocities=r["v0"]), **NPT)
    assert len(cells) == len(r["npt_cells"]) == 2
    for a, b in zip(cells, r["npt_cells"]):
        assert np.abs(a - b).max() < 1e-9
    cell = state.cell.numpy()
    assert np.abs(cell / r["geom"].cell[0, 0] - np.eye(3)).max() > 1e-4
    _same(r["npt"], state, cell)


def test_multi_respa_raises(ref):
    """The reference's r-RESPA split reads the unary pair spline, which
    a multi-species model lacks: n_respa > 1 raises at construction."""
    with pytest.raises(NotImplementedError,
                       match="uf3_tpu has no such path.*r-RESPA on the "
                             "multi-species route"):
        _port_system(ref, n_respa=2)
