"""
The port's halo-exchange MD (``uf3_tpu_torch/parallel/halo.py``) on a
4-shard mesh within one process, against the JAX package's halo chunk
on its 4-device virtual CPU mesh and against the port's single-device
engine, in float64 from the same numpy inputs: twins of the 8 tests of
``tests/test_halo.py`` at their bounds, the port's ``decompose`` against
JAX's (owners, send sets, shifts, local neighbor sets per row), and the
port's chunk on the JAX decomposition (``SlabDecomposition.from_numpy``).
The reference's HLO audits become assertions on ``ShardMesh.traffic``.

Cell: the reference's bcc W 4 x 4 x 8 (256 atoms, rattled 0.05 A, 64/16
slots).  The JAX results are computed once, in one module fixture.
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
from uf3_tpu.ops import pallas_trio as pt
from uf3_tpu.ops import potential as jpot
from uf3_tpu.parallel import halo as jhalo
from uf3_tpu.parallel import mesh as jmesh
from uf3_tpu.regression import least_squares as ls
from uf3_tpu_torch.forcefield.md import MDSystem
from uf3_tpu_torch.ops.pair import pair_short_forces, pair_tail_forces
from uf3_tpu_torch.ops.potential import VOIGT_AB, UF3Potential
from uf3_tpu_torch.ops.trio import trio_forces
from uf3_tpu_torch.parallel import halo, mesh

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of a thread per core oversubscribes them
torch.set_num_threads(1)

MODEL = os.path.join("benchmarks_data", "model_2and3.json")
N_SHARDS = 4
CAPS = dict(capacity_2b=64, capacity_3b=16)
N_STEPS = 5
RESPA = dict(n_steps=6, n_respa=3, respa_mid=3)
DT = 1.0 * units.fs


@functools.lru_cache(maxsize=None)
def port_model() -> UF3Potential:
    """The port's potential through the weights converter from the JAX
    package's own bundles, so that both packages run the same leg specs
    (ROADMAP.md section 3)."""
    model = ls.WeightedLinearModel.from_json(MODEL)
    params, _ = jpot.build_potential(model, dtype=jnp.float64)
    trio = pt.build_trio_pallas(model, dtype=jnp.float64)
    spec, coefficients = pt.build_pair_fast(model, dtype=jnp.float64)
    return UF3Potential.from_jax_arrays(
        trio._replace(grid=np.asarray(trio.grid)),
        (spec, np.asarray(coefficients)), np.asarray(params.offsets_1b),
        np.asarray(params.z_to_species), float(params.r_cut_2b),
        float(params.r_cut_3b))


def _geom():
    # slab width (25.3 / 4 = 6.3 A) covers the halo width (r_cut + skin
    # = 6.0 A), as in tests/test_halo.py
    geom = bulk("W", "bcc", a=3.1652) * (4, 4, 8)
    geom.rattle(0.05, seed=3)
    return geom


def _np(x):
    return np.array(x)


def _v0(n, seed):
    return np.random.RandomState(seed).normal(scale=5e-4, size=(n, 3))


def _stale_x0(x_own, own_mask, skin):
    """Owned positions with one atom moved past half the skin."""
    x0 = np.array(x_own)
    s0 = int(np.argmax(own_mask.sum(axis=1)))
    slot = int(np.argmax(own_mask[s0]))
    x0[s0, slot, 0] += 0.51 * skin
    return x0


@pytest.fixture(scope="module")
def ref():
    """The JAX decomposition and halo chunks' outputs, as numpy."""
    import jax
    if len(jax.devices()) < N_SHARDS:
        pytest.skip("needs virtual devices")
    model = ls.WeightedLinearModel.from_json(MODEL)
    geom = _geom()
    system = JaxMDSystem(model, geom, dtype=jnp.float64, **CAPS)
    dec = jhalo.decompose(
        geom.get_positions(), geom.get_cell(), N_SHARDS,
        r_cut_2b=float(system.r_cut_2b), r_cut_3b=float(system.r_cut_3b),
        skin=float(system.skin), masses=np.asarray(system.masses), **CAPS)
    jm = jmesh.make_mesh(N_SHARDS)
    zero = jnp.asarray(0.0, dtype=jnp.float64)
    dt = jnp.asarray(DT, dtype=jnp.float64)
    n = len(geom)
    out = dict(dec=jax.tree.map(np.asarray, dec))
    chunk, shard = jhalo.halo_md_step_factory(system, jm, n_steps=0,
                                              with_virial=True)
    dec_dev, v_zero = shard(dec), shard(np.zeros(dec.x_own.shape))
    res = chunk(dec_dev, shard(dec.x_own), v_zero, zero)
    out.update(energy=float(res[3]), virial=_np(res[4]),
               stale=bool(res[5]),
               forces=jhalo.gather_positions(dec, res[2], n))
    x0 = _stale_x0(dec.x_own, dec.own_mask, float(system.skin))
    out["stale_moved"] = bool(chunk(dec_dev, shard(x0), v_zero, zero)[5])
    for name, kw, seed in (("nve", dict(n_steps=N_STEPS), 11),
                           ("respa", RESPA, 12)):
        chunk, shard = jhalo.halo_md_step_factory(system, jm, **kw)
        res = chunk(dec_dev, shard(dec.x_own),
                    shard(jhalo.scatter_velocities(dec, _v0(n, seed))), dt)
        out[name] = (jhalo.gather_positions(dec, res[0], n),
                     jhalo.gather_positions(dec, res[1], n), bool(res[-1]))
    return out


@pytest.fixture(scope="module")
def setup():
    """The port's system, decomposition and 4-shard mesh (CPU, f64)."""
    geom = _geom()
    system = MDSystem(port_model(), geom, dtype=torch.float64,
                      device="cpu", **CAPS)
    dec = halo.decompose(
        geom.get_positions(), geom.get_cell(), N_SHARDS,
        r_cut_2b=system.r_cut_2b, r_cut_3b=system.r_cut_3b,
        skin=system.skin, masses=system.masses.numpy(), device="cpu",
        **CAPS)
    return geom, system, dec, mesh.make_mesh(N_SHARDS, device="cpu")


def _single_device(system, dec, n):
    x = torch.as_tensor(halo.gather_positions(dec, dec.x_own, n))
    nbr2, nbr3 = system.build_lists(x)
    return x, nbr2, nbr3


def _run(system, m4, dec, n_steps=0, v0=None, x_own=None, **kw):
    chunk, shard = halo.halo_md_step_factory(system, m4, n_steps=n_steps,
                                             **kw)
    d = shard(dec)
    v = torch.zeros_like(d.x_own) if v0 is None \
        else shard(halo.scatter_velocities(dec, v0))
    x = d.x_own if x_own is None else shard(x_own)
    return chunk(d, x, v, DT)


def test_decompose_roundtrip(setup):
    geom, _, dec, _ = setup
    n = len(geom)
    own_gid, own_mask = dec.own_gid.numpy(), dec.own_mask.numpy()
    assert sorted(own_gid[own_mask].tolist()) == list(range(n))
    x = halo.gather_positions(dec, dec.x_own, n)
    frac = geom.get_positions() @ np.linalg.inv(geom.get_cell())
    x_ref = (frac - np.floor(frac)) @ geom.get_cell()
    assert np.allclose(x, x_ref, atol=1e-12)


def _row_sets(idx, shift, mask):
    """Per (shard, row): the set of (neighbor, image shift) it lists."""
    return [[{(int(j), tuple(np.rint(sh).astype(int)))
              for j, sh, ok in zip(idx[s, r], shift[s, r], mask[s, r]) if ok}
             for r in range(idx.shape[1])] for s in range(idx.shape[0])]


def test_decompose_matches_jax(setup, ref):
    """Owners, send sets, wrap shifts, center weights and the local
    neighbor sets per row (slot order only changes summation order)."""
    _, _, dec, _ = setup
    jd = ref["dec"]
    for name in ("own_gid", "own_mask", "send_left", "send_right",
                 "send_left_mask", "send_right_mask"):
        assert np.array_equal(getattr(dec, name).numpy(),
                              getattr(jd, name)), name
    for name in ("x_own", "masses", "shift_left", "shift_right",
                 "center_w"):
        assert np.allclose(getattr(dec, name).numpy(),
                           getattr(jd, name), atol=1e-12), name
    for tag in ("2", "3"):
        port = _row_sets(*(getattr(dec, f + tag).numpy()
                           for f in ("idx", "shift", "mask")))
        jax_ = _row_sets(*(np.asarray(getattr(jd, f + tag))
                           for f in ("idx", "shift", "mask")))
        assert port == jax_, tag


def test_halo_forces_and_energy_match_single_device(setup, ref):
    geom, system, dec, m4 = setup
    n = len(geom)
    x, nbr2, nbr3 = _single_device(system, dec, n)
    e_ref, f_ref, _ = system.energy_forces(x, nbr2, nbr3)
    _, _, f_own, energy, stale = _run(system, m4, dec)
    assert not bool(stale)
    assert np.isclose(float(energy), float(e_ref), rtol=1e-10)
    f = halo.gather_positions(dec, f_own, n)
    assert np.max(np.abs(f - f_ref.numpy())) < 1e-9
    # against the JAX halo chunk
    assert np.isclose(float(energy), ref["energy"], rtol=1e-10)
    assert np.max(np.abs(f - ref["forces"])) < 1e-9


def test_halo_virial_matches_single_device(setup, ref):
    """Owner-weighted per-center virial terms, psummed, give the
    single-device virial exactly."""
    geom, system, dec, m4 = setup
    x, nbr2, nbr3 = _single_device(system, dec, len(geom))
    e_ref, _, v_ref = system.energy_forces(x, nbr2, nbr3, with_virial=True)
    v_ref6 = np.array([float(v_ref[a, b]) for a, b in VOIGT_AB])
    _, _, _, energy, virial, stale = _run(system, m4, dec, with_virial=True)
    assert not bool(stale)
    assert np.isclose(float(energy), float(e_ref), rtol=1e-10)
    assert np.allclose(virial.numpy(), v_ref6, atol=1e-9)
    assert np.allclose(virial.numpy(), ref["virial"], atol=1e-9)


def test_halo_trajectory_matches_single_device(setup, ref):
    geom, system, dec, m4 = setup
    n = len(geom)
    v0 = _v0(n, 11)
    x, nbr2, nbr3 = _single_device(system, dec, n)
    m = system.masses[:, None]
    v = torch.as_tensor(v0)
    _, f, _ = system.energy_forces(x, nbr2, nbr3, with_energy=False)
    for _ in range(N_STEPS):
        v = v + 0.5 * DT * f / m
        x = x + DT * v
        _, f, _ = system.energy_forces(x, nbr2, nbr3, with_energy=False)
        v = v + 0.5 * DT * f / m
    x_own, v_own, _, _, stale = _run(system, m4, dec, N_STEPS, v0)
    assert not bool(stale)
    x_h = halo.gather_positions(dec, x_own, n)
    v_h = halo.gather_positions(dec, v_own, n)
    assert np.max(np.abs(x_h - x.numpy())) < 1e-9
    assert np.max(np.abs(v_h - v.numpy())) < 1e-11
    x_j, v_j, stale_j = ref["nve"]
    assert not stale_j
    assert np.max(np.abs(x_h - x_j)) < 1e-9
    assert np.max(np.abs(v_h - v_j)) < 1e-11


def test_halo_respa_trajectory_matches_single_device(setup, ref):
    """3-level r-RESPA halo chunk against the same split integrated on
    the global lists on one device, and against the JAX halo chunk."""
    geom, system, dec, m4 = setup
    n = len(geom)
    n_steps, n_respa, respa_mid = (RESPA[k] for k in
                                   ("n_steps", "n_respa", "respa_mid"))
    pot = system.potential
    spec = pot.pair_spec
    r_hi = system.r_cut_3b
    r_lo = r_hi - 0.5
    v0 = _v0(n, 12)
    x, nbr2, nbr3 = _single_device(system, dec, n)
    m = system.masses[:, None]

    def f_short(x):
        return pair_short_forces(pot.pair_coefficients, x, system.cell,
                                 nbr3, spec_pair=spec,
                                 n_basis_pair=spec.n_basis,
                                 with_energy=False, r_lo=r_lo,
                                 r_hi=r_hi)[1]

    def f_trio(x):
        return trio_forces(pot, x, system.cell, nbr3, False)[1]

    def f_tail(x):
        return pair_tail_forces(pot.pair_coefficients, x, system.cell, nbr2,
                                spec_pair=spec, n_basis_pair=spec.n_basis,
                                with_energy=False, r_lo=r_lo, r_hi=r_hi)[1]

    v = torch.as_tensor(v0)
    fp, fm, ft = f_short(x), f_trio(x), f_tail(x)
    dt_mid, dt_out = DT * respa_mid, DT * n_respa
    for _ in range(n_steps // n_respa):
        v = v + 0.5 * dt_out * ft / m
        for _ in range(n_respa // respa_mid):
            v = v + 0.5 * dt_mid * fm / m
            for _ in range(respa_mid):
                v = v + 0.5 * DT * fp / m
                x = x + DT * v
                fp = f_short(x)
                v = v + 0.5 * DT * fp / m
            fm = f_trio(x)
            v = v + 0.5 * dt_mid * fm / m
        ft = f_tail(x)
        v = v + 0.5 * dt_out * ft / m
    x_own, v_own, _, _, stale = _run(system, m4, dec, v0=v0, **RESPA)
    assert not bool(stale)
    x_h = halo.gather_positions(dec, x_own, n)
    v_h = halo.gather_positions(dec, v_own, n)
    assert np.max(np.abs(x_h - x.numpy())) < 1e-9
    assert np.max(np.abs(v_h - v.numpy())) < 1e-11
    x_j, v_j, stale_j = ref["respa"]
    assert not stale_j
    assert np.max(np.abs(x_h - x_j)) < 1e-9
    assert np.max(np.abs(v_h - v_j)) < 1e-11


def _audit(m4, c_halo, with_virial=False):
    """The halo path's collectives: no all_gather, every permute at most
    (C_halo, 3) elements (N would be N * 3), scalar reductions (and the
    6-element virial)."""
    assert not m4.traffic["all_gather"]
    assert m4.traffic["ppermute"]
    assert max(m4.traffic["ppermute"]) <= c_halo * 3
    assert set(m4.traffic["psum"]) <= ({1, 6} if with_virial else {1})
    assert set(m4.traffic["pmax"]) == {1}


def test_halo_respa_collectives_stay_halo_sized(setup):
    geom, system, dec, m4 = setup
    m4.reset_traffic()
    _run(system, m4, dec, **RESPA)
    _audit(m4, dec.c_halo)
    # 2 position permutes at the start, every step and the end; 2
    # partial permutes at the start, every mid step and the end
    steps, mids = RESPA["n_steps"], RESPA["n_steps"] // RESPA["respa_mid"]
    assert len(m4.traffic["ppermute"]) == 2 * (steps + 2) + 2 * (mids + 2)
    assert 3 * dec.c_halo < 3 * len(geom)


def test_halo_collectives_scale_with_halo_not_n(setup):
    geom, system, dec, m4 = setup
    m4.reset_traffic()
    _run(system, m4, dec, n_steps=2)
    _audit(m4, dec.c_halo)
    # 4 permutes per force call: 2 position refreshes, 2 partial returns
    assert len(m4.traffic["ppermute"]) == 4 * (2 + 2)
    assert m4.traffic["psum"] == [1]
    m4.reset_traffic()
    _run(system, m4, dec, with_virial=True)
    _audit(m4, dec.c_halo, with_virial=True)
    assert sorted(m4.traffic["psum"]) == [1, 6]


def test_halo_stale_flags_skin_violation(setup, ref):
    """Moving an owned atom past half the skin sets the replicated stale
    flag (the signal to decompose again), in both packages."""
    _, system, dec, m4 = setup
    x0 = _stale_x0(dec.x_own.numpy(), dec.own_mask.numpy(), system.skin)
    assert bool(_run(system, m4, dec, x_own=x0)[-1])
    assert ref["stale_moved"] and not ref["stale"]


def test_port_chunk_on_jax_decomposition(setup, ref):
    """The port's chunk on the JAX package's own decomposition, carried
    across by ``SlabDecomposition.from_numpy``: the JAX chunk's energy,
    forces and virial."""
    geom, system, _, m4 = setup
    jd = halo.SlabDecomposition.from_numpy(ref["dec"], device="cpu")
    _, _, f_own, energy, virial, stale = _run(system, m4, jd,
                                              with_virial=True)
    assert not bool(stale)
    f = halo.gather_positions(jd, f_own, len(geom))
    assert np.isclose(float(energy), ref["energy"], rtol=1e-10)
    assert np.max(np.abs(f - ref["forces"])) < 1e-9
    assert np.allclose(virial.numpy(), ref["virial"], atol=1e-9)
