"""
The port's fused multi-species 3-body pass on a ternary model against
the JAX package's, in float64 on the CPU, from the same numpy inputs: a
random Ne/Ar/Xe 2+3-body model (r 1-5 A, resolution 8, coefficients
from RandomState(11) at scale 0.05, built like the binary model of
test_torch_factorized.random_binary_model; 27 ordered trio types) on
fcc 3^3 (108 atoms, a = 5.4 A, species by a seeded draw, rattled
0.08 A):

- ``build_trio_multi`` against JAX's: the 27 ordered types, their leg
  specs, windows, live blocks and grids (1e-14), and the species ids;
- ``trio_forces_multi`` (on the CPU the plain version of the one-launch
  pass over every ordered type) against JAX's ``trio_forces_multi`` on
  the port's 3-body list: per-atom energy, forces and the virial within
  1e-10, with no kernel launch.

JAX runs ``pt.trio_forces_multi`` alone (one jit, not the JAX engine),
in one module fixture.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uf3_tpu.data.composition import ChemicalSystem
from uf3_tpu.ops import pallas_trio as pt
from uf3_tpu.regression import least_squares as ls
from uf3_tpu.representation.basis import BSplineBasis
from uf3_tpu_torch import io
from uf3_tpu_torch.data import composition as t_comp
from uf3_tpu_torch.data.atoms import Atoms, bulk
from uf3_tpu_torch.forcefield.md import MDSystem
from uf3_tpu_torch.ops import multi
from uf3_tpu_torch.representation import basis as t_basis

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of a thread per core oversubscribes them
torch.set_num_threads(1)

ELEMENTS = ["Ne", "Ar", "Xe"]
TOL = 1e-10


def ternary_model():
    """Ne/Ar/Xe, degree 3, r 1.0-5.0 A, resolution 8, coefficients from
    RandomState(11) at scale 0.05: (JAX model, port model)."""
    basis = BSplineBasis(ChemicalSystem(ELEMENTS, degree=3), r_min_map=1.0,
                         r_max_map=5.0, resolution_map=8)
    model = ls.WeightedLinearModel(basis)
    model.coefficients = np.random.RandomState(11).normal(
        scale=0.05, size=sum(basis.partition_sizes))
    port_basis = t_basis.BSplineBasis(
        t_comp.ChemicalSystem(ELEMENTS, degree=3), r_min_map=1.0,
        r_max_map=5.0, resolution_map=8)
    return model, io.FittedModel(port_basis, model.coefficients.copy())


@pytest.fixture(scope="module")
def case():
    """The port's system and lists on the ternary cell, JAX's trio
    bundle and its trio_forces_multi on the port's 3-body list."""
    jax_model, port_model = ternary_model()
    base = bulk("Ne", "fcc", a=5.4) * 3
    numbers = np.array([10, 18, 54])[np.random.RandomState(5).randint(
        3, size=len(base))]
    geom = Atoms(numbers, base.get_positions(), base.get_cell(), pbc=True)
    geom.rattle(0.08, seed=1)
    system = MDSystem(port_model, geom, dtype=torch.float64, device="cpu")
    state = system.init_state()
    nbr3 = state.nbr3
    tm = pt.build_trio_multi(jax_model, dtype=jnp.float64)
    species = np.asarray(tm.z_to_species)[numbers]
    out = pt.trio_forces_multi(
        tm.grids, jnp.asarray(species), jnp.asarray(state.positions.numpy()),
        jnp.asarray(system.cell.numpy()),
        jnp.asarray(nbr3.idx.numpy().astype(np.int32)),
        jnp.asarray(nbr3.shift.numpy()), jnp.asarray(nbr3.mask.numpy()),
        jnp.asarray(nbr3.rev.numpy().astype(np.int32)), descs=tm.descs,
        with_virial=True)
    return dict(system=system, state=state, tm=tm, species=species,
                trio=tuple(np.asarray(x) for x in out))


def test_ternary_types_match_jax(case):
    """The 27 ordered types in JAX's order: species, specs, windows,
    live blocks and grids; the species ids of the atoms."""
    pot, tm = case["system"].potential, case["tm"]
    assert len(pot.trio_multi.descs) == len(tm.descs) == 27
    assert np.array_equal(case["system"].species.numpy(), case["species"])
    for ours, theirs, grid, jgrid in zip(pot.trio_multi.descs, tm.descs,
                                         pot.trio_multi.grids, tm.grids):
        assert (ours.s_c, ours.s_m, ours.s_n) == (theirs.s_c, theirs.s_m,
                                                  theirs.s_n)
        assert tuple(ours.window) == tuple(theirs.window)
        assert tuple(ours.active_bc) == tuple(
            (b, tuple(c)) for b, c in theirs.active_bc)
        for a, b in ((ours.spec_l1, theirs.spec_l1),
                     (ours.spec_l2, theirs.spec_l2),
                     (ours.spec_n, theirs.spec_n)):
            assert (a.kind, a.n_int, a.n_basis) == (b.kind, b.n_int,
                                                    b.n_basis)
            assert np.allclose([a.u0, a.h, a.t_min, a.t_max],
                               [b.u0, b.h, b.t_min, b.t_max], rtol=0,
                               atol=1e-14)
        assert np.abs(grid - np.asarray(jgrid)).max() < 1e-14
    assert pot.trio_multi_mirrored
    type_of = pot.trio_packed.ints.numpy()[:27]
    assert sorted(type_of.tolist()) == list(range(27))


def test_ternary_trio_pass_matches_jax(case):
    """trio_forces_multi on the CPU (the plain all-types pass) against
    JAX's on the same list: per-atom energy, forces and the Voigt virial
    from the summed partials within 1e-10; no kernel launch."""
    system, state = case["system"], case["state"]
    _, cache3 = system.list_caches(state.nbr2, state.nbr3, system.cell)
    launches = multi.trio_multi_partials_all.launches
    ours = multi.trio_forces_multi(system.potential, system.species,
                                   state.positions, state.nbr3, cache3,
                                   with_virial=True)
    assert multi.trio_multi_partials_all.launches == launches
    for want, got in zip(case["trio"], ours):
        assert want.shape == tuple(got.shape)
        assert np.abs(want - got.numpy()).max() < TOL
    assert np.abs(case["trio"][1]).max() > 1e-2
    assert np.abs(case["trio"][2]).max() > 1e-2
