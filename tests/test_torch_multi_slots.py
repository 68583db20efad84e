"""
The property the multi-species trio kernel's rows by live rank rely on:
the multi-species 3-body energy, center force and assembled forces do
not depend on how many slots the list has or where its live slots sit.
The random Ne/Xe 2+3-body model (8 ordered trio types) and a Ne/Ar/Xe
one (27), r 1-5 A, resolution 8, coefficients from RandomState(11) at
scale 0.05 (``species_model`` of tests/test_torch_kernels.py), each on
rattled fcc 3^3 (108 atoms, a = 5.4 A, 15-18 live slots a row) with its
18-slot 3-body list, widened to 24 and 32 slots with each atom's live
slots scattered (reversed or random order, the reverse slots remapped;
``widen`` of tests/test_torch_trio_slots.py): the port's plain version
``trio_multi_partials_all_torch`` with ``assemble_forces`` against
``uf3_tpu``'s ``trio_forces_multi`` (uf3_tpu/ops/pallas_trio.py) on the
same widened lists, and against the port's own compact list, with and
without energy.  Tolerance 1e-10 in float64 (summation order only); the
slot partials of a widened list are the compact ones moved to their new
slots, and its dead slots' partials are zeros.  JAX runs
``trio_forces_multi`` alone (with energy), in one module fixture, on the
binary model's 32-slot lists only: it compiles once per list width and
model, ~6 s binary and ~20 s ternary on the CPU.  The other lists meet
JAX through the port's compact list, which tests/test_torch_ternary.py
holds to ``trio_forces_multi`` on the same ternary model.  The kernel
itself is held to the plain version on the card in
tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_kernels import species_model
from test_torch_trio_slots import widen
from uf3_tpu.data.composition import ChemicalSystem
from uf3_tpu.ops import pallas_trio as pt
from uf3_tpu.regression import least_squares as ls
from uf3_tpu.representation.basis import BSplineBasis
from uf3_tpu_torch.data.atoms import Atoms, bulk
from uf3_tpu_torch.forcefield.md import MDSystem
from uf3_tpu_torch.ops import multi
from uf3_tpu_torch.ops import neighbors as nb
from uf3_tpu_torch.ops import trio

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of a thread per core oversubscribes them
torch.set_num_threads(1)

TOL = 1e-10  # float64: the same arithmetic in another summation order
ELEMENTS = {"binary": ["Ne", "Xe"], "ternary": ["Ne", "Ar", "Xe"]}
COMPACT = 18
WIDTHS = [24, 32]
LAYOUTS = ["reversed", "random"]
# the widths JAX runs on, by model
JAX_WIDTHS = {"binary": (32,), "ternary": ()}


def jax_model(elements):
    """The JAX package's model with ``species_model``'s basis and
    coefficients."""
    basis = BSplineBasis(ChemicalSystem(elements, degree=3), r_min_map=1.0,
                         r_max_map=5.0, resolution_map=8)
    model = ls.WeightedLinearModel(basis)
    model.coefficients = np.random.RandomState(11).normal(
        scale=0.05, size=sum(basis.partition_sizes))
    return model


def geometry(elements):
    """Rattled fcc 3^3 at a = 5.4 A, species by a seeded draw."""
    base = bulk("Ne", "fcc", a=5.4) * 3
    z = np.array([{"Ne": 10, "Ar": 18, "Xe": 54}[e] for e in elements])
    numbers = z[np.random.RandomState(len(elements)).randint(
        len(z), size=len(base))]
    geom = Atoms(numbers, base.get_positions(), base.get_cell(), pbc=True)
    geom.rattle(0.08, seed=1)
    return geom


def jax_trio(tm, species, positions, cell, nbr):
    """``trio_forces_multi`` with energy on ``nbr``: (energy (N,),
    forces (N, 3))."""
    energy, forces = pt.trio_forces_multi(
        tm.grids, jnp.asarray(species), jnp.asarray(positions.numpy()),
        jnp.asarray(cell.numpy()),
        jnp.asarray(nbr.idx.numpy().astype(np.int32)),
        jnp.asarray(nbr.shift.numpy()), jnp.asarray(nbr.mask.numpy()),
        jnp.asarray(nbr.rev.numpy().astype(np.int32)), descs=tm.descs)
    return np.asarray(energy), np.asarray(forces)


@pytest.fixture(scope="module")
def cells():
    """Per model: the port's system, positions, the compact 18-slot
    3-body list and its widenings (with each live slot's new place), and
    JAX's energy and forces on the widenings of ``JAX_WIDTHS``."""
    out = {}
    for name, elements in ELEMENTS.items():
        geom = geometry(elements)
        system = MDSystem(species_model(elements), geom, dtype=torch.float64,
                          capacity_3b=COMPACT, device="cpu")
        assert system._multi_route()
        state = system.init_state()
        nbr = state.nbr3
        live = nbr.mask.sum(1)
        assert nbr.idx.shape == (108, COMPACT) and not bool(nbr.overflow)
        assert int(live.min()) >= 12 and int(live.max()) == COMPACT
        lists = {"compact": (nbr, None)}
        for k in WIDTHS:
            for layout in LAYOUTS:
                lists[(k, layout)] = widen(nbr, k, layout,
                                           seed=k + len(layout))
        tm = pt.build_trio_multi(jax_model(elements), dtype=jnp.float64)
        species = system.species.numpy()
        assert np.array_equal(np.asarray(tm.z_to_species)[
            geom.get_atomic_numbers()], species)
        jax_out = {key: jax_trio(tm, species, state.positions, system.cell,
                                 lst) for key, (lst, _) in lists.items()
                   if key != "compact" and key[0] in JAX_WIDTHS[name]}
        out[name] = dict(system=system, positions=state.positions,
                         lists=lists, jax=jax_out)
    return out


def port_multi(system, positions, nbr, with_energy):
    """The port's plain version and assembly: (energy (N,), center force
    (N, 3), partials (N, K, 5), forces (N, 3))."""
    cache = nb.list_cache(nbr, system.cell, torch.float64, system.species)
    d = nb.cached_displacements(positions, nbr, cache)
    energy, f_center, part = multi.trio_multi_partials_all_torch(
        system.potential, d, cache.valid, cache.s_slot, system.species,
        with_energy)
    forces = trio.assemble_forces(energy, f_center, part, d, cache.rev_flat,
                                  nbr.mask)[1]
    return energy, f_center, part, forces


def _err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


@pytest.mark.parametrize("model", sorted(ELEMENTS))
def test_widened_lists_keep_each_live_slot(cells, model):
    """Each widened list holds the compact list's live slots, at distinct
    new places (reversed: from the last slot down), with the same
    neighbors and shifts, and reverse slots that point back; both
    species occur among the live slots."""
    cell = cells[model]
    nbr = cell["lists"]["compact"][0]
    rows = torch.arange(nbr.idx.shape[0])[:, None]
    for (k, layout), (wide, new) in ((key, v) for key, v in
                                     cell["lists"].items()
                                     if key != "compact"):
        at = torch.as_tensor(new)
        assert wide.idx.shape == (nbr.idx.shape[0], k)
        assert torch.equal(wide.mask.sum(1), nbr.mask.sum(1))
        assert torch.equal(wide.mask[rows, at], nbr.mask)
        assert torch.equal(torch.where(nbr.mask, wide.idx[rows, at], 0),
                           torch.where(nbr.mask, nbr.idx, 0))
        live = nbr.mask.numpy()
        a, s = np.nonzero(live)
        back = wide.rev.numpy()[a, new[a, s]]
        assert np.array_equal(new[nbr.idx.numpy()[a, s], nbr.rev.numpy()[
            a, s]], back)
        if layout == "reversed":
            assert (new[:, 0] == k - 1).all()
    species = cell["system"].species[nbr.idx][nbr.mask]
    assert len(torch.unique(species)) == len(ELEMENTS[model])


@pytest.mark.parametrize("model", sorted(ELEMENTS))
@pytest.mark.parametrize("k", WIDTHS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_widened_list_matches_compact_and_jax(cells, model, k, layout):
    """The list widened to 24 or 32 slots with scattered live slots:
    energy, center force and forces equal the compact list's, the
    partials are the compact ones at their new slots (zeros in the dead
    slots), with and without energy; ``trio_forces_multi`` on the
    widened list agrees."""
    cell = cells[model]
    system, positions = cell["system"], cell["positions"]
    nbr = cell["lists"]["compact"][0]
    wide, new = cell["lists"][(k, layout)]
    rev = nb.with_reverse_slots(wide).rev
    assert torch.equal(torch.where(wide.mask, rev, 0), wide.rev)
    for with_energy in (True, False):
        e0, fc0, part0, f0 = port_multi(system, positions, nbr, with_energy)
        e1, fc1, part1, f1 = port_multi(system, positions, wide, with_energy)
        assert _err(e1, e0) < TOL
        assert _err(fc1, fc0) < TOL
        assert _err(f1, f0) < TOL
        rows = torch.arange(part0.shape[0])[:, None]
        moved = part1[rows, torch.as_tensor(new)]
        assert _err(torch.where(nbr.mask[..., None], moved, 0.0),
                    torch.where(nbr.mask[..., None], part0, 0.0)) < TOL
        assert float(torch.abs(part1[~wide.mask]).max()) == 0.0
        if with_energy and (k, layout) in cell["jax"]:
            e_j, f_j = cell["jax"][(k, layout)]
            assert _err(e1.numpy(), e_j) < TOL
            assert _err(f1.numpy(), f_j) < TOL
            assert np.abs(f_j).max() > 1e-2
