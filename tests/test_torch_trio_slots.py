"""
The property the trio kernel's rows by live rank rely on: the 3-body
energy, center force and assembled forces do not depend on how many slots
the list has or where its live slots sit.  A rattled bcc W 3^3 cell (54
atoms, float64, ``benchmarks_data/model_2and3.json``) with its 16-slot
3-body list, widened to 23 and 32 slots with each atom's live slots
scattered (holes between them, in reversed or random order, the reverse
slots remapped): the port's plain version ``trio_partials_torch`` with
``assemble_forces`` against ``uf3_tpu``'s ``trio_forces_unrolled``
(uf3_tpu/ops/pallas_trio.py) on the same widened lists, and against the
port's own compact list, on full and triangle lanes, with and without
energy.  Tolerance 1e-10 in float64 (summation order only); the slot
partials of a widened list are the compact ones moved to their new slots,
and its dead slots' partials are zeros.  The kernel itself is held to the
plain version on the card in tests/test_torch_kernels.py.
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uf3_tpu.ops import pallas_trio as pt
from uf3_tpu.ops import potential as jpot
from uf3_tpu.regression import least_squares as ls
from uf3_tpu_torch.data.atoms import bulk
from uf3_tpu_torch.forcefield.md import MDSystem
from uf3_tpu_torch.ops import neighbors as nb
from uf3_tpu_torch.ops import trio
from uf3_tpu_torch.ops.potential import UF3Potential

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of a thread per core oversubscribes them
torch.set_num_threads(1)

MODEL = os.path.join("benchmarks_data", "model_2and3.json")
TOL = 1e-10  # float64: the same arithmetic in another summation order
WIDTHS = [23, 32]
LAYOUTS = ["reversed", "random"]


@functools.lru_cache(maxsize=None)
def jax_bundle():
    """The JAX package's trio bundle of MODEL."""
    model = ls.WeightedLinearModel.from_json(MODEL)
    return pt.build_trio_pallas(model, dtype=jnp.float64)


@functools.lru_cache(maxsize=None)
def port_model() -> UF3Potential:
    """The port's potential of MODEL from the JAX package's own pair and
    trio bundles (the same leg specs in both engines)."""
    model = ls.WeightedLinearModel.from_json(MODEL)
    params, _ = jpot.build_potential(model, dtype=jnp.float64)
    bundle = jax_bundle()
    spec, coefficients = pt.build_pair_fast(model, dtype=jnp.float64)
    return UF3Potential.from_jax_arrays(
        bundle._replace(grid=np.asarray(bundle.grid)),
        (spec, np.asarray(coefficients)), np.asarray(params.offsets_1b),
        np.asarray(params.z_to_species), float(params.r_cut_2b),
        float(params.r_cut_3b))


@pytest.fixture(scope="module")
def cell():
    """The port's system on the rattled cell, its positions and its
    16-slot 3-body list."""
    geom = bulk("W", "bcc", a=3.1652) * 3
    geom.rattle(0.05, seed=17)
    system = MDSystem(port_model(), geom, dtype=torch.float64,
                      capacity_3b=16, device="cpu")
    state = system.init_state()
    nbr = state.nbr3
    assert nbr.idx.shape == (54, 16) and not bool(nbr.overflow)
    live = nbr.mask.sum(1)
    assert int(live.min()) >= 10 and int(live.max()) < 16
    return system, state.positions, nbr


def widen(nbr: nb.NeighborList, k: int, layout: str, seed: int):
    """The list on ``k`` slots: atom a's slot s moves to new[a, s], a set
    of distinct slots in reversed order from the last slot down
    (``layout`` "reversed"; every other slot where room allows) or at
    random; empty slots point at the atom itself with a zero shift and a
    false mask; rev follows the moves.  Returns the widened list and
    ``new``."""
    idx, shift = nbr.idx.numpy(), nbr.shift.numpy()
    mask, rev = nbr.mask.numpy(), nbr.rev.numpy()
    n_atoms, k0 = idx.shape
    rng = np.random.RandomState(seed)
    new = np.zeros((n_atoms, k0), dtype=np.int64)
    for a in range(n_atoms):
        if layout == "reversed":  # every other slot where room allows
            gap = 2 if 2 * k0 <= k else 1
            new[a] = k - 1 - gap * np.arange(k0)
        else:
            new[a] = rng.permutation(k)[:k0]
    assert all(len(set(row)) == k0 for row in new)
    w_idx = np.repeat(np.arange(n_atoms)[:, None], k, 1)
    w_shift = np.zeros((n_atoms, k, 3), dtype=shift.dtype)
    w_mask = np.zeros((n_atoms, k), dtype=bool)
    w_rev = np.zeros((n_atoms, k), dtype=np.int64)
    rows = np.arange(n_atoms)[:, None]
    w_idx[rows, new] = np.where(mask, idx, rows)
    w_shift[rows, new] = np.where(mask[..., None], shift, 0.0)
    w_mask[rows, new] = mask
    w_rev[rows, new] = np.where(mask, new[idx, rev], 0)
    wide = nbr._replace(idx=torch.as_tensor(w_idx),
                        shift=torch.as_tensor(w_shift),
                        mask=torch.as_tensor(w_mask),
                        rev=torch.as_tensor(w_rev), sel=None)
    return wide, new


def port_trio(system, positions, nbr, with_energy, triangle):
    """The port's plain version and assembly: (energy (N,), center force
    (N, 3), partials (N, K, 5), forces (N, 3))."""
    cache = nb.list_cache(nbr, system.cell, torch.float64)
    d = nb.cached_displacements(positions, nbr, cache)
    pot = system.potential
    energy, f_center, part = trio.trio_partials_torch(
        d, cache.valid, pot.grid, pot.trio, with_energy,
        triangle=triangle)
    forces = trio.assemble_forces(energy, f_center, part, d, cache.rev_flat,
                                  nbr.mask)[1]
    return energy, f_center, part, forces


def jax_trio(system, positions, nbr, with_energy, triangle):
    """``trio_forces_unrolled`` on the same list: (energy (N,), forces
    (N, 3))."""
    tb = jax_bundle()
    energy, forces = pt.trio_forces_unrolled(
        tb.grid, jnp.asarray(positions.numpy()),
        jnp.asarray(system.cell.numpy()),
        jnp.asarray(nbr.idx.numpy().astype(np.int32)),
        jnp.asarray(nbr.shift.numpy()), jnp.asarray(nbr.mask.numpy()),
        jnp.asarray(nbr.rev.numpy().astype(np.int32)), spec_l=tb.spec_l,
        spec_n=tb.spec_n, l_basis=tb.l_basis, n_basis=tb.n_basis,
        active_bc=tb.active_bc, window=tb.window, with_energy=with_energy,
        triangle=triangle)
    return np.asarray(energy), np.asarray(forces)


def _err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def test_compact_list_matches_jax(cell):
    """The 16-slot list itself: the port's plain version and assembly
    against ``trio_forces_unrolled``, full and triangle lanes."""
    system, positions, nbr = cell
    for triangle in (False, True):
        e, _, _, f = port_trio(system, positions, nbr, True, triangle)
        e_j, f_j = jax_trio(system, positions, nbr, True, triangle)
        assert _err(e.numpy(), e_j) < TOL
        assert _err(f.numpy(), f_j) < TOL
        assert np.abs(f_j).max() > 1e-1


@pytest.mark.parametrize("k", WIDTHS)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("triangle", [False, True], ids=["full", "triangle"])
def test_widened_list_matches_compact_and_jax(cell, k, layout, triangle):
    """The list widened to 23 or 32 slots with scattered live slots:
    energy, center force and forces equal the compact list's, the
    partials are the compact ones at their new slots (zeros in the dead
    slots), and ``trio_forces_unrolled`` on the widened list agrees."""
    system, positions, nbr = cell
    wide, new = widen(nbr, k, layout, seed=k + len(layout))
    rev = nb.with_reverse_slots(wide).rev
    assert torch.equal(torch.where(wide.mask, rev, 0), wide.rev)
    for with_energy in (True, False):
        e0, fc0, part0, f0 = port_trio(system, positions, nbr, with_energy,
                                       triangle)
        e1, fc1, part1, f1 = port_trio(system, positions, wide, with_energy,
                                       triangle)
        assert _err(e1, e0) < TOL
        assert _err(fc1, fc0) < TOL
        assert _err(f1, f0) < TOL
        rows = torch.arange(part0.shape[0])[:, None]
        moved = part1[rows, torch.as_tensor(new)]
        assert _err(torch.where(nbr.mask[..., None], moved, 0.0),
                    torch.where(nbr.mask[..., None], part0, 0.0)) < TOL
        assert float(torch.abs(part1[~wide.mask]).max()) == 0.0
        if with_energy:
            e_j, f_j = jax_trio(system, positions, wide, True, triangle)
            assert _err(e1.numpy(), e_j) < TOL
            assert _err(f1.numpy(), f_j) < TOL
