"""
The port's neighbor lists (uf3_tpu_torch/ops/neighbors.py) against the
JAX builders (uf3_tpu/ops/neighbors.py) on a rattled 1,024-atom bcc W
box (8^3 cells), the size at which the MD engine takes the cell-list
path, from wrapped positions as the engine builds.  Slot order may
differ between the two, so rows are compared as neighbor SETS (atom,
image shift) plus the overflow flag; the reverse slots and parent slots
are checked for consistency.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uf3_tpu.data.atoms import bulk
from uf3_tpu.ops import neighbors as jnb
from uf3_tpu_torch.forcefield.md import MDSystem
from uf3_tpu_torch.ops import neighbors as tnb

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of a thread per core oversubscribes them
torch.set_num_threads(1)

R2, R3 = 5.5 + 1.2, 3.5 + 0.5  # bench cutoffs + skins


@pytest.fixture(scope="module")
def box():
    geom = bulk("W", "bcc", a=3.1652) * (8, 8, 8)
    geom.rattle(0.08, seed=5)
    pos = np.asarray(geom.positions)
    cell = np.asarray(geom.cell)
    pbc = tuple(bool(p) for p in geom.pbc)
    grid_shape = tnb.grid_shape_for(cell, R2, pbc)
    assert grid_shape == jnb.grid_shape_for(cell, R2, pbc)
    topo_t = tnb.bin_topology(grid_shape, pbc)
    topo_j = jnb.bin_topology(grid_shape, pbc)
    for a, b in zip(topo_t, topo_j):
        assert np.array_equal(a, b)
    # the engine's bin capacity, sized from the measured occupancy
    bin_capacity = MDSystem._cell_list_geometry(geom.positions, cell, pbc,
                                                R2)[1]
    return pos, cell, pbc, grid_shape, topo_j, bin_capacity


def _rows(nbr):
    """Per-row sorted keys of the (atom, image shift) set; -1 pads."""
    idx, shift, mask = (np.asarray(nbr.idx), np.asarray(nbr.shift),
                        np.asarray(nbr.mask))
    code = ((shift + 1) @ np.array([9, 3, 1])).astype(np.int64)
    key = np.where(mask, idx.astype(np.int64) * 27 + code, -1)
    return np.sort(key, axis=1)


def _same_sets(nj, nt):
    a, b = _rows(nj), _rows(nt)
    width = max(a.shape[1], b.shape[1])
    pad = [np.pad(x, ((0, 0), (width - x.shape[1], 0)),
                  constant_values=-1) for x in (a, b)]
    return np.array_equal(pad[0], pad[1])


def _check_rev(nbr):
    idx, shift, mask, rev = (np.asarray(nbr.idx), np.asarray(nbr.shift),
                             np.asarray(nbr.mask), np.asarray(nbr.rev))
    a, s = np.nonzero(mask)
    c = idx[a, s]
    assert np.array_equal(idx[c, rev[a, s]], a)
    assert np.array_equal(shift[c, rev[a, s]], -shift[a, s])
    assert np.all(mask[c, rev[a, s]])


def _build(box, pos, cell_scale=1.0):
    # wrapped positions, as the MD engine builds from
    _, cell, pbc, grid_shape, topo, bin_capacity = box
    cell = cell * cell_scale
    nj = jnb.build_neighbor_list_cells(
        jnp.asarray(pos), jnp.asarray(cell), pbc, R2, 72, grid_shape,
        bin_capacity, topo, with_rev=False, assume_wrapped=True)
    nt = tnb.build_neighbor_list_cells(
        torch.tensor(pos), torch.tensor(cell), pbc, R2, 72, grid_shape,
        bin_capacity, topo)
    return nj, nt


def _wrapped(box):
    return np.asarray(tnb.wrap_positions(torch.tensor(box[0]),
                                         torch.tensor(box[1]), box[2]))


def test_cell_list_sets_rev_overflow_and_filter(box):
    # one static configuration (capacity 72, the engine's bin capacity)
    # throughout, so the JAX builder compiles once
    pos, cell = _wrapped(box), box[1]
    nj, nt = _build(box, pos)
    assert _same_sets(nj, nt)
    assert bool(nj.overflow) is False and bool(nt.overflow) is False
    assert nt.mask.sum(1).min() > 40
    # row overflow: the box compressed to 80% holds ~2x the neighbors
    # (bins stay wider than the cutoff)
    oj, ot = _build(box, pos * 0.8, cell_scale=0.8)
    assert bool(oj.overflow) is True and bool(ot.overflow) is True
    # bin overflow: 90 atoms moved into the first bin
    crowded = pos.copy()
    crowded[:90] = np.random.RandomState(2).uniform(0.0, 6.0, (90, 3))
    oj, ot = _build(box, crowded)
    assert bool(oj.overflow) is True and bool(ot.overflow) is True
    # the 3-body list: a refilter at drifted positions with the fresher
    # staleness reference
    moved = pos + np.random.RandomState(4).normal(0, 0.05, pos.shape)
    fj = jnb.filter_neighbor_list(nj, jnp.asarray(moved), jnp.asarray(cell),
                                  R3, 16, reference_positions=moved)
    ft = tnb.filter_neighbor_list(nt, torch.tensor(moved),
                                  torch.tensor(cell), R3, 16,
                                  reference_positions=torch.tensor(moved))
    assert _same_sets(fj, ft)
    assert bool(fj.overflow) is False and bool(ft.overflow) is False
    _check_rev(ft)
    idx2, sel, mask = nt.idx.numpy(), ft.sel.numpy(), ft.mask.numpy()
    a, k = np.nonzero(mask)
    assert np.array_equal(idx2[a, sel[a, k]], ft.idx.numpy()[a, k])
    assert np.array_equal(ft.reference_positions.numpy(), moved)
    # a too-small 3-body capacity overflows in both
    assert bool(jnb.filter_neighbor_list(nj, jnp.asarray(pos),
                                         jnp.asarray(cell), R3, 10).overflow)
    assert bool(tnb.filter_neighbor_list(nt, torch.tensor(pos),
                                         torch.tensor(cell), R3,
                                         10).overflow)


def test_wrap_trigger_capacity(box):
    pos, cell, pbc = _wrapped(box), box[1], box[2]
    rng = np.random.RandomState(6)
    far = box[0] + rng.randint(-3, 4, (len(pos), 3)) @ cell
    wj = jnb.wrap_positions(jnp.asarray(far), jnp.asarray(cell), pbc)
    wt = tnb.wrap_positions(torch.tensor(far), torch.tensor(cell), pbc)
    assert np.allclose(np.asarray(wj), wt.numpy(), atol=1e-10, rtol=0)
    # the staleness trigger reads only the build-time positions
    nj = jnb.NeighborList(None, None, None, None, None, jnp.asarray(pos))
    nt = tnb.NeighborList(None, None, None, None, None, torch.tensor(pos))
    for skin in (0.05, 0.2, 0.6):
        for scale in (0.01, 0.1):
            moved = pos + rng.normal(0, scale, pos.shape)
            assert bool(jnb.needs_rebuild(nj, jnp.asarray(moved), skin)) \
                == bool(tnb.needs_rebuild(nt, torch.tensor(moved), skin))
    for r_cut in (4.0, 6.7):
        assert tnb.estimate_capacity(1024, 32.0 ** 3, r_cut) \
            == jnb.estimate_capacity(1024, 32.0 ** 3, r_cut)


def _long_trio_model():
    """A unary W model whose 3-body cutoff (4 A) passes its 2-body
    cutoff (3 A), random coefficients."""
    from uf3_tpu_torch import io
    from uf3_tpu_torch.data.composition import ChemicalSystem
    from uf3_tpu_torch.representation.basis import BSplineBasis
    basis = BSplineBasis(
        ChemicalSystem(["W"], degree=3), r_min_map={("W", "W"): 1.5},
        r_max_map={("W", "W"): 3.0, ("W", "W", "W"): [4.0, 4.0, 8.0]},
        resolution_map={("W", "W"): 8, ("W", "W", "W"): [6, 6, 12]})
    return io.FittedModel(basis, np.random.RandomState(0).normal(
        scale=0.05, size=sum(basis.partition_sizes)))


@pytest.mark.parametrize("reps, scale, model, after", [
    ((8, 8, 8), 0.9, "bench", "cells"),
    ((8, 8, 4), 0.9, "bench", "images"),
    ((8, 8, 8), 0.85, "long_trio", "cells")],
    ids=["fewer-bins", "to-images", "separate-3body"])
def test_builders_follow_a_shrinking_cell(reps, scale, model, after):
    """Port only (the reference fixes its builders at construction): a
    periodic cell compressed past its bins' margin over r_cut + skin.
    The bench model's builder chosen for the entry cell drops pairs
    there (its 6 A list reaches across the narrowed bins); a full
    rebuild in the new cell chooses again (fewer bins, or the images
    builder once fewer than 16 bins are left), and its lists hold the
    neighbor sets and overflow flag of the O(N^2) or images builder on
    the same positions, the separately built 3-body list too (with
    reverse slots)."""
    from uf3_tpu_torch.data.atoms import bulk as t_bulk
    from uf3_tpu_torch.forcefield.md import MDSystem as Engine
    geom = t_bulk("W", "bcc", a=3.1652) * reps
    geom.rattle(0.05, seed=2)
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmarks_data", "model_2and3.json")
    port = Engine(path if model == "bench" else _long_trio_model(), geom,
                  dtype=torch.float64, device="cpu", capacity_2b=120,
                  capacity_3b=64)
    lists = [("_2b", port.r_cut_2b + port.skin_2b, port.capacity_2b)]
    if port.separate_3b:
        lists.append(("_3b", port.r_cut_3b + port.skin, port.capacity_3b))
    entry = {tag: (getattr(port, "_images" + tag),
                   getattr(port, "_cells" + tag)) for tag, _, _ in lists}
    assert all(cells is not None for _, cells in entry.values())
    cell = port.cell * scale
    x = port._wrap(torch.tensor(geom.positions) * scale, cell)
    nbr2, nbr3 = port.build_lists(x, cell)
    built = {"_2b": nbr2, "_3b": nbr3}
    pbc = port.pbc
    for tag, r_cut, capacity in lists:
        images, cells = getattr(port, "_images" + tag), \
            getattr(port, "_cells" + tag)
        if after == "cells":
            assert cells is not None
            assert all(n < m for n, m in zip(cells[0], entry[tag][1][0]))
            ref = tnb.build_neighbor_list(x, cell, pbc, r_cut, capacity)
        else:
            assert cells is None and images == (1, 1, 1)
            ref = tnb.build_neighbor_list_images(x, cell, pbc, r_cut,
                                                 capacity, images=images)
        assert _same_sets(ref, built[tag])
        assert bool(ref.overflow) is bool(built[tag].overflow) is False
        if model == "bench":
            stale = port._build(x, cell, r_cut, capacity, *entry[tag])
            assert not _same_sets(ref, stale)
    if port.separate_3b:
        assert nbr3.sel is None
        _check_rev(nbr3)
    else:
        _check_rev(nbr3)
        ref3 = tnb.filter_neighbor_list(
            tnb.build_neighbor_list(x, cell, pbc, port.r_cut_2b
                                    + port.skin_2b, port.capacity_2b),
            x, cell, port.r_cut_3b + port.skin, port.capacity_3b)
        assert _same_sets(ref3, nbr3)
    # an unchanged cell is not read again; a collapsed one raises
    assert port._geometry_cell is cell
    with pytest.raises(RuntimeError, match="no finite positive volume"):
        port.build_lists(x, cell * 0.0)
