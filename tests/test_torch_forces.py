"""
The port's force modules against the JAX ones in float64 on the
128-atom rattled bcc W fixture of tests/test_fused_kernels.py: switched
pair short/tail forces, the trio twin (partials, and assembled forces
against trio_forces_unrolled and the Pallas kernel in interpret mode),
the 3-body virial from the trio partials, and the shared-gather
2+3-body evaluation.  Tolerance 1e-10 eV or eV/A: the same closed
forms on the same leg specs (the port's potential built through the
weights converter from the JAX package's bundles), summed in another
order.

The trio grid is the bench model's (symmetric in its first two axes)
and random non-symmetric grids made with numpy, one with the bench
model's zero pattern and one dense, so that a swap of the m/n lane
roles cannot pass unseen.  (The CUDA kernel is held against this twin
in tests/test_torch_kernels.py.)
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uf3_tpu.data.atoms import bulk
from uf3_tpu.ops import neighbors as jnb
from uf3_tpu.ops import pallas_trio as pt
from uf3_tpu.ops import potential as jpot
from uf3_tpu.regression import least_squares as ls
from uf3_tpu_torch.ops import neighbors as tnb
from uf3_tpu_torch.ops import pair as tpair
from uf3_tpu_torch.ops import trio as ttrio
from uf3_tpu_torch.ops.potential import UF3Potential, grid_sparsity

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of a thread per core oversubscribes them
torch.set_num_threads(1)

MODEL = os.path.join("benchmarks_data", "model_2and3.json")
TOL = 1e-10
SWITCH = (2.5, 3.5)


_block_compute = jax.jit(
    pt._trio_block_compute,
    static_argnames=("spec_l", "spec_n", "l_dim", "nc", "with_energy",
                     "active_bc", "window", "precision"))


_block_compute_virial = jax.jit(
    functools.partial(pt._trio_block_compute, with_energy=False,
                      with_virial=True),
    static_argnames=("spec_l", "spec_n", "l_dim", "nc", "active_bc",
                     "window", "precision"))


def _to_port(nbr) -> tnb.NeighborList:
    """A JAX NeighborList as the port's (int64 indices, torch tensors)."""
    def t(x, dtype=None):
        return None if x is None else torch.tensor(np.asarray(x),
                                                   dtype=dtype)
    return tnb.NeighborList(
        idx=t(nbr.idx, torch.int64), shift=t(nbr.shift),
        mask=t(nbr.mask), rev=t(nbr.rev, torch.int64),
        overflow=t(nbr.overflow), reference_positions=t(
            nbr.reference_positions), sel=t(nbr.sel, torch.int64))


@pytest.fixture(scope="module")
def setup():
    model = ls.WeightedLinearModel.from_json(MODEL)
    geom = bulk("W", "bcc", a=3.1652) * 4
    geom.rattle(0.05, seed=11)
    pos = jnp.asarray(geom.positions)
    cell = jnp.asarray(geom.cell)
    nbr2 = jnb.build_neighbor_list(pos, cell, geom.pbc, 5.5, 64,
                                   with_rev=False)
    nbr3 = jnb.filter_neighbor_list(nbr2, pos, cell, 3.5, 24)
    pot = converted(model)
    return dict(model=model, pos=pos, cell=cell, nbr2=nbr2, nbr3=nbr3,
                tpos=torch.tensor(geom.positions),
                tcell=torch.tensor(geom.cell), tnbr2=_to_port(nbr2),
                tnbr3=_to_port(nbr3), pot=pot)


def converted(model) -> UF3Potential:
    """The port's potential through the weights converter from the JAX
    package's own pair and trio bundles, so that both packages run the
    same leg specs.  (``UF3Potential.from_json`` evaluates the file's own
    knots, where the JAX package rebuilds them from the first knot gap:
    ROADMAP.md section 3; tests/test_torch_fit.py holds it to the host
    oracle.)"""
    params, _ = jpot.build_potential(model, dtype=jnp.float64)
    trio = pt.build_trio_pallas(model, dtype=jnp.float64)
    spec, coefficients = pt.build_pair_fast(model, dtype=jnp.float64)
    return UF3Potential.from_jax_arrays(
        trio._replace(grid=np.asarray(trio.grid)),
        (spec, np.asarray(coefficients)), np.asarray(params.offsets_1b),
        np.asarray(params.z_to_species), float(params.r_cut_2b),
        float(params.r_cut_3b))


def _with_grid(pot: UF3Potential, grid: np.ndarray) -> UF3Potential:
    active_bc, window, symmetric = grid_sparsity(grid)
    trio = pot.trio._replace(grid=grid, active_bc=active_bc, window=window,
                             symmetric=symmetric)
    return UF3Potential(pot.pair_spec, pot.pair_coefficients.numpy(), trio,
                        pot.offsets_1b.numpy(), pot.z_to_species.numpy(),
                        pot.r_cut_2b, pot.r_cut_3b)


def _grid(pot: UF3Potential, kind: str) -> UF3Potential:
    if kind == "bench":
        return pot
    rng = np.random.RandomState(17)
    grid = rng.normal(0.0, 0.05, pot.trio.grid.shape)
    if kind == "random_sparse":
        grid = grid * (pot.trio.grid != 0.0)
    assert not np.array_equal(grid, grid.transpose(1, 0, 2))
    return _with_grid(pot, grid)


def _close(a, b, tol=TOL):
    a = np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.allclose(a, b, atol=tol, rtol=0), np.abs(a - b).max()


@pytest.mark.parametrize("with_energy", [True, False])
def test_pair_short_and_tail(setup, with_energy):
    s = setup
    spec, coeff = pt.build_pair_fast(s["model"], dtype=jnp.float64)
    n_short = pt.basis_window_hi(spec, SWITCH[1])
    ej, fj, _ = pt.pair_short_forces(
        coeff, s["pos"], s["cell"], s["nbr3"], spec_pair=spec,
        n_basis_pair=n_short, with_energy=with_energy, r_lo=SWITCH[0],
        r_hi=SWITCH[1])
    pot = s["pot"]
    et, ft, d = tpair.pair_short_forces(
        pot.pair_coefficients, s["tpos"], s["tcell"], s["tnbr3"],
        spec_pair=pot.pair_spec, n_basis_pair=n_short,
        with_energy=with_energy, r_lo=SWITCH[0], r_hi=SWITCH[1])
    _close(ej, et)
    _close(fj, ft)
    assert d.shape == (128, 24, 3)
    ej, fj = pt.pair_tail_forces(
        coeff, s["pos"], s["cell"], s["nbr2"], spec_pair=spec,
        n_basis_pair=spec.n_basis, with_energy=with_energy,
        r_lo=SWITCH[0], r_hi=SWITCH[1])
    et, ft = tpair.pair_tail_forces(
        pot.pair_coefficients, s["tpos"], s["tcell"], s["tnbr2"],
        spec_pair=pot.pair_spec, n_basis_pair=pot.pair_spec.n_basis,
        with_energy=with_energy, r_lo=SWITCH[0], r_hi=SWITCH[1])
    _close(ej, et)
    _close(fj, ft)
    assert float(torch.abs(ft).max()) > 1e-2


@pytest.mark.parametrize("grid", ["bench", "random_sparse", "random_dense"])
def test_trio_partials_and_forces(setup, grid):
    s = setup
    pot = _grid(s["pot"], grid)
    tb = pot.trio
    g = jnp.asarray(tb.grid)
    kw = dict(spec_l=pt.LegSpec(*tb.spec_l), spec_n=pt.LegSpec(*tb.spec_n),
              l_basis=tb.l_basis, n_basis=tb.n_basis)
    nbr3 = s["nbr3"]
    # the per-atom partials against the JAX block body
    d = tnb.displacements(s["tpos"], s["tcell"], s["tnbr3"].idx,
                          s["tnbr3"].shift)
    valid = s["tnbr3"].mask.double()
    comps = tuple(jnp.asarray(d[..., c].numpy()) for c in range(3))
    for with_energy in (True, False):
        ej, fcj, s1j, s3j, v3j = _block_compute(
            comps, jnp.asarray(valid.numpy()), g, kw["spec_l"],
            kw["spec_n"], tb.l_basis, tb.n_basis, with_energy=with_energy,
            active_bc=tb.active_bc, window=tb.window,
            precision="highest")
        et, fct, part = ttrio.trio_partials(pot, d, valid, with_energy)
        _close(ej, et)
        _close(jnp.stack(fcj, -1), fct)
        _close(s1j, part[..., 0])
        _close(s3j, part[..., 1])
        _close(jnp.stack(v3j, -1), part[..., 2:5])
    # assembled per-atom energy and forces: against the engine's XLA
    # twin with the grid's sparsity (bench and sparse random grids), and
    # the Pallas kernel in interpret mode, which always runs the dense
    # grid (bench and dense random grids)
    et, ft = ttrio.trio_forces(pot, s["tpos"], s["tcell"], s["tnbr3"])
    assert float(torch.abs(ft).max()) > 1e-2
    if grid != "random_dense":
        eu, fu = pt.trio_forces_unrolled(
            g, s["pos"], s["cell"], nbr3.idx, nbr3.shift, nbr3.mask,
            nbr3.rev, block_atoms=64, active_bc=tb.active_bc,
            window=tb.window, **kw)
        _close(eu, et)
        _close(fu, ft)
    if grid != "random_sparse":
        ep, fp = pt.trio_forces_pallas(
            g, s["pos"], s["cell"], nbr3.idx, nbr3.shift, nbr3.mask,
            nbr3.rev, block_atoms=32, interpret=True, **kw)
        _close(ep, et)
        _close(fp, ft)


@pytest.mark.parametrize("grid", ["bench", "random_sparse"])
def test_trio_virial_from_partials(setup, grid):
    """``trio_virial6`` on the twin's slot partials against the JAX
    block body's virial (``_trio_virial6``), sign included, on the
    exchange-symmetric bench grid; on a grid without that symmetry the
    identity it rests on fails, and so does the JAX formula's premise:
    the two then differ."""
    s = setup
    pot = _grid(s["pot"], grid)
    tb = pot.trio
    d = tnb.displacements(s["tpos"], s["tcell"], s["tnbr3"].idx,
                          s["tnbr3"].shift)
    valid = s["tnbr3"].mask.double()
    comps = tuple(jnp.asarray(d[..., c].numpy()) for c in range(3))
    out = _block_compute_virial(
        comps, jnp.asarray(valid.numpy()), jnp.asarray(tb.grid),
        pt.LegSpec(*tb.spec_l), pt.LegSpec(*tb.spec_n), tb.l_basis,
        tb.n_basis, active_bc=tb.active_bc, window=tb.window,
        precision="highest")
    _, _, part = ttrio.trio_partials(pot, d, valid, with_energy=False)
    v6 = ttrio.trio_virial6(part, d, valid)
    assert float(torch.abs(v6).max()) > 1.0
    if grid == "bench":
        _close(out[5], v6)
    else:
        assert np.abs(np.asarray(out[5]) - v6.numpy()).max() > 1e-3


def test_pair_trio_shared(setup):
    s = setup
    spec, coeff = pt.build_pair_fast(s["model"], dtype=jnp.float64)
    tb = pt.build_trio_pallas(s["model"], dtype=jnp.float64)
    e2j, e3j, fj, _ = pt.pair_trio_forces_shared(
        coeff, tb.grid, s["pos"], s["cell"], s["nbr2"], s["nbr3"],
        spec_pair=spec, n_basis_pair=spec.n_basis, spec_l=tb.spec_l,
        spec_n=tb.spec_n, l_basis=tb.l_basis, n_basis=tb.n_basis,
        active_bc=tb.active_bc, window=tb.window)
    e2t, e3t, ft, vt = ttrio.pair_trio_forces_shared(
        s["pot"], s["tpos"], s["tcell"], s["tnbr2"], s["tnbr3"])
    assert vt is None
    _close(e2j, e2t)
    _close(e3j, e3t)
    _close(fj, ft)
