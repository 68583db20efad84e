"""
The trio CUDA kernel (uf3_tpu_torch/csrc/trio.cu) against its plain
torch twin, on the 3-body rows of a rattled 1,024-atom bcc W box, with
the bench grid and random non-symmetric grids (one with the bench
model's zero pattern, one dense), the unary test model's wider window,
K = 8 and 32 slots, a ragged atom count, sparse and non-prefix slot
masks and non-linear knot kinds: 1e-10 in float64 (summation order
only), 2e-4 eV/A in float32 against the float64 twin.  The 3-body virial
from the kernel's partials, on the bench lists (16 slots) and the
melting protocol's (20 slots): 1e-9 relative in float64, 1e-5 eV/A^3
per stress component in float32.  The kernel's center-weight operand
(the halo path's owner weight) with 0/1 and non-binary weights at the
same tolerances, a null weight bitwise equal to all-ones weights; on
the CPU, the plain version's weight: 0 clears a row, a weight scales it,
and the virial of weighted partials is the weighted per-center sum.

The multi-species trio kernel (uf3_tpu_torch/csrc/trio_multi.cu: one
launch over every ordered trio type) against its plain version
``trio_multi_partials_all_torch`` on random Ne/Xe (8 ordered types) and
Ne/Ar/Xe (27) 2+3-body models at K = 16 and 32 slots, a ragged atom
count, a sparse mask and centers with
no live type, and its rows by live rank (16, 17 and 18 live slots
scattered over 24 and 32, one, none, every count in one launch; centers
whose slots are all of one species): the same tolerances; one launch per
call and per force call of the route; no spills, float32 within 64
registers; bad operands and a type window too wide for shared memory
raise.  On the CPU: the packed per-type metadata
against each type's own tables, the plain version against the sum of
the per-type passes, and the build (a changed source or header rebuilds
the library, with a stand-in nvcc).

The neighbor-gather kernels (uf3_tpu_torch/csrc/gather.cu) against
their plain versions, bit for bit, in float32 and float64 with int32 and
int64 indices, with self-padded slots, counts that are no multiple of a
block, the transposed index and the column form of the reverse-slot
gather; on the engine's own 3-body list against the engine's gathers;
bad operands raise and an empty index launches nothing.

The fragment kernels (uf3_tpu_torch/csrc/fragments.cu) against their
plain versions in float32 and float64, at the TPU probes' shapes and at
ragged ones (counts that are no multiple of a block): ``relayout`` in
every mode and ``lane_map`` in every op bit for bit (NaN where the plain
version gives NaN; the copy from sources off a 16-byte boundary, on
counts of 4k + 1 .. 4k + 3), on the probes' draws mixed with zeros, infinities,
NaN, subnormals and one-hot indices outside [0, 9); ``lane_contract``
in every mode within 1e-6 (float32; 2e-15 in float64) of the sum of its
terms' magnitudes, and bit for bit where it rounds as its plain version
does; one launch per call; bad operands raise and an empty output
launches nothing.

The ``cuda`` tests skip without a GPU.  This file imports no jax, so it
also runs on a GPU host without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import copy
import glob
import os
import shutil
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from uf3_tpu_torch.benchmarks import kernel_variants, probe_mosaic
from uf3_tpu_torch.benchmarks.common import long_trio_model
from uf3_tpu_torch.data.atoms import bulk
from uf3_tpu_torch.forcefield.md import MDSystem
from uf3_tpu_torch.ops import _build, fragments, gather, multi
from uf3_tpu_torch.ops import neighbors as nb
from uf3_tpu_torch.ops import trio
from uf3_tpu_torch.ops.potential import (UF3Potential, grid_sparsity,
                                         type_sparsity)
from uf3_tpu_torch.ops.splines import horner_table, leg_spec_from_knots
from uf3_tpu_torch.representation import knots as kn

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of a thread per core oversubscribes them
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(REPO, "benchmarks_data", "model_2and3.json")
UNARY = os.path.join(REPO, "tests", "data", "model_unary.json")
TOLS = [(torch.float64, 1e-10), (torch.float32, 2e-4)]


@pytest.fixture(scope="module")
def rows():
    """(potential, 3-body rows d, valid, list cache, 3-body list), f64."""
    geom = bulk("W", "bcc", a=3.1652) * (8, 8, 8)
    geom.rattle(0.05, seed=11)
    system = MDSystem(MODEL, geom, dtype=torch.float64, rebuild_every=12,
                      skin=0.5, skin_2b=1.2, capacity_2b=72, capacity_3b=16,
                      n_respa=6, respa_mid=3, respa_switch=(2.5, 3.5),
                      device="cpu")
    state = system.init_state()
    cache = nb.list_cache(state.nbr3, system.cell, torch.float64)
    d = nb.cached_displacements(state.positions, state.nbr3, cache)
    return system.potential, d, cache.valid, cache, state.nbr3


def _with_grid(pot: UF3Potential, grid: np.ndarray,
               **specs) -> UF3Potential:
    """A new float64 CPU module of ``pot`` with ``grid`` (and the leg
    specs ``spec_l`` / ``spec_n`` where given)."""
    active_bc, window, symmetric = grid_sparsity(grid)
    bundle = pot.trio._replace(grid=grid, active_bc=active_bc,
                               window=window, symmetric=symmetric, **specs)
    return UF3Potential(pot.pair_spec, pot.pair_coefficients.numpy(),
                        bundle, pot.offsets_1b.numpy(),
                        pot.z_to_species.numpy(), pot.r_cut_2b,
                        pot.r_cut_3b)


def _grid(pot: UF3Potential, kind: str) -> UF3Potential:
    grid = pot.trio.grid
    if kind != "bench":
        grid = np.random.RandomState(17).normal(0.0, 0.05, grid.shape)
        if kind == "random_sparse":
            grid = grid * (pot.trio.grid != 0.0)
    out = _with_grid(pot, grid)
    assert out.trio.symmetric == (kind == "bench")
    return out


def _err(a, b) -> float:
    return float(torch.max(torch.abs(a.double().cpu() - b.double().cpu())))


def test_cpu_tensors_take_the_twin(rows):
    pot, d, valid, _, _ = rows
    launches = trio.trio_partials.launches
    out = trio.trio_partials(pot, d, valid)
    ref = trio.trio_partials_torch(d, valid, pot.grid, pot.trio)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert trio.trio_partials.launches == launches
    with pytest.raises(ValueError, match="no trio kernel"):
        trio.trio_partials(pot, d.to("meta"), valid.to("meta"))


def _weights(n_atoms, kind, dtype=torch.float64, device="cpu"):
    """Center weights: 0/1 (about half the rows, as on a halo mesh's
    local rows) or non-binary (0 on a third of the rows)."""
    rng = np.random.RandomState(7)
    w = rng.randint(0, 2, n_atoms).astype(float) if kind == "binary" \
        else rng.uniform(0.2, 1.7, n_atoms) * (rng.rand(n_atoms) > 1 / 3)
    return torch.as_tensor(w, dtype=dtype, device=device)


def test_twin_weight_zero_clears_a_row(rows):
    """The plain version's center weight: w = 0 zeroes a row's energy,
    center force and partials; w = 1 changes nothing."""
    pot, d, valid, _, _ = rows
    ref = trio.trio_partials_torch(d, valid, pot.grid, pot.trio)
    w = _weights(d.shape[0], "binary")
    out = trio.trio_partials(pot, d, valid, center_weight=w)
    off = w == 0
    assert 0 < int(off.sum()) < d.shape[0]
    for a, b in zip(out, ref):
        assert torch.all(a[off] == 0)
        assert torch.equal(a[~off], b[~off])
        assert float(torch.abs(b[off]).max()) > 0
    ones = trio.trio_partials(pot, d, valid,
                              center_weight=torch.ones(d.shape[0],
                                                       dtype=d.dtype))
    for a, b in zip(ones, ref):
        assert torch.equal(a, b)


def test_twin_weight_scales_a_row(rows):
    """A non-binary weight scales each row's energy, center force and
    partials, and the 3-body virial of weighted partials is the weighted
    sum of the per-center virials; weights w and 1 - w partition the
    unweighted energy, forces and virial (the halo path's psum)."""
    pot, d, valid, cache, nbr = rows
    ref = trio.trio_partials_torch(d, valid, pot.grid, pot.trio)
    w = _weights(d.shape[0], "scaled")
    out = trio.trio_partials_torch(d, valid, pot.grid, pot.trio,
                                   center_weight=w)
    shape = (-1, 1, 1)
    for a, b in zip(out, ref):
        assert torch.allclose(a, b * w.reshape(shape[:a.dim()]),
                              rtol=1e-14, atol=1e-14)
    v_w = trio.trio_virial6(out[2], d, valid)
    per_center = torch.stack([trio.trio_virial6(
        ref[2][i:i + 1], d[i:i + 1], valid[i:i + 1])
        for i in range(d.shape[0])])
    assert torch.allclose(v_w, torch.sum(w[:, None] * per_center, 0),
                          rtol=1e-10, atol=1e-10)
    rest = trio.trio_partials_torch(d, valid, pot.grid, pot.trio,
                                    center_weight=1.0 - w)
    f_all = trio.assemble_forces(*ref, d, cache.rev_flat, nbr.mask)[1]
    f_sum = sum(trio.assemble_forces(*o, d, cache.rev_flat, nbr.mask)[1]
                for o in (out, rest))
    assert torch.allclose(f_sum, f_all, atol=1e-10, rtol=0)
    assert torch.allclose(v_w + trio.trio_virial6(rest[2], d, valid),
                          trio.trio_virial6(ref[2], d, valid), atol=1e-10,
                          rtol=0)
    assert abs(float(out[0].sum() + rest[0].sum() - ref[0].sum())) < 1e-10


@pytest.fixture(scope="module")
def rows_one_tier():
    """(potential, d, valid) of the 3-body rows of the engine's default
    one-tier list (23 slots) on the same box, f64."""
    geom = bulk("W", "bcc", a=3.1652) * (8, 8, 8)
    geom.rattle(0.05, seed=11)
    system = MDSystem(MODEL, geom, dtype=torch.float64, device="cpu")
    state = system.init_state()
    cache = nb.list_cache(state.nbr3, system.cell, torch.float64)
    d = nb.cached_displacements(state.positions, state.nbr3, cache)
    return system.potential, d, cache.valid


def test_one_tier_default_list_has_23_slots(rows_one_tier):
    _, d, valid = rows_one_tier
    assert d.shape[1] == 23
    assert int(valid.sum(1).max()) <= 23 and int(valid.sum(1).min()) >= 12


# the melting protocol's engine settings (benchmarks/melting_run.py:105)
PROTOCOL = dict(rebuild_every=16, skin=0.6, skin_2b=1.2, capacity_2b=88,
                capacity_3b=20)


@pytest.fixture(scope="module")
def rows_protocol():
    """(potential, d, valid, volume) of the 3-body rows of the melting
    protocol's list (20 slots) on the same box, f64."""
    geom = bulk("W", "bcc", a=3.1652) * (8, 8, 8)
    geom.rattle(0.05, seed=11)
    system = MDSystem(MODEL, geom, dtype=torch.float64, device="cpu",
                      **PROTOCOL)
    state = system.init_state()
    cache = nb.list_cache(state.nbr3, system.cell, torch.float64)
    d = nb.cached_displacements(state.positions, state.nbr3, cache)
    return system.potential, d, cache.valid, geom.get_volume()


def test_protocol_list_has_20_slots(rows_protocol):
    _, d, valid, _ = rows_protocol
    assert d.shape[1] == 20
    assert int(valid.sum(1).max()) <= 20 and int(valid.sum(1).min()) >= 12


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the trio kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("grid", ["bench", "random_sparse", "random_dense"])
@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-10),
                                        (torch.float32, 2e-4)])
def test_trio_kernel_matches_twin(rows, cuda_device, grid, dtype, tol):
    pot64, d, valid, cache, nbr = rows
    pot64 = _grid(pot64, grid)
    pot = _with_grid(pot64, pot64.trio.grid).to(device=cuda_device,
                                                dtype=dtype)
    dk, vk = d.to(cuda_device, dtype), valid.to(cuda_device, dtype)
    rev, mask = cache.rev_flat.to(cuda_device), nbr.mask.to(cuda_device)
    launches = trio.trio_partials.launches
    for with_energy in (True, False):
        kernel = trio.trio_partials(pot, dk, vk, with_energy)
        torch.cuda.synchronize()
        twin = trio.trio_partials_torch(d, valid, pot64.grid, pot64.trio,
                                        with_energy)
        for a, b in zip(kernel, twin):
            assert a.shape == b.shape
            assert _err(a, b) <= tol
        f_k = trio.assemble_forces(*kernel, dk, rev, mask)[1]
        f_t = trio.assemble_forces(*twin, d, cache.rev_flat, nbr.mask)[1]
        assert _err(f_k, f_t) <= tol
        assert float(torch.abs(f_t).max()) > 1e-2
    assert trio.trio_partials.launches == launches + 2


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["binary", "scaled"])
@pytest.mark.parametrize("dtype, tol", TOLS)
def test_trio_kernel_center_weight(rows, cuda_device, kind, dtype, tol):
    """The kernel's center-weight operand against its plain version,
    with and without energy: 0/1 weights (a warp of weight 0 writes
    zeros and skips its row) and non-binary ones; a null weight gives
    bitwise the outputs of all-ones weights."""
    pot64, d, valid, cache, nbr = rows
    pot = _grid(pot64, "bench").to(device=cuda_device, dtype=dtype)
    dk, vk = d.to(cuda_device, dtype), valid.to(cuda_device, dtype)
    w = _weights(d.shape[0], kind)
    wk = w.to(cuda_device, dtype)
    rev, mask = cache.rev_flat.to(cuda_device), nbr.mask.to(cuda_device)
    for with_energy in (True, False):
        kernel = trio.trio_partials(pot, dk, vk, with_energy,
                                    center_weight=wk)
        twin = trio.trio_partials_torch(d, valid, pot64.grid, pot64.trio,
                                        with_energy, center_weight=w)
        for a, b in zip(kernel, twin):
            assert _err(a, b) <= tol
        off = (w == 0).to(cuda_device)
        for a in kernel:
            assert torch.all(a[off] == 0)
        f_k = trio.assemble_forces(*kernel, dk, rev, mask)[1]
        f_t = trio.assemble_forces(*twin, d, cache.rev_flat, nbr.mask)[1]
        assert _err(f_k, f_t) <= tol
        null = trio.trio_partials(pot, dk, vk, with_energy)
        ones = trio.trio_partials(pot, dk, vk, with_energy,
                                  center_weight=torch.ones_like(wk))
        for a, b in zip(null, ones):
            assert torch.equal(a, b)
    with pytest.raises(TypeError, match="center_weight"):
        trio.trio_partials(pot, dk, vk, center_weight=wk[:-1])


@pytest.mark.cuda
def test_trio_kernel_rejects_bad_operands(rows, cuda_device):
    pot64, d, valid, _, _ = rows
    pot = _grid(pot64, "bench").to(device=cuda_device, dtype=torch.float32)
    dk, vk = d.to(cuda_device), valid.to(cuda_device)
    with pytest.raises(TypeError, match="float32 or float64"):
        trio.trio_partials(pot, dk, vk)  # float64 rows, float32 grid
    wide = torch.zeros((4, 33, 3), device=cuda_device)
    with pytest.raises(ValueError, match="K <= 32"):
        trio.trio_partials(pot, wide, torch.zeros((4, 33),
                                                  device=cuda_device))


def _matches_twin(pot64: UF3Potential, d, valid, device, dtype, tol):
    """Kernel partials on ``device`` in ``dtype`` against the float64
    twin, with and without energy."""
    pot = _with_grid(pot64, pot64.trio.grid).to(device=device, dtype=dtype)
    dk, vk = d.to(device, dtype), valid.to(device, dtype)
    for with_energy in (True, False):
        kernel = trio.trio_partials(pot, dk, vk, with_energy)
        torch.cuda.synchronize()
        twin = trio.trio_partials_torch(d, valid, pot64.grid, pot64.trio,
                                        with_energy)
        for a, b in zip(kernel, twin):
            assert a.shape == b.shape
            assert _err(a, b) <= tol
    return twin


@pytest.mark.cuda
@pytest.mark.parametrize("k", [8, 32])
@pytest.mark.parametrize("dtype, tol", TOLS)
def test_trio_kernel_slot_counts(rows, cuda_device, k, dtype, tol):
    pot64, d, valid, _, _ = rows
    if k < d.shape[1]:
        d, valid = d[:, :k].contiguous(), valid[:, :k].contiguous()
    else:  # 16 more live slots: the rows' first 16, stretched by 10 %
        d = torch.cat([d, 1.1 * d[:, :k - d.shape[1]]], 1)
        valid = torch.cat([valid, valid[:, :k - valid.shape[1]]], 1)
    twin = _matches_twin(pot64, d, valid, cuda_device, dtype, tol)
    assert float(torch.abs(twin[2]).max()) > 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", TOLS)
def test_trio_kernel_ragged_atom_count(rows, cuda_device, dtype, tol):
    pot64, d, valid, _, _ = rows
    n = 1021  # not a multiple of the kernel's atoms per block
    _matches_twin(pot64, d[:n], valid[:n], cuda_device, dtype, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", TOLS)
def test_trio_kernel_sparse_masks(rows, cuda_device, dtype, tol):
    pot64, d, valid, _, _ = rows
    valid = valid.clone()
    valid[0] = 0                           # no valid slot
    valid[1] = 0
    valid[1, 5] = 1                        # one
    valid[2] = 0
    valid[2, [3, 11]] = 1                  # two, not a prefix
    rng = np.random.RandomState(5)
    valid[3:] *= torch.as_tensor(rng.rand(valid.shape[0] - 3,
                                          valid.shape[1]) > 0.3)
    twin = _matches_twin(pot64, d, valid, cuda_device, dtype, tol)
    assert float(torch.abs(twin[2][:2]).max()) == 0.0  # no pair lane


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", TOLS)
def test_trio_kernel_unary_model_window(rows, cuda_device, dtype, tol):
    _, d, valid, _, _ = rows
    pot64 = UF3Potential.from_json(UNARY)
    w_lo, w_hi, c_lo, c_hi = pot64.trio.window
    assert (w_hi - w_lo, c_hi - c_lo) == (5, 12)
    _matches_twin(pot64, d, valid, cuda_device, dtype, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["lammps", "geometric", "inverse"])
def test_trio_kernel_nonlinear_leg_kinds(rows, cuda_device, strategy):
    pot64, d, valid, _, _ = rows
    spacer = kn.get_knot_spacer(strategy)
    spec_l = leg_spec_from_knots(spacer(1.5, 3.5, 6))[1]
    spec_n = leg_spec_from_knots(spacer(1.5, 7.0, 12))[1]
    assert spec_l.n_basis == pot64.trio.l_basis
    assert spec_n.n_basis == pot64.trio.n_basis
    pot64 = _with_grid(pot64, pot64.trio.grid, spec_l=spec_l,
                       spec_n=spec_n)
    for dtype, tol in TOLS:
        _matches_twin(pot64, d, valid, cuda_device, dtype, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", TOLS)
def test_trio_kernel_one_tier_23_slots(rows_one_tier, cuda_device, dtype,
                                       tol):
    pot64, d, valid = rows_one_tier
    launches = trio.trio_partials.launches
    twin = _matches_twin(pot64, d, valid, cuda_device, dtype, tol)
    assert trio.trio_partials.launches == launches + 2
    assert float(torch.abs(twin[2]).max()) > 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("kw, n_steps", [({}, 1),
                                         (dict(n_respa=2, rebuild_every=2),
                                          2)],
                         ids=["plain_verlet_step", "respa2_outer_step"])
def test_md_step_on_the_card_matches_cpu(cuda_device, kw, n_steps):
    """One plain velocity-Verlet step (the minimum-image builder, the
    shared gather) and one 2-level outer step of two inner steps
    (trio_short_forces, the pair tail) on the 128-atom cell: the card
    against the CPU from the same inputs, float64."""
    geom = bulk("W", "bcc", a=3.1652) * 4
    geom.rattle(0.05, seed=3)
    v0 = np.random.RandomState(0).normal(0.0, 4e-3, (len(geom), 3))
    out = []
    for device in ("cpu", cuda_device):
        system = MDSystem(MODEL, geom, dtype=torch.float64, device=device,
                          **kw)
        launches = trio.trio_partials.launches
        state = system.run(system.init_state(velocities=v0),
                           n_steps=n_steps, dt_fs=2.0)
        if device != "cpu":
            assert trio.trio_partials.launches > launches
        out.append(state)
    cpu, card = out
    for name in ("positions", "velocities", "forces", "energy"):
        assert _err(getattr(cpu, name), getattr(card, name)) <= 1e-10
    assert float(torch.abs(cpu.forces).max()) > 1e-1


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 20])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_trio_virial_from_kernel_partials(rows, rows_protocol, cuda_device,
                                          k, dtype):
    """The 3-body virial from the kernel's slot partials against the
    twin's (``trio_virial6``, bench grid): 1e-9 relative in float64;
    in float32 each Voigt stress component within 1e-5 eV/A^3 of the
    float64 twin's."""
    if k == 16:
        pot64, d, valid, _, _ = rows
        volume = (8 * 3.1652) ** 3
    else:
        pot64, d, valid, volume = rows_protocol
    assert d.shape[1] == k
    _, _, part = trio.trio_partials_torch(d, valid, pot64.grid, pot64.trio,
                                          False)
    v_twin = trio.trio_virial6(part, d, valid)
    pot = _with_grid(pot64, pot64.trio.grid).to(device=cuda_device,
                                                dtype=dtype)
    dk, vk = d.to(cuda_device, dtype), valid.to(cuda_device, dtype)
    launches = trio.trio_partials.launches
    _, _, part_k = trio.trio_partials(pot, dk, vk, False)
    v_kernel = trio.trio_virial6(part_k, dk, vk).double().cpu()
    assert trio.trio_partials.launches == launches + 1
    assert float(torch.abs(v_twin).max()) > 1.0
    if dtype == torch.float64:
        assert _err(v_kernel, v_twin) <= 1e-9 * float(
            torch.abs(v_twin).max())
    else:
        assert _err(v_kernel / volume, v_twin / volume) <= 1e-5


# -- the triangle lanes (trio_triangle, the halo path) ----------------------
def _stretched(d, valid, k):
    """The rows cut to ``k`` slots, or widened to it with the first
    slots stretched by 10 % (more live slots)."""
    if k <= d.shape[1]:
        return d[:, :k].contiguous(), valid[:, :k].contiguous()
    extra = k - d.shape[1]
    return (torch.cat([d, 1.1 * d[:, :extra]], 1),
            torch.cat([valid, valid[:, :extra]], 1))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 8, 16, 23, 32])
@pytest.mark.parametrize("dtype, tol", TOLS)
def test_trio_kernel_triangle_matches_twin(rows, cuda_device, k, dtype, tol):
    """The kernel's triangle lanes against the plain triangle version,
    with and without energy and with center weights (1e-10 in float64,
    2e-4 eV/A in float32 against the float64 twin); in float64 against
    the kernel's full lanes on the same rows: energy and forces within
    1e-10, the virial from the partials within 1e-9."""
    pot64, d, valid, cache, nbr = rows
    d, valid = _stretched(d, valid, k)
    pot = _grid(pot64, "bench").to(device=cuda_device, dtype=dtype)
    dk, vk = d.to(cuda_device, dtype), valid.to(cuda_device, dtype)
    w = _weights(d.shape[0], "scaled")
    launches = trio.trio_partials.launches
    for with_energy in (True, False):
        for weight in (None, w):
            wk = None if weight is None else weight.to(cuda_device, dtype)
            kernel = trio.trio_partials(pot, dk, vk, with_energy,
                                        center_weight=wk, triangle=True)
            twin = trio.trio_partials_torch(d, valid, pot64.grid, pot64.trio,
                                            with_energy, weight,
                                            triangle=True)
            for a, b in zip(kernel, twin):
                assert a.shape == b.shape
                assert _err(a, b) <= tol
            if dtype != torch.float64 or weight is not None:
                continue
            full = trio.trio_partials(pot, dk, vk, with_energy)
            assert _err(kernel[0], full[0]) <= 1e-10
            if k == d.shape[1] and k == 16:  # the list's own reverse slots
                f_tri = trio.assemble_forces(*kernel, dk,
                                             cache.rev_flat.to(cuda_device),
                                             nbr.mask.to(cuda_device))[1]
                f_full = trio.assemble_forces(*full, dk,
                                              cache.rev_flat.to(cuda_device),
                                              nbr.mask.to(cuda_device))[1]
                assert _err(f_tri, f_full) <= 1e-10
            for a, b in zip(kernel[1:], full[1:]):
                assert _err(a, b) <= 1e-10
            v_tri = trio.trio_virial6(kernel[2], dk, vk)
            v_full = trio.trio_virial6(full[2], dk, vk)
            assert _err(v_tri, v_full) <= 1e-9
    assert trio.trio_partials.launches >= launches + 4
    assert float(torch.abs(twin[2]).max()) > 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", TOLS)
def test_trio_kernel_triangle_sparse_masks_and_ragged(rows, cuda_device,
                                                      dtype, tol):
    """Triangle lanes on rows with no, one and two (not a prefix) valid
    slots, a random sparse mask and a ragged atom count."""
    pot64, d, valid, _, _ = rows
    valid = valid.clone()
    valid[0] = 0
    valid[1] = 0
    valid[1, 5] = 1
    valid[2] = 0
    valid[2, [3, 11]] = 1
    rng = np.random.RandomState(5)
    valid[3:] *= torch.as_tensor(rng.rand(valid.shape[0] - 3,
                                          valid.shape[1]) > 0.3)
    n = 1021
    d, valid = d[:n], valid[:n]
    pot = _grid(pot64, "bench").to(device=cuda_device, dtype=dtype)
    dk, vk = d.to(cuda_device, dtype), valid.to(cuda_device, dtype)
    for with_energy in (True, False):
        kernel = trio.trio_partials(pot, dk, vk, with_energy, triangle=True)
        twin = trio.trio_partials_torch(d, valid, pot64.grid, pot64.trio,
                                        with_energy, triangle=True)
        for a, b in zip(kernel, twin):
            assert _err(a, b) <= tol
        assert float(torch.abs(kernel[2][:2]).max()) == 0.0


@pytest.mark.cuda
def test_trio_kernel_triangle_capacity_one_and_plan(rows, cuda_device):
    """At K = 1 the triangle falls back to full lanes (zero energy, finite
    forces); the launch plan of each layout holds no spills, and the
    triangle's counts its scratch (more shared bytes per block)."""
    pot64, d, valid, _, _ = rows
    pot = _grid(pot64, "bench").to(cuda_device)
    e, fc, part = trio.trio_partials(pot, d[:, :1].contiguous().to(
        cuda_device), valid[:, :1].contiguous().to(cuda_device), True,
        triangle=True)
    assert float(torch.abs(e).max()) == 0.0
    assert bool(torch.isfinite(fc).all() and torch.isfinite(part).all())
    for dtype in (torch.float64, torch.float32):
        p = pot.to(dtype=dtype)
        for k in (16, 23):
            for with_energy in (True, False):
                full = trio.trio_occupancy(p, k, with_energy)
                tri = trio.trio_occupancy(p, k, with_energy, triangle=True)
                assert full["local_bytes"] == 0 and tri["local_bytes"] == 0
                assert tri["smem_bytes"] > full["smem_bytes"]
                assert tri["blocks_per_sm"] >= 1


LIVE_COUNTS = [(16, 0), (16, 1), (16, 2), (16, 16),
               (32, 0), (32, 1), (32, 2), (32, 16), (32, 17)]


def _live_rows(d, valid, k, p, seed):
    """The rows widened to ``k`` slots (``_stretched``) with exactly ``p``
    live slots per atom, scattered at random places (holes between
    them, in any order)."""
    d, _ = _stretched(d, valid, k)
    rng = np.random.RandomState(seed)
    live = np.zeros((d.shape[0], k))
    for a in range(d.shape[0]):
        live[a, rng.permutation(k)[:p]] = 1.0
    return d.contiguous(), torch.as_tensor(live, dtype=d.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("k, p", LIVE_COUNTS,
                         ids=[f"K{k}-P{p}" for k, p in LIVE_COUNTS])
@pytest.mark.parametrize("triangle", [False, True],
                         ids=["full", "triangle"])
@pytest.mark.parametrize("dtype, tol", TOLS)
def test_trio_kernel_live_counts(rows, cuda_device, k, p, triangle, dtype,
                                 tol):
    """Rows by live rank: P = 0, 1, 2, 16 and 17 live slots scattered over
    16 or 32 (where the rows per warp and the threads per row change, and
    P = 17 takes a second pass of the 16-row H slice at KMAX = 32), with
    and without energy and center weights, against the plain version;
    the dead slots' partial rows are zeros."""
    pot64, d, valid, _, _ = rows
    n = 257
    d, live = _live_rows(d[:n], valid[:n], k, p, seed=31 * k + p)
    pot = _grid(pot64, "bench").to(device=cuda_device, dtype=dtype)
    dk, vk = d.to(cuda_device, dtype), live.to(cuda_device, dtype)
    w = _weights(n, "scaled")
    for with_energy in (True, False):
        for weight in (None, w):
            wk = None if weight is None else weight.to(cuda_device, dtype)
            kernel = trio.trio_partials(pot, dk, vk, with_energy,
                                        center_weight=wk, triangle=triangle)
            twin = trio.trio_partials_torch(d, live, pot64.grid, pot64.trio,
                                            with_energy, weight,
                                            triangle=triangle)
            for a, b in zip(kernel, twin):
                assert a.shape == b.shape
                assert _err(a, b) <= tol
            dead = (vk == 0)
            assert float(torch.abs(kernel[2][dead]).sum()) == 0.0
    if p >= 2:
        assert float(torch.abs(twin[2]).max()) > 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("triangle", [False, True],
                         ids=["full", "triangle"])
@pytest.mark.parametrize("dtype, tol", TOLS)
def test_trio_kernel_persistent_atom_counts(rows, cuda_device, triangle,
                                            dtype, tol):
    """Atom counts below one block (1, 5) and twice the persistent grid's
    warps plus 3 (each warp walks two or three atoms with its grid
    stride; the rows repeat the 1,024-atom box, so the plain version's
    outputs repeat too); zero atoms give empty outputs."""
    pot64, d, valid, _, _ = rows
    pot = _grid(pot64, "bench").to(device=cuda_device, dtype=dtype)
    plan = trio.trio_occupancy(pot, d.shape[1], False, triangle,
                               n_atoms=10 ** 6)
    warps = plan["grid"] * plan["atoms_per_block"]
    assert plan["grid"] == max(plan["blocks_per_sm"], 1) * plan["sms"]
    for n, grid in ((0, 0), (1, 1), (plan["atoms_per_block"] + 1, 2)):
        assert trio.trio_occupancy(pot, d.shape[1], False, triangle,
                                   n_atoms=n)["grid"] == grid
    twin = trio.trio_partials_torch(d, valid, pot64.grid, pot64.trio, True,
                                    triangle=triangle)
    for n in (1, 5, 2 * warps + 3):
        reps = -(-n // d.shape[0])
        dk = d.repeat(reps, 1, 1)[:n].to(cuda_device, dtype)
        vk = valid.repeat(reps, 1)[:n].to(cuda_device, dtype)
        kernel = trio.trio_partials(pot, dk, vk, True, triangle=triangle)
        for a, b in zip(kernel, twin):
            expect = b.repeat((reps,) + (1,) * (b.dim() - 1))[:n]
            assert a.shape == expect.shape
            assert _err(a, expect) <= tol
    empty = trio.trio_partials(pot, d[:0].to(cuda_device, dtype),
                               valid[:0].to(cuda_device, dtype), True,
                               triangle=triangle)
    torch.cuda.synchronize()
    assert [tuple(a.shape) for a in empty] == [(0,), (0, 3),
                                               (0, d.shape[1], 5)]


@pytest.fixture(scope="module")
def rows_separate():
    """(potential, d, valid, list cache, 3-body list) of the separately
    built 32-slot 3-body list of the same box, f64."""
    geom = bulk("W", "bcc", a=3.1652) * (8, 8, 8)
    geom.rattle(0.05, seed=11)
    system = MDSystem(long_trio_model(), geom, dtype=torch.float64,
                      device="cpu", capacity_3b=32)
    state = system.init_state()
    cache = nb.list_cache(state.nbr3, system.cell, torch.float64)
    d = nb.cached_displacements(state.positions, state.nbr3, cache)
    return system.potential, d, cache.valid, cache, state.nbr3


def test_separate_list_has_32_slots_and_reverse_slots(rows_separate):
    _, d, valid, _, nbr = rows_separate
    assert d.shape[1] == 32 and nbr.sel is None
    assert int(valid.sum(1).max()) <= 32 and int(valid.sum(1).min()) >= 14
    idx, rev, mask = nbr.idx.numpy(), nbr.rev.numpy(), nbr.mask.numpy()
    a, s = np.nonzero(mask)
    assert np.array_equal(idx[idx[a, s], rev[a, s]], a)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", TOLS)
def test_trio_kernel_on_a_separately_built_list(rows_separate, cuda_device,
                                                dtype, tol):
    """The KMAX = 32 instance on a list that did not come from the
    filter, its reverse slots from the builder: partials and assembled
    forces against the twin's."""
    pot64, d, valid, cache, nbr = rows_separate
    twin = _matches_twin(pot64, d, valid, cuda_device, dtype, tol)
    pot = _with_grid(pot64, pot64.trio.grid).to(device=cuda_device,
                                                dtype=dtype)
    dk, vk = d.to(cuda_device, dtype), valid.to(cuda_device, dtype)
    out = trio.trio_partials(pot, dk, vk, False)
    rev, mask = cache.rev_flat.to(cuda_device), nbr.mask.to(cuda_device)
    f_kernel = trio.assemble_forces(*out, dk, rev, mask)[1]
    f_twin = trio.assemble_forces(*twin, d, cache.rev_flat, nbr.mask)[1]
    assert _err(f_kernel, f_twin) <= tol
    assert float(torch.abs(f_twin).max()) > 1e-1


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["separate_3body", "model_2", "binary"])
def test_factorized_and_separate_steps_on_the_card_match_cpu(cuda_device,
                                                             model):
    """Two plain velocity-Verlet steps on the card against the CPU,
    float64: the separate route (trio kernel) of the model whose 3-body
    cutoff passes its 2-body cutoff, and the factorized path of the
    2-body W and the binary Ne/Xe model files."""
    if model == "binary":
        from uf3_tpu_torch.data.atoms import Atoms
        base = bulk("Ne", "fcc", a=5.4) * 3
        numbers = base.get_atomic_numbers()
        numbers[np.random.RandomState(3).rand(len(numbers)) > 0.5] = 54
        geom = Atoms(numbers, base.get_positions(), base.get_cell(),
                     pbc=True)
        source = os.path.join(REPO, "tests", "data", "model_binary.json")
    else:
        geom = bulk("W", "bcc", a=3.1652) * 4
        source = long_trio_model() if model == "separate_3body" \
            else os.path.join(REPO, "benchmarks_data", "model_2.json")
    geom.rattle(0.05, seed=3)
    v0 = np.random.RandomState(0).normal(0.0, 4e-3, (len(geom), 3))
    out = []
    for device in ("cpu", cuda_device):
        system = MDSystem(source, geom, dtype=torch.float64, device=device,
                          capacity_3b=32)
        launches = trio.trio_partials.launches
        state = system.run(system.init_state(velocities=v0), n_steps=2,
                           dt_fs=2.0)
        if device != "cpu":
            assert (trio.trio_partials.launches > launches) \
                == (model == "separate_3body")
        out.append(state)
    cpu, card = out
    for name in ("positions", "velocities", "forces", "energy"):
        assert _err(getattr(cpu, name), getattr(card, name)) <= 1e-10
    assert float(torch.abs(cpu.forces).max()) > 1e-2


# -- the multi-species kernel (the fused multi-species route) -----------------
def species_model(elements):
    """A random 2+3-body model over ``elements``, r 1.0-5.0 A, resolution
    8, coefficients from RandomState(11) at scale 0.05: for Ne/Xe the
    model of the JAX package's test_multi_fused_matches_factorized (8
    ordered trio types), for Ne/Ar/Xe a ternary one (27)."""
    from uf3_tpu_torch import io
    from uf3_tpu_torch.data.composition import ChemicalSystem
    from uf3_tpu_torch.representation.basis import BSplineBasis
    basis = BSplineBasis(ChemicalSystem(elements, degree=3),
                         r_min_map=1.0, r_max_map=5.0, resolution_map=8)
    return io.FittedModel(basis, np.random.RandomState(11).normal(
        scale=0.05, size=sum(basis.partition_sizes)))


def _species_rows(elements, numbers_of, k):
    """(potential, d, valid, s_slot, species, list cache, 3-body list)
    of the 3-body rows of rattled (0.08 A) fcc with species
    ``numbers_of(n_sites)`` on the multi-species route, f64: a = 5.8 A
    (256 atoms) keeps 12-16 neighbors in 16 slots, a = 5.4 A (500) 18 in
    32."""
    from uf3_tpu_torch.data.atoms import Atoms
    a, reps = (5.8, 4) if k == 16 else (5.4, 5)
    base = bulk("Ne", "fcc", a=a) * reps
    numbers = numbers_of(len(base))
    geom = Atoms(numbers, base.get_positions(), base.get_cell(), pbc=True)
    geom.rattle(0.08, seed=1)
    system = MDSystem(species_model(elements), geom, dtype=torch.float64,
                      device="cpu", capacity_3b=k)
    state = system.init_state()
    assert not system.overflowed(state)
    _, cache = system.list_caches(state.nbr2, state.nbr3, system.cell)
    d = nb.cached_displacements(state.positions, state.nbr3, cache)
    return (system.potential, d, cache.valid, cache.s_slot, system.species,
            cache, state.nbr3)


def _half_xe(n):
    """Ne with half the sites Xe by a seeded draw."""
    numbers = np.full(n, 10)
    numbers[np.random.RandomState(3).rand(n) > 0.5] = 54
    return numbers


@pytest.fixture(scope="module", params=[16, 32], ids=["K16", "K32"])
def rows_multi(request):
    """Ne/Xe rows (half Xe by a seeded draw), as ``_species_rows``."""
    return _species_rows(["Ne", "Xe"], _half_xe, request.param)


@pytest.fixture(scope="module", params=[16, 32], ids=["K16", "K32"])
def rows_ternary(request):
    """Ne/Ar/Xe rows (species by a seeded draw), as ``_species_rows``."""
    def numbers_of(n):
        return np.array([10, 18, 54])[np.random.RandomState(5).randint(3,
                                                                       size=n)]
    return _species_rows(["Ne", "Ar", "Xe"], numbers_of, request.param)


def test_multi_rows_cover_both_instances(rows_multi):
    """K = 16 and 32 (the two KMAX instances); each type's center
    species is absent from some rows, and each type has live rows."""
    pot, d, valid, s_slot, species, _, _ = rows_multi
    assert d.shape[1] in (16, 32)
    assert len(pot.trio_multi.descs) == 8 and pot.trio_multi_mirrored
    for desc in pot.trio_multi.descs:
        rows = species == desc.s_c
        assert 0 < int(rows.sum()) < len(species)
        assert bool(((s_slot == desc.s_m) & (valid != 0))[rows].any())


def test_ternary_rows_cover_27_types(rows_ternary):
    """The ternary rows: 27 mirrored ordered types, each with centers of
    its species whose rows hold slots of its s_m and of its s_n."""
    pot, d, valid, s_slot, species, _, _ = rows_ternary
    assert d.shape[1] in (16, 32) and pot.trio_multi_plan[0] == 3
    assert len(pot.trio_multi.descs) == 27 and pot.trio_multi_mirrored
    for desc in pot.trio_multi.descs:
        rows = species == desc.s_c
        assert 0 < int(rows.sum()) < len(species)
        for s in (desc.s_m, desc.s_n):
            assert bool(((s_slot == s) & (valid != 0))[rows].any())


def test_cpu_tensors_take_the_gated_twin(rows_multi):
    """On the CPU the multi-species pass is its plain version (the
    species-gated pass of each ordered type, summed), and the kernel's
    entry point raises rather than fall back."""
    pot, d, valid, s_slot, species, _, _ = rows_multi
    launches = multi.trio_multi_partials_all.launches
    out = multi.trio_multi_partials_all(pot, d, valid, s_slot, species)
    ref = multi.trio_multi_partials_all_torch(pot, d, valid, s_slot,
                                              species)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    total = [torch.zeros_like(x) for x in ref]
    for desc, tables in zip(pot.trio_multi.descs, pot.trio_types):
        x = multi.trio_multi_partials_torch(d, valid, s_slot, species,
                                            tables.grid, desc)
        total = [a + b for a, b in zip(total, x)]
    for a, b in zip(total, ref):
        assert _err(a, b) <= 1e-14
    assert float(torch.abs(ref[2]).max()) > 1e-2
    assert multi.trio_multi_partials_all.launches == launches
    with pytest.raises(ValueError, match="no trio kernel"):
        multi.launch_trio_multi(pot, d, valid, s_slot, species)


def _unpack(pot, t):
    """Ordered type t as the kernel reads it from ``pot.trio_packed``:
    its three legs' Horner rows, grid window, window, record and
    reals."""
    pack = pot.trio_packed
    s = pot.trio_multi_plan[0]
    rec = pack.ints.numpy()[s ** 3 + multi.PACK_RECORD * t:][
        :multi.PACK_RECORD]
    tables = pack.tables.numpy()
    legs = [tables[rec[3 * j + 2]:rec[3 * j + 2] + 20 * rec[3 * j + 1]]
            .reshape(-1, 20) for j in range(3)]
    l_lo, lw, b_lo, bw, c_lo, cw, g_off = (int(x) for x in rec[9:])
    grid = pack.grids.numpy()[g_off:g_off + lw * bw * cw].reshape(lw, bw,
                                                                  cw)
    window = (l_lo, l_lo + lw, b_lo, b_lo + bw, c_lo, c_lo + cw)
    reals = pack.reals.numpy()[multi.PACK_REALS * t:][:multi.PACK_REALS]
    return legs, grid, window, rec, reals


@pytest.mark.parametrize("elements", [["Ne", "Xe"], ["Ne", "Ar", "Xe"]],
                         ids=["binary", "ternary"])
def test_packed_metadata_reproduces_each_type(elements):
    """Per ordered type, its Horner rows, grid window and window read
    back from the packed buffers equal its legs' own Horner tables, its
    grid's live window and its desc exactly;
    type_of names each type once (a full model leaves no -1); each
    distinct leg table is stored once; every buffer is a whole number of
    16-byte copies."""
    pot = UF3Potential.from_model(species_model(elements))
    descs = pot.trio_multi.descs
    s, max_cols = pot.trio_multi_plan
    assert s == len(elements) and len(descs) == s ** 3
    type_of = pot.trio_packed.ints.numpy()[:s ** 3].reshape(s, s, s)
    assert sorted(type_of.ravel().tolist()) == list(range(len(descs)))
    for t, desc in enumerate(descs):
        assert type_of[desc.s_c, desc.s_m, desc.s_n] == t
        legs, grid, window, rec, reals = _unpack(pot, t)
        specs = (desc.spec_l1, desc.spec_l2, desc.spec_n)
        for leg, spec in zip(legs, specs):
            assert np.array_equal(leg, horner_table(spec))
        l_lo, l_hi, b_lo, b_hi, c_lo, c_hi = desc.window
        assert np.array_equal(grid, pot.trio_multi.grids[t][
            l_lo:l_hi, b_lo:b_hi, c_lo:c_hi])
        assert window == desc.window
        for j, spec in enumerate(specs):
            assert (rec[3 * j], rec[3 * j + 1]) == (spec.kind, spec.n_int)
            assert np.array_equal(reals[4 * j:4 * j + 4],
                                  [spec.u0, 1.0 / spec.h, spec.t_min,
                                   spec.t_max])
    distinct = {sp for d in descs for sp in (d.spec_l1, d.spec_l2, d.spec_n)}
    n_tab = sum(20 * sp.n_int for sp in distinct)
    assert pot.trio_packed.tables.numel() == n_tab + (-n_tab) % 4
    assert max_cols == max((d.window[3] - d.window[2])
                           * (d.window[5] - d.window[4]) for d in descs)
    for buffer in pot.trio_packed.buffers():
        assert buffer.numel() % 4 == 0 and buffer.is_contiguous()
    assert pot.trio_packed.ints.dtype == torch.int32
    f32 = copy.deepcopy(pot).to(dtype=torch.float32)
    assert f32.trio_packed.ints.dtype == torch.int32
    assert f32.trio_packed.reals.dtype == torch.float32


def _with_types(pot, keep):
    """``pot``'s multi-species route (float64, CPU) with only the ordered
    types whose desc passes ``keep``."""
    tm = pot.trio_multi
    kept = [t for t, desc in enumerate(tm.descs) if keep(desc)]
    return UF3Potential(
        None, None, None, pot.offsets_1b.numpy(), pot.z_to_species.numpy(),
        pot.r_cut_2b, pot.r_cut_3b,
        trio_multi=multi.TrioMulti(descs=tuple(tm.descs[t] for t in kept),
                                   grids=tuple(tm.grids[t] for t in kept)),
        pair_multi=pot.pair_multi)


def test_packed_metadata_marks_missing_types(rows_multi):
    """A model without the types of one center species: type_of is -1
    exactly there, and the plain version leaves those centers' outputs
    zero and the others' as with every type.  Packing a type twice or a
    species outside [0, S) raises."""
    pot, d, valid, s_slot, species, _, _ = rows_multi
    sub = _with_types(pot, lambda desc: desc.s_c == 0)
    type_of = sub.trio_packed.ints.numpy()[:8].reshape(2, 2, 2)
    assert (type_of[1] == -1).all()
    assert sorted(type_of[0].ravel().tolist()) == [0, 1, 2, 3]
    out = multi.trio_multi_partials_all(sub, d, valid, s_slot, species)
    ref = multi.trio_multi_partials_all(pot, d, valid, s_slot, species)
    none = species == 1
    for a, b in zip(out, ref):
        assert float(torch.abs(a[none]).max()) == 0.0
        assert _err(a[~none], b[~none]) <= 1e-14
    descs, grids = pot.trio_multi.descs, pot.trio_multi.grids
    with pytest.raises(ValueError, match="given twice"):
        multi.pack_trio_multi(descs + descs[:1], grids + grids[:1], 2)
    with pytest.raises(ValueError, match="species outside"):
        multi.pack_trio_multi(descs, grids, 1)


def _multi_matches_plain(pot64, rows, cuda_device, dtype, tol,
                         cache=None, nbr=None):
    """One launch of the multi-species kernel per call against its plain
    version on the CPU rows ``rows`` = (d, valid, s_slot, species), with
    and without energy: every output, and with the list cache and 3-body
    list the assembled forces and (float64) the virial from the
    partials."""
    d, valid, s_slot, species = rows
    pot = copy.deepcopy(pot64).to(device=cuda_device, dtype=dtype)
    dk, vk = d.to(cuda_device, dtype), valid.to(cuda_device, dtype)
    sk, ck = s_slot.to(cuda_device), species.to(cuda_device)
    for with_energy in (True, False):
        launches = multi.trio_multi_partials_all.launches
        kernel = multi.trio_multi_partials_all(pot, dk, vk, sk, ck,
                                               with_energy)
        torch.cuda.synchronize()
        assert multi.trio_multi_partials_all.launches == launches + 1
        plain = multi.trio_multi_partials_all_torch(pot64, d, valid, s_slot,
                                                    species, with_energy)
        for a, b in zip(kernel, plain):
            assert a.shape == b.shape
            assert _err(a, b) <= tol
        if cache is None:
            continue
        rev, mask = cache.rev_flat.to(cuda_device), nbr.mask.to(cuda_device)
        f_k = trio.assemble_forces(*kernel, dk, rev, mask)[1]
        f_p = trio.assemble_forces(*plain, d, cache.rev_flat, nbr.mask)[1]
        assert _err(f_k, f_p) <= tol
        assert float(torch.abs(f_p).max()) > 1e-2
        if dtype == torch.float64:
            v_k = trio.trio_virial6(kernel[2], dk, vk).cpu()
            v_p = trio.trio_virial6(plain[2], d, valid)
            assert _err(v_k, v_p) <= 1e-9 * float(torch.abs(v_p).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", TOLS)
def test_multi_kernel_matches_plain(rows_multi, cuda_device, dtype, tol):
    """Binary Ne/Xe, K = 16 and 32: the kernel against its plain version
    (every output, the assembled forces, the f64 virial), one launch per
    call."""
    pot64, d, valid, s_slot, species, cache, nbr = rows_multi
    _multi_matches_plain(pot64, (d, valid, s_slot, species), cuda_device,
                         dtype, tol, cache, nbr)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", TOLS)
def test_multi_kernel_matches_plain_ternary(rows_ternary, cuda_device, dtype,
                                            tol):
    """Ternary Ne/Ar/Xe (27 ordered types), K = 16 and 32."""
    pot64, d, valid, s_slot, species, cache, nbr = rows_ternary
    _multi_matches_plain(pot64, (d, valid, s_slot, species), cuda_device,
                         dtype, tol, cache=cache, nbr=nbr)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", TOLS)
def test_multi_kernel_ragged_and_sparse(rows_ternary, cuda_device, dtype,
                                        tol):
    """A ragged atom count (37 atoms: the last block part empty) and a
    sparse, non-prefix slot mask."""
    pot64, d, valid, s_slot, species, _, _ = rows_ternary
    n = 37
    _multi_matches_plain(pot64, (d[:n], valid[:n], s_slot[:n], species[:n]),
                         cuda_device, dtype, tol)
    keep = torch.tensor(np.random.RandomState(4).rand(*valid.shape) > 0.4)
    sparse = valid * keep.to(valid.dtype)
    sparse[:, 0] = 0.0
    assert 0 < float(sparse.sum()) < 0.7 * float(valid.sum())
    _multi_matches_plain(pot64, (d, sparse, s_slot, species), cuda_device,
                         dtype, tol)


@pytest.mark.cuda
def test_multi_kernel_center_without_live_type(rows_multi, cuda_device):
    """Centers of a species the model has no type for, and a center
    whose slots are all masked: zero outputs, the rest as the plain
    version (f64, 1e-10)."""
    pot64, d, valid, s_slot, species, _, _ = rows_multi
    sub = _with_types(pot64, lambda desc: desc.s_c == 0)
    empty = valid.clone()
    first0 = int(torch.nonzero(species == 0)[0])
    empty[first0] = 0.0
    _multi_matches_plain(sub, (d, empty, s_slot, species), cuda_device,
                         torch.float64, 1e-10)
    pot = copy.deepcopy(sub).to(device=cuda_device)
    out = multi.launch_trio_multi(pot, d.to(cuda_device),
                                  empty.to(cuda_device),
                                  s_slot.to(cuda_device),
                                  species.to(cuda_device))
    none = (species == 1).to(cuda_device)
    none[first0] = True
    for x in out:
        assert float(torch.abs(x[none]).max()) == 0.0
        assert float(torch.abs(x[~none]).max()) > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", TOLS)
def test_multi_kernel_dense_windows(rows_multi, cuda_device, dtype, tol):
    """Dense random grids (every type's window its whole grid, 8 x 8 x 13
    here): in float64 at K = 32 the warps' slices leave no room, so the
    tables and grids are read from device memory; in float32 at K = 16
    they are staged.  Both against the plain version."""
    pot64, d, valid, s_slot, species, _, _ = rows_multi
    rng = np.random.RandomState(8)
    descs, grids = [], []
    for desc, grid in zip(pot64.trio_multi.descs, pot64.trio_multi.grids):
        dense = rng.normal(0.0, 0.05, grid.shape)
        active_bc, window = type_sparsity(dense)
        descs.append(desc._replace(window=window, active_bc=active_bc))
        grids.append(dense)
    dense_pot = UF3Potential(
        None, None, None, pot64.offsets_1b.numpy(),
        pot64.z_to_species.numpy(), pot64.r_cut_2b, pot64.r_cut_3b,
        trio_multi=multi.TrioMulti(descs=tuple(descs), grids=tuple(grids)),
        pair_multi=pot64.pair_multi)
    k = d.shape[1]
    plan = multi.trio_multi_occupancy(dense_pot, k,
                                      dtype == torch.float64)
    assert plan["local_bytes"] == 0
    if dtype == torch.float64 and k == 32:
        assert not plan["grids_staged"]
    if dtype == torch.float32 and k == 16:
        assert plan["tables_staged"] and plan["grids_staged"]
    _multi_matches_plain(dense_pot, (d, valid, s_slot, species), cuda_device,
                         dtype, tol)


@pytest.mark.cuda
def test_multi_kernel_rejects_bad_operands(rows_multi, cuda_device):
    """float64 rows on a float32 potential and int32 species ids raise
    TypeError; 33 slots and a type window too wide for one warp's shared
    memory raise ValueError."""
    pot64, d, valid, s_slot, species, _, _ = rows_multi
    pot32 = copy.deepcopy(pot64).to(device=cuda_device, dtype=torch.float32)
    dk, vk = d.to(cuda_device), valid.to(cuda_device)
    sk, ck = s_slot.to(cuda_device), species.to(cuda_device)
    with pytest.raises(TypeError, match="float32 or float64"):
        multi.launch_trio_multi(pot32, dk, vk, sk, ck)
    pot = copy.deepcopy(pot64).to(device=cuda_device)
    with pytest.raises(TypeError, match="int64"):
        multi.launch_trio_multi(pot, dk, vk, sk.int(), ck)
    wide_k = torch.zeros((4, 33, 3), dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError, match="K <= 32"):
        multi.launch_trio_multi(
            pot, wide_k, wide_k[..., 0],
            torch.zeros((4, 33), dtype=torch.int64, device=cuda_device),
            ck[:4])
    spec = leg_spec_from_knots(kn.generate_uniform_knots(0.5, 6.0, 40))[1]
    desc = pot64.trio_multi.descs[0]._replace(
        spec_l1=spec, spec_l2=spec, spec_n=spec, s_c=0, s_m=0, s_n=0,
        window=(0, 43, 0, 43, 0, 43), active_bc=())
    wide = UF3Potential(
        None, None, None, pot64.offsets_1b.numpy(),
        pot64.z_to_species.numpy(), pot64.r_cut_2b, pot64.r_cut_3b,
        trio_multi=multi.TrioMulti(descs=(desc,),
                                   grids=(np.zeros((43, 43, 43)),)),
        pair_multi=pot64.pair_multi).to(device=cuda_device)
    with pytest.raises(ValueError, match="exceeds the 227 KB"):
        multi.trio_multi_occupancy(wide, d.shape[1], True)
    with pytest.raises(ValueError, match="exceeds the 227 KB"):
        multi.launch_trio_multi(wide, dk, vk, sk, ck)


@pytest.mark.cuda
def test_multi_kernel_plans_have_no_spills(rows_multi, rows_ternary,
                                           cuda_device):
    """Every instance (f32 / f64, KMAX = 16 / 32, energy or not) on the
    binary and ternary packs: no local (spill) memory, at least one warp
    per block and one block per SM, tables and grids in shared memory."""
    for pot in (rows_multi[0], rows_ternary[0]):
        for is_f64 in (False, True):
            for k in (16, 32):
                for with_energy in (False, True):
                    plan = multi.trio_multi_occupancy(pot, k, is_f64,
                                                      with_energy)
                    assert plan["local_bytes"] == 0, plan
                    assert plan["atoms_per_block"] >= 1, plan
                    assert plan["blocks_per_sm"] >= 1, plan
                    assert plan["tables_staged"] and plan["grids_staged"]


# rows of exactly P live slots on K (one rank sub-pass of the 16-row H up
# to P = 16, two past it; the route's lists hold 18), one and none, and a
# count per atom from 0 to 18 in turn ("mixed")
MULTI_LIVE = [(24, 16), (24, 17), (24, 18), (32, 16), (32, 17), (32, 18),
              (24, 1), (32, 0), (32, "mixed")]


@pytest.fixture(scope="module")
def rows_multi_wide():
    """Ne/Xe rows with 18 live slots in 32 (``_species_rows``)."""
    return _species_rows(["Ne", "Xe"], _half_xe, 32)


def _multi_live_rows(rows, k, p, seed, n=257):
    """The first ``n`` atoms' rows on ``k`` slots with ``p`` live slots an
    atom (atom a: a mod 19 for "mixed"), each drawn at random from the
    atom's live slots and their copies stretched by 10 %, put at a
    random place (in any order); the other slots hold rows of other
    slots, species at random, masked.
    Returns (d, valid, s_slot, species, reverse slots of the partials,
    mask): the reverse slots are drawn at random, which the assembly
    takes as it takes any."""
    _, d, valid, s_slot, species = rows[:5]
    rng = np.random.RandomState(seed)
    d0, v0, s0 = d[:n].numpy(), valid[:n].numpy(), s_slot[:n].numpy()
    nd = np.zeros((n, k, 3))
    nv = np.zeros((n, k))
    ns = rng.randint(0, 2, size=(n, k))
    for a in range(n):
        count = a % 19 if p == "mixed" else p
        live = np.flatnonzero(v0[a])
        pool = np.concatenate([d0[a, live], 1.1 * d0[a, live]])
        pool_s = np.concatenate([s0[a, live], s0[a, live]])
        assert len(pool) >= count
        take = rng.permutation(len(pool))[:count]
        at = rng.permutation(k)[:count]
        nd[a] = d0[a][rng.randint(0, d0.shape[1], size=k)]
        nd[a, at] = pool[take]
        nv[a, at] = 1.0
        ns[a, at] = pool_s[take]
    rev = torch.as_tensor(rng.randint(0, n * k, size=(n, k)))
    return (torch.as_tensor(nd), torch.as_tensor(nv), torch.as_tensor(ns),
            species[:n], rev, torch.as_tensor(nv > 0))


@pytest.mark.cuda
@pytest.mark.parametrize("k, p", MULTI_LIVE,
                         ids=[f"K{k}-P{p}" for k, p in MULTI_LIVE])
@pytest.mark.parametrize("dtype, tol", TOLS)
def test_multi_kernel_live_counts(rows_multi_wide, cuda_device, k, p, dtype,
                                  tol):
    """The multi-species kernel's rows by live rank: P = 16, 17 and 18
    live slots scattered over 24 or 32 (one and two rank sub-passes), one
    live slot, none, and every count from 0 to 18 in one launch, on 257
    atoms (a ragged last block), with and without energy: every output
    and the assembled forces against the plain version; dead slots'
    partial rows are zeros."""
    pot64 = rows_multi_wide[0]
    d, live, s_slot, species, rev, mask = _multi_live_rows(
        rows_multi_wide, k, p, seed=k + (19 if p == "mixed" else p))
    nbr = cache = None
    if p not in (0, 1):
        cache, nbr = SimpleNamespace(rev_flat=rev), SimpleNamespace(mask=mask)
    _multi_matches_plain(pot64, (d, live, s_slot, species), cuda_device,
                         dtype, tol, cache, nbr)
    pot = copy.deepcopy(pot64).to(device=cuda_device, dtype=dtype)
    part = multi.trio_multi_partials_all(
        pot, d.to(cuda_device, dtype), live.to(cuda_device, dtype),
        s_slot.to(cuda_device), species.to(cuda_device))[2]
    assert float(torch.abs(part[(live == 0).to(cuda_device)]).sum()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", TOLS)
def test_multi_kernel_single_species_rows(rows_multi_wide, cuda_device,
                                          dtype, tol):
    """Centers whose slots are all of one species (every other atom's all
    Ne, every fourth one's all Xe), so that one species pass of theirs
    has no partner, beside the others' mixed rows: against the plain
    version, with the assembled forces."""
    pot64, d, valid, s_slot, species, cache, nbr = rows_multi_wide
    one = s_slot.clone()
    one[::2] = 0
    one[1::4] = 1
    _multi_matches_plain(pot64, (d, valid, one, species), cuda_device,
                         dtype, tol, cache, nbr)


@pytest.mark.cuda
def test_multi_kernel_plans_hold_the_register_bounds(rows_multi_wide,
                                                     rows_ternary,
                                                     cuda_device):
    """Every instance on the binary and ternary packs: no local (spill)
    memory; float32 at most 64 registers and 32 warps per SM; the plans
    are printed (pytest -s)."""
    for pot in (rows_multi_wide[0], rows_ternary[0]):
        for is_f64 in (False, True):
            for k in (16, 32):
                for with_energy in (False, True):
                    plan = multi.trio_multi_occupancy(pot, k, is_f64,
                                                      with_energy,
                                                      n_atoms=8788)
                    print(f"trio_multi plan S={pot.trio_multi_plan[0]} "
                          f"{'f64' if is_f64 else 'f32'} KMAX={k} energy="
                          f"{with_energy}: {plan['registers']} registers, "
                          f"{plan['warps_per_sm']} warps/SM, "
                          f"{plan['local_bytes']} B local")
                    assert plan["local_bytes"] == 0, plan
                    if not is_f64:
                        assert plan["registers"] <= 64, plan
                        assert plan["warps_per_sm"] >= 32, plan


@pytest.mark.cuda
def test_multi_route_launches_once_per_force_call(cuda_device):
    """MDSystem on the fused multi-species route: one kernel launch per
    force call, energy, forces and virial within 1e-10 of the CPU."""
    from uf3_tpu_torch.data.atoms import Atoms
    base = bulk("Ne", "fcc", a=5.4) * 3
    numbers = np.array([10, 18, 54])[np.random.RandomState(5).randint(
        3, size=len(base))]
    geom = Atoms(numbers, base.get_positions(), base.get_cell(), pbc=True)
    geom.rattle(0.08, seed=1)
    model = species_model(["Ne", "Ar", "Xe"])
    out = []
    for device in ("cpu", cuda_device):
        system = MDSystem(model, geom, dtype=torch.float64, device=device)
        assert system._multi_route()
        state = system.init_state()
        launches = multi.trio_multi_partials_all.launches
        out.append(system.energy_forces(state.positions, state.nbr2,
                                        state.nbr3, with_virial=True))
        assert multi.trio_multi_partials_all.launches == launches + (
            device != "cpu")
    for a, b in zip(*out):
        assert _err(a, b) <= 1e-10


# -- the neighbor-gather kernels (csrc/gather.cu) ---------------------------
GATHER_DTYPES = [torch.float32, torch.float64]
INDEX_DTYPES = [torch.int32, torch.int64]


@pytest.mark.cuda
@pytest.mark.parametrize("n, k, w, n_pad", [
    (9826, 16, 3, 2),    # positions at the bench's 3-body rows
    (1001, 23, 5, 7),    # partial-width rows, not a multiple of a block
    (257, 72, 8, 30),    # proto_pallas_gather's table, 72 slots
    (5, 3, 1, 1),
    (8, 1, 128, 0),      # probe_wg.py's P3: one wide row per index
])
@pytest.mark.parametrize("dtype", GATHER_DTYPES)
@pytest.mark.parametrize("index_dtype", INDEX_DTYPES)
def test_gather_rows_kernel_matches_plain(cuda_device, n, k, w, n_pad, dtype,
                                          index_dtype):
    """gather_rows against gather_rows_torch, bit for bit, with
    self-padded slots (a padded slot points at its own row) and the
    transposed (K, N) index; one launch per call."""
    rng = np.random.RandomState(n * 1009 + k * 31 + w)
    table = torch.as_tensor(rng.randn(n, w), dtype=dtype,
                            device=cuda_device)
    idx = rng.randint(0, n, size=(n, k))
    if n_pad:
        idx[:, -n_pad:] = np.arange(n)[:, None]
    idx = torch.as_tensor(idx, dtype=index_dtype, device=cuda_device)
    for index in (idx, idx.t()):
        launches = gather.gather_rows.launches
        out = gather.gather_rows(table, index)
        torch.cuda.synchronize()
        assert gather.gather_rows.launches == launches + 1
        assert torch.equal(out, gather.gather_rows_torch(table, index))
        assert torch.equal(out, table[index.long()])


@pytest.mark.cuda
@pytest.mark.parametrize("a, width, b", [(9856, 16, 16), (257, 1280, 16),
                                         (3, 128, 128), (1001, 23, 7)])
@pytest.mark.parametrize("dtype", GATHER_DTYPES)
@pytest.mark.parametrize("index_dtype", INDEX_DTYPES)
def test_gather_lanes_kernel_matches_plain(cuda_device, a, width, b, dtype,
                                           index_dtype):
    rng = np.random.RandomState(a * 1013 + width * 37 + b)
    t = torch.as_tensor(rng.randn(a, width), dtype=dtype, device=cuda_device)
    li = torch.as_tensor(rng.randint(0, width, size=(a, b)),
                         dtype=index_dtype, device=cuda_device)
    launches = gather.gather_lanes.launches
    out = gather.gather_lanes(t, li)
    torch.cuda.synchronize()
    assert gather.gather_lanes.launches == launches + 1
    assert torch.equal(out, gather.gather_lanes_torch(t, li))
    assert torch.equal(out, torch.gather(t, 1, li.long()))


@pytest.mark.cuda
@pytest.mark.parametrize("n, k, w, n_pad, column", [
    (9826, 16, 5, 2, False),   # the assembly's packed partials
    (1001, 23, 5, 7, False),
    (9856, 16, 1, 0, True),    # probe_dg3.py's table column gather
    (8, 128, 1, 0, True),      # probe_gather2.py's p6
])
@pytest.mark.parametrize("dtype", GATHER_DTYPES)
@pytest.mark.parametrize("index_dtype", INDEX_DTYPES)
def test_rev_gather_kernel_matches_plain(cuda_device, n, k, w, n_pad, column,
                                         dtype, index_dtype):
    rng = np.random.RandomState(n * 1019 + k * 41 + w)
    part = torch.as_tensor(rng.randn(n, k, w), dtype=dtype,
                           device=cuda_device)
    idx = rng.randint(0, n, size=(n, k))
    rev = np.broadcast_to(np.arange(k), (n, k)).copy() if column \
        else rng.randint(0, k, size=(n, k))
    if n_pad:
        idx[:, -n_pad:] = np.arange(n)[:, None]
        rev[:, -n_pad:] = 0
    idx = torch.as_tensor(idx, dtype=index_dtype, device=cuda_device)
    rev = torch.as_tensor(rev, dtype=index_dtype, device=cuda_device)
    launches = gather.rev_gather.launches
    out = gather.rev_gather(part, idx, rev)
    torch.cuda.synchronize()
    assert gather.rev_gather.launches == launches + 1
    assert torch.equal(out, gather.rev_gather_torch(part, idx, rev))
    assert torch.equal(out, part[idx.long(), rev.long()])


def _rev_instance(part):
    """The instance gather_plan gives partials of this width."""
    words = part.shape[-1] * part.element_size() // 4
    if words in gather.ROW_WORDS:
        return f"rev_w{words}"
    return "rev_wide" if words >= gather.WIDE_WORDS else "rev_any"


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 2, 3, 5, 8, 16, 33])
@pytest.mark.parametrize("n", [1, 33, 65, 4099])
@pytest.mark.parametrize("dtype", GATHER_DTYPES)
@pytest.mark.parametrize("index_dtype", INDEX_DTYPES)
def test_rev_gather_instances(cuda_device, w, n, dtype, index_dtype):
    """Each reverse-slot instance (W = 1, 2, 3, 5, 8, 16, 33 elements: 1
    to 66 words a row in float32 and float64, so rev_w*, rev_any and
    rev_wide) bit for bit against the plain version and part[idx, rev],
    on random slots and on the column form (rev = the column), at entry
    counts that leave a tail in a warp's groups and in the last block;
    one launch a call, and the plan names the instance."""
    rng = np.random.RandomState(n * 11 + w)
    r, kp = 97, 11
    part = torch.as_tensor(rng.randn(r, kp, w), dtype=dtype,
                           device=cuda_device)
    idx = torch.as_tensor(rng.randint(0, r, size=n), dtype=index_dtype,
                          device=cuda_device)
    forms = {"random": torch.as_tensor(rng.randint(0, kp, size=n),
                                       dtype=index_dtype, device=cuda_device),
             "column": (torch.arange(n, device=cuda_device) % kp).to(
                 index_dtype)}
    assert gather.rev_plan(part, idx).kernel == _rev_instance(part)
    for form, rev in forms.items():
        launches = gather.rev_gather.launches
        out = gather.rev_gather(part, idx, rev)
        torch.cuda.synchronize()
        assert gather.rev_gather.launches == launches + 1
        assert torch.equal(out, gather.rev_gather_torch(part, idx, rev)), form
        assert torch.equal(out, part[idx.long(), rev.long()]), form


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 4, 5])
@pytest.mark.parametrize("dtype", GATHER_DTYPES)
@pytest.mark.parametrize("index_dtype", INDEX_DTYPES)
def test_rev_gather_misaligned_strided_and_long(cuda_device, w, dtype,
                                                index_dtype):
    """Partials one element past a 16-byte boundary (their data_ptr() not
    16-byte aligned: word loads), index views likewise, partials that
    are not contiguous (the wrapper copies them), and 2^20 + 3 entries
    in the column form (more spans than one wave of warps), each bit for
    bit against the plain version."""
    rng = np.random.RandomState(w * 17 + 3)
    r, kp, n = 211, 16, 3001
    flat = torch.as_tensor(rng.randn(r * kp * w + 1), dtype=dtype,
                           device=cuda_device)
    offset = flat[1:].view(r, kp, w)
    assert offset.data_ptr() % 16 != 0
    strided = torch.as_tensor(rng.randn(r, kp, w + 2), dtype=dtype,
                              device=cuda_device)[..., 1:w + 1]
    assert not strided.is_contiguous()
    raw = torch.as_tensor(rng.randint(0, r, size=n + 1), dtype=index_dtype,
                          device=cuda_device)
    slots = torch.as_tensor(rng.randint(0, kp, size=n + 1),
                            dtype=index_dtype, device=cuda_device)
    for part in (offset, strided):
        for at in (0, 1):
            idx, rev = raw[at:at + n], slots[at:at + n]
            out = gather.rev_gather(part, idx, rev)
            torch.cuda.synchronize()
            assert torch.equal(out, gather.rev_gather_torch(part, idx, rev))
    assert gather.rev_plan(offset, raw).values_align < 16
    m = 2 ** 20 + 3
    long_idx = torch.as_tensor(rng.randint(0, r, size=(m // kp + 1, kp)),
                               dtype=index_dtype, device=cuda_device)
    column = torch.arange(kp, dtype=index_dtype,
                          device=cuda_device).expand_as(long_idx)
    part = offset.contiguous()
    out = gather.rev_gather(part, long_idx.reshape(-1)[:m],
                            column.reshape(-1)[:m])
    torch.cuda.synchronize()
    assert torch.equal(out, gather.rev_gather_torch(
        part, long_idx.reshape(-1)[:m], column.reshape(-1)[:m]))


@pytest.mark.cuda
def test_gather_kernels_on_the_engine_lists(rows, cuda_device):
    """On the rattled 1,024-atom box's 3-body list (padded slots, int64
    as the lists hold them): the positions' row gather and the
    assembly's reverse-slot gather of the trio partials equal what the
    engine gathers (``cached_displacements``' ``positions[idx]``, and
    ``part.reshape(-1, 5)[rev_flat]``)."""
    pot, d, valid, cache, nbr = rows
    assert not bool(nbr.mask.all())
    nbr = nbr._replace(idx=nbr.idx.to(cuda_device),
                       rev=nbr.rev.to(cuda_device))
    x = torch.as_tensor(np.random.RandomState(2).randn(len(nbr.idx), 3),
                        device=cuda_device)
    assert torch.equal(gather.gather_rows(x, nbr.idx), x[nbr.idx])
    _, _, part = trio.trio_partials_torch(d, valid, pot.grid, pot.trio,
                                          False)
    part = part.to(cuda_device)
    rev_flat = cache.rev_flat.to(cuda_device)
    assert torch.equal(gather.rev_gather(part, nbr.idx, nbr.rev),
                       part.reshape(-1, 5)[rev_flat])


@pytest.mark.cuda
def test_gather_kernels_reject_bad_operands(cuda_device):
    """Half-precision values, int16 indices and operands on two devices
    raise before any launch; an empty index launches nothing."""
    t = torch.zeros((6, 4), device=cuda_device)
    idx = torch.zeros((6, 3), dtype=torch.int64, device=cuda_device)
    with pytest.raises(TypeError, match="float32 or float64"):
        gather.gather_rows(t.half(), idx)
    with pytest.raises(TypeError, match="int32 or int64"):
        gather.gather_lanes(t, idx.short())
    with pytest.raises(ValueError, match="different devices"):
        gather.gather_rows(t, idx.cpu())
    launches = gather.gather_rows.launches
    assert gather.gather_rows(t, idx[:0]).shape == (0, 3, 4)
    assert gather.gather_rows.launches == launches


def _rows_case(rng, n_table, n, w, dtype, index_dtype, device):
    """A float (n_table, w) table and n indices into it, on ``device``."""
    table = torch.as_tensor(rng.randn(n_table, w), dtype=dtype,
                            device=device)
    idx = torch.as_tensor(rng.randint(0, n_table, size=n),
                          dtype=index_dtype, device=device)
    return table, idx


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 3, 4, 8])
@pytest.mark.parametrize("n", [1, 6, 33, 63, 65, 127, 129, 511, 513, 4099])
@pytest.mark.parametrize("dtype", GATHER_DTYPES)
@pytest.mark.parametrize("index_dtype", INDEX_DTYPES)
def test_gather_rows_instances(cuda_device, w, n, dtype, index_dtype):
    """Each row-width instance (W = 1, 3, 4, 8 in float32 and float64:
    1 to 16 words a row) bit for bit against the plain version, at entry
    counts that leave a tail in a warp's first or second group of 32
    entries, in the last warp (64 entries) and in the last block (512);
    one launch a call, and the plan names the instance."""
    rng = np.random.RandomState(n * 7 + w)
    table, idx = _rows_case(rng, 997, n, w, dtype, index_dtype, cuda_device)
    plan = gather.rows_plan(table, idx)
    assert plan.kernel == f"rows_w{w * table.element_size() // 4}"
    launches = gather.gather_rows.launches
    out = gather.gather_rows(table, idx)
    torch.cuda.synchronize()
    assert gather.gather_rows.launches == launches + 1
    assert torch.equal(out, gather.gather_rows_torch(table, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 3, 4, 8])
@pytest.mark.parametrize("dtype", GATHER_DTYPES)
@pytest.mark.parametrize("index_dtype", INDEX_DTYPES)
def test_gather_rows_misaligned_and_strided_views(cuda_device, w, dtype,
                                                  index_dtype):
    """A table view one element past a 16-byte boundary (its data_ptr()
    not 16-byte aligned: the instance's word loads), an index view
    likewise, and a view of a wider table that is not contiguous (the
    wrapper copies it), each bit for bit against the plain version and
    ``table[idx]``."""
    rng = np.random.RandomState(w * 13 + 5)
    n_table, n = 1001, 3001
    flat = torch.as_tensor(rng.randn(n_table * w + 1), dtype=dtype,
                           device=cuda_device)
    table = flat[1:].view(n_table, w)
    assert table.data_ptr() % 16 != 0
    raw = torch.as_tensor(rng.randint(0, n_table, size=n + 1),
                          dtype=index_dtype, device=cuda_device)
    wider = torch.as_tensor(rng.randn(n_table, w + 3), dtype=dtype,
                            device=cuda_device)
    for tab, idx in ((table, raw[:n]), (table, raw[1:]),
                     (flat[:n_table * w].view(n_table, w), raw[1:]),
                     (wider[:, 1:w + 1], raw[:n])):
        plan = gather.rows_plan(tab, idx)
        assert plan.values_align == gather.alignment(
            tab.data_ptr() if tab.is_contiguous() else 0,
            w * tab.element_size())
        out = gather.gather_rows(tab, idx)
        torch.cuda.synchronize()
        assert torch.equal(out, gather.gather_rows_torch(tab, idx))
        assert torch.equal(out, tab[idx.long()])
    assert gather.rows_plan(table, raw[1:]).values_align < 16
    assert raw[1:].data_ptr() % 16 != 0


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 3, 4, 5, 8, 33])
@pytest.mark.parametrize("wide", [0, 1])
@pytest.mark.parametrize("dtype", GATHER_DTYPES)
@pytest.mark.parametrize("index_dtype", INDEX_DTYPES)
def test_gather_rows_instances_through_the_c_entry(cuda_device, w, wide,
                                                   dtype, index_dtype):
    """Each row instance with 32-bit offsets and with the 64-bit offsets
    the plan picks only at sizes too large for a test (past 2^31 words),
    launched through the C entry on a small table with tails in the last
    group and warp, bit for bit against the plain version; the C entry
    refuses a code that does not fit the row width."""
    rng = np.random.RandomState(w * 17 + wide)
    table, idx = _rows_case(rng, 513, 2050, w, dtype, index_dtype,
                            cuda_device)
    plan = gather.rows_plan(table, idx)
    out = torch.empty((2050, w), dtype=dtype, device=cuda_device)

    def launch(code):
        return _build.library().uf3_gather_rows(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), 2050, w,
            table.element_size(), idx.element_size(), code, wide,
            plan.values_align, torch.cuda.current_stream().cuda_stream)
    assert launch(plan.code) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, gather.gather_rows_torch(table, idx))
    words = w * table.element_size() // 4
    for code in (words + 1, 0 if words >= 32 else 32):
        assert launch(code) == -1


@pytest.mark.cuda
@pytest.mark.parametrize("w", [5, 33, 128])
@pytest.mark.parametrize("n", [1, 3, 257])
@pytest.mark.parametrize("dtype", GATHER_DTYPES)
@pytest.mark.parametrize("index_dtype", INDEX_DTYPES)
def test_gather_rows_any_instances(cuda_device, w, n, dtype, index_dtype):
    """rows_any and rows_wide, the row widths with no instance of their
    own: below 32 words a warp's span of 32 entries, at 32 or more a warp
    per entry in blocks of two warps (an odd count of entries leaves the
    last block half full); bit for bit against the plain version."""
    rng = np.random.RandomState(w * 11 + n)
    table, idx = _rows_case(rng, 61, n, w, dtype, index_dtype, cuda_device)
    words = w * table.element_size() // 4
    assert gather.rows_plan(table, idx).kernel == (
        "rows_any" if words < 32 else "rows_wide")
    out = gather.gather_rows(table, idx)
    torch.cuda.synchronize()
    assert torch.equal(out, gather.gather_rows_torch(table, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", GATHER_DTYPES)
def test_gather_rows_two_groups_past_two_to_the_twenty(cuda_device, dtype):
    """Past 2^20 entries (the melting protocol's lists) a warp still
    copies two groups of 32 entries, in the plan's W = 3 instance: the
    positions at 2^20 + 77 random entries, bit for bit."""
    rng = np.random.RandomState(20)
    table, idx = _rows_case(rng, 31104, 2 ** 20 + 77, 3, dtype, torch.int64,
                            cuda_device)
    assert gather.rows_plan(table, idx).kernel == (
        f"rows_w{3 * table.element_size() // 4}")
    out = gather.gather_rows(table, idx)
    torch.cuda.synchronize()
    assert torch.equal(out, gather.gather_rows_torch(table, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 5, 16, 32, 33, 128, 1280])
@pytest.mark.parametrize("a, b", [(1001, 16), (37, 7), (9, 45)])
@pytest.mark.parametrize("dtype", GATHER_DTYPES)
@pytest.mark.parametrize("index_dtype", INDEX_DTYPES)
def test_gather_lanes_instances(cuda_device, width, a, b, dtype,
                                index_dtype):
    """The lane gather's warp-shuffle instance (T <= 32) and its
    one-thread-a-output instance (T > 32) bit for bit against the plain
    version, with row counts that leave the last warp and block part
    full and outputs a row that do (not) fill a warp; one launch a
    call."""
    rng = np.random.RandomState(width * 31 + a + b)
    t = torch.as_tensor(rng.randn(a, width), dtype=dtype, device=cuda_device)
    li = torch.as_tensor(rng.randint(0, width, size=(a, b)),
                         dtype=index_dtype, device=cuda_device)
    assert gather.lanes_plan(t, li).kernel == (
        "lanes_shuffle" if width <= 32 else "lanes_direct")
    launches = gather.gather_lanes.launches
    out = gather.gather_lanes(t, li)
    torch.cuda.synchronize()
    assert gather.gather_lanes.launches == launches + 1
    assert torch.equal(out, gather.gather_lanes_torch(t, li))


@pytest.mark.cuda
@pytest.mark.parametrize("kind, width", [("rows", 1), ("rows", 3),
                                         ("rows", 4), ("rows", 8),
                                         ("rows", 5), ("rows", 33),
                                         ("rev", 1), ("rev", 5),
                                         ("rev", 33),
                                         ("lanes", 16), ("lanes", 128)])
@pytest.mark.parametrize("dtype", GATHER_DTYPES)
def test_gather_occupancy_names_the_instance(cuda_device, kind, width,
                                             dtype):
    """Each plan's instance exists in the library, spills nothing and
    has resident warps at its own block size (two warps for rows_wide
    and rev_wide, eight for the others); the row and reverse-slot
    instances stay within 32 KB of shared memory a block."""
    for index_dtype in INDEX_DTYPES:
        size = torch.empty((), dtype=dtype).element_size()
        index = torch.empty((), dtype=index_dtype).element_size()
        plan = gather.gather_plan(kind, (1000, width), (1000, 16), size,
                                  index)
        for wide in (False, True):
            if wide and plan.kernel == "lanes_shuffle":
                continue
            occ = gather.gather_occupancy(plan._replace(wide=wide), size,
                                          index)
            assert occ["kernel"] == plan.kernel
            assert occ["threads"] == (64 if plan.kernel.endswith("_wide")
                                      else 256)
            assert occ["local_bytes"] == 0 and occ["registers"] > 0
            assert occ["warps_per_sm"] >= 8
            assert occ["shared_bytes"] <= 32768


@pytest.mark.cuda
def test_gather_wrappers_launch_on_the_current_stream(cuda_device):
    """Each gather wrapper launches on the current stream: on a side
    stream behind a long kernel (its result read after that stream alone
    is synchronized), and inside a CUDA graph's capture (the replay
    writes the result); bit for bit against the plain versions."""
    rng = np.random.RandomState(41)
    table, idx = _rows_case(rng, 997, 4099, 3, torch.float32, torch.int64,
                            cuda_device)
    t = torch.as_tensor(rng.randn(999, 16), dtype=torch.float32,
                        device=cuda_device)
    li = torch.as_tensor(rng.randint(0, 16, size=(999, 16)),
                         device=cuda_device)
    part = torch.as_tensor(rng.randn(997, 16, 5), device=cuda_device)
    rev = torch.as_tensor(rng.randint(0, 16, size=4099), device=cuda_device)
    calls = {"rows": lambda: gather.gather_rows(table, idx),
             "lanes": lambda: gather.gather_lanes(t, li),
             "rev": lambda: gather.rev_gather(part, idx % 997, rev)}
    refs = {"rows": gather.gather_rows_torch(table, idx),
            "lanes": gather.gather_lanes_torch(t, li),
            "rev": gather.rev_gather_torch(part, idx % 997, rev)}
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(2_000_000)
        outs = {kind: call() for kind, call in calls.items()}
    side.synchronize()
    for kind, out in outs.items():
        assert torch.equal(out, refs[kind]), kind
    graph = torch.cuda.CUDAGraph()
    warm = torch.cuda.Stream()
    warm.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(warm):
        for call in calls.values():
            call()
    torch.cuda.current_stream().wait_stream(warm)
    with torch.cuda.graph(graph):
        outs = {kind: call() for kind, call in calls.items()}
    for out in outs.values():
        out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    for kind, out in outs.items():
        assert torch.equal(out, refs[kind]), kind


@pytest.mark.cuda
def test_gather_plan_codes_have_instances(cuda_device):
    """Python owns the choice of instance and C only dispatches on it:
    every code ``gather_plan`` can give (the row widths of ROW_WORDS, 0
    for rows_any, WIDE_WORDS for rows_wide, and the same for the
    reverse-slot gather's rev_*; the lane groups 2^0..2^5 and -1 for one
    thread per output) has an instance in the library for each element
    and index size and offset width, and no other code has."""
    rows = gather.ROW_WORDS + (0, gather.WIDE_WORDS)
    for elem in (4, 8):
        for index in (4, 8):
            for wide in (False, True):
                for kind, codes in (("rows", rows), ("rev", rows),
                                    ("lanes", (-1, 0, 1, 2, 3, 4, 5))):
                    for code in codes:
                        if kind == "lanes" and code >= 0 and wide:
                            continue
                        plan = gather.GatherPlan(f"{kind}_{code}", code,
                                                 wide, 16)
                        gather.gather_occupancy(plan, elem, index)
                for plan in (gather.GatherPlan("rows_5", 5, wide, 16),
                             gather.GatherPlan("rows_33", 33, wide, 16),
                             gather.GatherPlan("rev_5", 5, wide, 16),
                             gather.GatherPlan("rev_33", 33, wide, 16),
                             gather.GatherPlan("lanes_6", 6, False, 16),
                             gather.GatherPlan("lanes_0", 0, True, 16)):
                    with pytest.raises(RuntimeError, match="-1"):
                        gather.gather_occupancy(plan, elem, index)


# -- the fragment kernels (csrc/fragments.cu) --------------------------------
FRAGMENT_DTYPES = [torch.float32, torch.float64]
CONTRACT_TOL = {torch.float32: 1e-6, torch.float64: 2e-15}


@pytest.mark.cuda
@pytest.mark.parametrize("mode, shape, kw", [
    ("tile", (512, 16), dict(reps=16)),           # probe_mosaic #1, #3
    ("tile", (1001, 7), dict(reps=5)),
    ("tile", (256, 16), dict(reps=16, pair=True)),  # probe_gather2 p5
    ("repeat", (512, 16), dict(reps=16)),         # #2, p5b
    ("repeat", (1001, 7), dict(reps=3)),
    ("reshape", (128, 128), dict(shape=(1024, 16))),   # p2
    ("reshape", (1232, 128), dict(shape=(9856, 16))),
    ("reshape", (33, 7), dict(shape=(7, 33))),
    ("transpose", (16, 128), {}),                 # p3
    ("transpose", (16, 9857), {}),
    ("transpose", (16, 9856), {}),                # p3 at the full system
    ("transpose", (37, 1001), {}),                # tiles ragged both ways
    ("transpose", (1, 4099), {}),
    ("transpose", (4099, 1), {}),
    ("transpose", (64, 96), {}),                  # rows past one tile
    ("select", (8192, 27), dict(k=16, lanes=256)),     # #7, h
    ("select", (1001 * 8, 27), dict(k=8, lanes=64)),
    ("select", (37 * 4, 12), dict(k=4, lanes=29)),
])
@pytest.mark.parametrize("dtype", FRAGMENT_DTYPES)
def test_relayout_kernel_matches_plain(cuda_device, mode, shape, kw, dtype):
    """relayout against relayout_torch, bit for bit, and against the
    library's copy where one call computes it; one launch per call,
    counted under its mode too."""
    rng = np.random.RandomState(sum(shape) * 7 + len(kw))
    x = torch.as_tensor(rng.randn(*shape), dtype=dtype, device=cuda_device)
    launches = fragments.relayout.launches
    by_mode = fragments.relayout.launches_by_mode.get(mode, 0)
    out = fragments.relayout(x, mode, **kw)
    torch.cuda.synchronize()
    assert fragments.relayout.launches == launches + 1
    assert fragments.relayout.launches_by_mode[mode] == by_mode + 1
    assert probe_mosaic.same(out, fragments.relayout_torch(x, mode, **kw))
    library = {"tile": lambda: x.repeat(1, kw.get("reps", 1)),
               "repeat": lambda: x.repeat_interleave(kw.get("reps", 1), 1),
               "reshape": lambda: x.reshape(kw.get("shape")),
               "transpose": lambda: x.t()}.get(mode)
    if library is not None:
        for got in (out if isinstance(out, tuple) else (out,)):
            assert torch.equal(got, library())


@pytest.mark.cuda
@pytest.mark.parametrize("count", [4 * 4929 + 1, 4 * 4929 + 2, 4 * 4929 + 3,
                                   3, 1])
@pytest.mark.parametrize("dtype", FRAGMENT_DTYPES)
def test_relayout_copy_offset_sources(cuda_device, count, dtype):
    """relayout's copy (the reshape) from a source at a 16-byte boundary
    and one and two elements past it, on counts of 4k + 1 .. 4k + 3 and
    below 16 bytes: bit for bit against relayout_torch and the source;
    its launch plan spills nothing."""
    rng = np.random.RandomState(count)
    base = torch.as_tensor(rng.randn(count + 2), dtype=dtype,
                           device=cuda_device)
    assert base.data_ptr() % 16 == 0
    for offset in (0, 1, 2):
        x = base[offset:offset + count]
        launches = fragments.relayout.launches
        out = fragments.relayout(x, "reshape", shape=(count, 1))
        torch.cuda.synchronize()
        assert fragments.relayout.launches == launches + 1
        assert probe_mosaic.same(out, fragments.relayout_torch(
            x, "reshape", shape=(count, 1)))
        assert torch.equal(out.view(-1), x)
    plan = fragments.relayout_occupancy("reshape", dtype)
    assert plan["local_bytes"] == 0 and plan["warps_per_sm"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 128), (16, 9856), (37, 1001),
                                   (1, 4099), (4099, 1), (33, 64),
                                   (5, 1003)])
@pytest.mark.parametrize("dtype", FRAGMENT_DTYPES)
def test_relayout_transpose_views(cuda_device, shape, dtype):
    """The tiled transpose from x one element past a 16-byte boundary
    (its 16-byte loads off: word loads) and from a view that is not
    contiguous (the wrapper copies it), bit for bit against
    relayout_torch and x.t(); one launch a call, counted under
    "transpose"; the transpose kernel's launch plan spills nothing."""
    rows, cols = shape
    rng = np.random.RandomState(rows * 31 + cols)
    flat = torch.as_tensor(rng.randn(rows * cols + 1), dtype=dtype,
                           device=cuda_device)
    offset = flat[1:].view(rows, cols)
    assert offset.data_ptr() % 16 != 0
    wider = torch.as_tensor(rng.randn(rows, cols + 3), dtype=dtype,
                            device=cuda_device)
    for x in (offset, wider[:, 2:cols + 2]):
        launches = fragments.relayout.launches_by_mode.get("transpose", 0)
        out = fragments.relayout(x, "transpose")
        torch.cuda.synchronize()
        assert fragments.relayout.launches_by_mode["transpose"] \
            == launches + 1
        assert probe_mosaic.same(out, fragments.relayout_torch(
            x, "transpose"))
        assert torch.equal(out, x.t())
    plan = fragments.relayout_occupancy("transpose", dtype)
    assert plan["local_bytes"] == 0 and plan["warps_per_sm"] > 0


def _contract_operands(mode, rows, k, dtype, device, seed):
    rng = np.random.RandomState(seed)
    if mode == "matmul":
        x = torch.as_tensor(rng.randn(rows, k), dtype=dtype, device=device)
        w = torch.as_tensor(rng.randn(k, 27 if k == 3 else 13),
                            dtype=dtype, device=device)
        return x, w
    return torch.as_tensor(rng.randn(rows, k * k), dtype=dtype,
                           device=device), None


@pytest.mark.cuda
@pytest.mark.parametrize("mode, rows, k", [
    ("sum_axis2", 512, 16), ("sum_axis2", 1001, 8),    # #8
    ("sum_axis1", 512, 16), ("sum_axis1", 1001, 8),    # #9
    ("matmul", 8192, 3), ("matmul", 1001, 5),          # #6
])
@pytest.mark.parametrize("dtype", FRAGMENT_DTYPES)
def test_lane_contract_kernel_matches_plain(cuda_device, mode, rows, k,
                                            dtype):
    """lane_contract against lane_contract_torch within 1e-6 (float32) of
    the sum of its terms' magnitudes, as the library's sums and product
    (TF32 off); one launch per call."""
    x, w = _contract_operands(mode, rows, k, dtype, cuda_device, rows + k)
    launches = fragments.lane_contract.launches
    out = fragments.lane_contract(x, mode, w)
    torch.cuda.synchronize()
    assert fragments.lane_contract.launches == launches + 1
    ref = fragments.lane_contract_torch(x, mode, w)
    scale = fragments.lane_contract_torch(
        x.abs(), mode, None if w is None else w.abs())
    assert bool(((out - ref).abs() <= CONTRACT_TOL[dtype] * scale).all())
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        library = x @ w if mode == "matmul" else x.view(
            rows, k, k).sum(2 if mode == "sum_axis2" else 1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert bool(((library - ref).abs() <= CONTRACT_TOL[dtype] * scale).all())


@pytest.mark.cuda
@pytest.mark.parametrize("mode, rows, k", [
    ("sum_axis2", 1001, 16), ("sum_axis1", 1001, 16), ("matmul", 8192, 3)])
@pytest.mark.parametrize("dtype", FRAGMENT_DTYPES)
def test_lane_contract_kernel_rounds_as_plain(cuda_device, mode, rows, k,
                                              dtype):
    """The kernel rounds each product and each sum once, in t order, as
    the plain version's torch operations do: the results are equal bit
    for bit."""
    x, w = _contract_operands(mode, rows, k, dtype, cuda_device, 3 * rows)
    out = fragments.lane_contract(x, mode, w)
    assert torch.equal(out, fragments.lane_contract_torch(x, mode, w))


CONTRACT_SHAPES = [("matmul", 3), ("matmul", 5), ("sum_axis2", 16),
                   ("sum_axis2", 3), ("sum_axis1", 16), ("sum_axis1", 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode, k", CONTRACT_SHAPES,
                         ids=[f"{m}-{k}" for m, k in CONTRACT_SHAPES])
@pytest.mark.parametrize("rows", [1, 7, 1057, 12347, 83207])
@pytest.mark.parametrize("aligned", [True, False],
                         ids=["aligned", "misaligned"])
@pytest.mark.parametrize("dtype", FRAGMENT_DTYPES)
def test_lane_contract_kernel_tiles_and_vectors(cuda_device, mode, k, rows,
                                                aligned, dtype):
    """The product's tiles and the sums' 16-byte groups, bit for bit
    against the plain version: M = 1 and few rows (one output a thread),
    12,347 rows (the sums' vectors; the product still one output a
    thread) and 83,207 (the product's tiles), no multiple of a tile or
    of a vector, widths with no 16-byte vector (the 3 x 3 sums), and x at
    an address off 16 bytes (the scalar loads and stores)."""
    x, w = _contract_operands(mode, rows, k, dtype, cuda_device,
                              rows * 7 + k)
    if not aligned:
        flat = torch.empty(x.numel() + 1, dtype=dtype, device=cuda_device)
        flat[1:] = x.reshape(-1)
        x = flat[1:].view(x.shape)
        assert x.data_ptr() % 16 != 0
    launches = fragments.lane_contract.launches
    out = fragments.lane_contract(x, mode, w)
    torch.cuda.synchronize()
    assert fragments.lane_contract.launches == launches + 1
    assert torch.equal(out, fragments.lane_contract_torch(x, mode, w))


@pytest.mark.cuda
@pytest.mark.parametrize("mode, k, rows, kernel", [
    ("matmul", 3, 83207, "tile"), ("matmul", 3, 1057, "rows"),
    ("sum_axis2", 16, 12347, "rows_along_terms"),
    ("sum_axis1", 16, 12347, "rows_along_outputs"),
    ("sum_axis2", 3, 12347, "rows"), ("sum_axis1", 16, 7, "rows")])
@pytest.mark.parametrize("dtype", FRAGMENT_DTYPES)
def test_lane_contract_occupancy_names_its_kernel(cuda_device, mode, k,
                                                  rows, kernel, dtype):
    """lane_contract_occupancy gives the plan of the kernel the wrapper
    launches for the shape (the product's tile, one output a thread, or
    the sums' vectors along the terms or the outputs), launches nothing,
    and every such kernel keeps its registers (0 local bytes) with
    resident warps on each SM."""
    x, w = _contract_operands(mode, rows, k, dtype, cuda_device, rows + k)
    launches = fragments.lane_contract.launches
    plan = fragments.lane_contract_occupancy(x, mode, w)
    assert fragments.lane_contract.launches == launches
    assert plan["kernel"] == kernel
    assert plan["local_bytes"] == 0 and plan["registers"] > 0
    assert 0 < plan["warps_per_sm"] <= 64 and plan["blocks"] > 0


def _map_operands(op, shape, dtype, device, seed):
    """The probe's draws (normal values, indices in [0, 9)) with zeros,
    infinities, NaN, subnormals, huge values and indices outside [0, 9)
    at random places."""
    rng = np.random.RandomState(seed)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    x = rng.randn(*shape).astype(np_dtype)
    edges = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e30, -1.6, 2.0,
             np.finfo(np_dtype).max, 1e-20, np.finfo(np_dtype).tiny / 3,
             -np.finfo(np_dtype).tiny / 7]
    places = rng.permutation(x.size)[:3 * len(edges)]
    x.reshape(-1)[places] = np.resize(np.asarray(edges, np_dtype),
                                      places.size)
    idx = rng.randint(0, 9, size=shape).astype(np.int32)
    idx.reshape(-1)[rng.permutation(idx.size)[:24]] = np.resize(
        [-1, 9, 11, 12, 2 ** 31 - 1, -2 ** 31], 24)
    kw = {"x": torch.as_tensor(x, device=device),
          "idx": torch.as_tensor(idx, device=device),
          "grid": torch.as_tensor(rng.randn(9, 9, 15), dtype=dtype,
                                  device=device)}
    if op == "onehot_count":
        return dict(idx=kw["idx"], dtype=dtype)
    return {name: kw[name] for name in ("x", "idx", "grid")
            if name == "x" or (name == "idx" and op == "onehot_sum")
            or (name == "grid" and op == "grid3")}


@pytest.mark.cuda
@pytest.mark.parametrize("op", list(fragments.LANE_MAP_OPS))
@pytest.mark.parametrize("shape", [(512, 256), (1001, 37)])
@pytest.mark.parametrize("dtype", FRAGMENT_DTYPES)
def test_lane_map_kernel_matches_plain(cuda_device, op, shape, dtype):
    """lane_map against lane_map_torch bit for bit (NaN where it gives
    NaN), edge inputs included: every operation rounds once, subnormals
    are kept, sqrt and division are IEEE; one launch per call."""
    kw = _map_operands(op, shape, dtype, cuda_device, shape[0] + len(op))
    launches = fragments.lane_map.launches
    out = fragments.lane_map(op, **kw)
    torch.cuda.synchronize()
    assert fragments.lane_map.launches == launches + 1
    assert probe_mosaic.same(out, fragments.lane_map_torch(op, **kw))


@pytest.mark.cuda
def test_fragment_kernels_reject_bad_operands(cuda_device):
    """A wrong dtype, a shape the mode does not take, operands on two
    devices and too wide a weight raise before any launch; an empty
    output launches nothing."""
    x = torch.zeros((8, 16), device=cuda_device)
    with pytest.raises(TypeError, match="float32 or float64"):
        fragments.relayout(x.half(), "tile", reps=2)
    with pytest.raises(ValueError, match="select takes"):
        fragments.relayout(x, "select", k=3, lanes=4)
    with pytest.raises(ValueError, match="different devices"):
        fragments.lane_contract(torch.zeros((8, 3), device=cuda_device),
                                "matmul", torch.zeros((3, 27)))
    with pytest.raises(ValueError, match="shared memory"):
        fragments.lane_contract(torch.zeros((8, 3), device=cuda_device),
                                "matmul", torch.zeros((3, 5000),
                                                      device=cuda_device))
    with pytest.raises(ValueError, match="different devices"):
        fragments.lane_map("onehot_sum", x,
                           idx=torch.zeros((8, 16), dtype=torch.int32))
    with pytest.raises(TypeError, match="int32 indices"):
        fragments.lane_map("onehot_count", idx=x.long())
    counts = [fn.launches for fn in fragments.KERNELS.values()]
    assert fragments.relayout(x[:0], "tile", reps=4).shape == (0, 64)
    assert fragments.lane_contract(x[:0], "sum_axis2").shape == (0, 4)
    assert fragments.lane_map("rchain", x[:0]).shape == (0, 16)
    assert counts == [fn.launches for fn in fragments.KERNELS.values()]


# -- the build -----------------------------------------------------------------
FAKE_NVCC = """#!/bin/sh
echo "$@" >> "{log}"
prev=""
for arg in "$@"; do
  if [ "$prev" = "-o" ]; then touch "$arg"; fi
  prev="$arg"
done
"""


VARIANT_PATCHES = sorted(glob.glob(os.path.join(
    REPO, "benchmarks_data", "artifacts_torch", "kernel_variants",
    "*.patch")))


@pytest.mark.parametrize("patch", VARIANT_PATCHES,
                         ids=[os.path.basename(p)[:-6]
                              for p in VARIANT_PATCHES])
def test_kernel_variant_patch_applies(tmp_path, patch):
    """Each committed variant of the kernels' sources (a unified diff
    against csrc/, built and timed by benchmarks/kernel_variants.py)
    applies to a copy of csrc/ as it stands and changes the one source
    its name gives (the longest source name that, with "_", begins it);
    a hunk that does not match raises."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    with open(patch) as f:
        text = f.read()
    kernel_variants.apply_patch(text, str(csrc))
    changed = [name for name in sorted(os.listdir(csrc))
               if (csrc / name).read_text()
               != open(os.path.join(_build.CSRC, name)).read()]
    source = max((name for name in os.listdir(_build.CSRC)
                  if name.endswith(".cu")
                  and os.path.basename(patch).startswith(name[:-3] + "_")),
                 key=len)
    assert changed == [source]
    with pytest.raises(ValueError, match="does not apply"):
        kernel_variants.apply_patch(text, str(csrc))


def test_kernel_variants_need_the_card():
    with pytest.raises(RuntimeError, match="on the card"):
        kernel_variants.main("trio", [("as_is", None)], device="cpu")


def test_build_tracks_sources_and_headers(tmp_path, monkeypatch):
    """The library is rebuilt when a source or a header is newer than
    it, by one nvcc per source, started together, and one link of their
    objects (a stand-in nvcc that logs its arguments and touches its
    output), and not otherwise; no object is left behind."""
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    for name in ("a.cu", "b.cu", "common.cuh"):
        (csrc / name).write_text("")
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(log=log))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD", str(build))
    monkeypatch.setattr(_build, "LIBRARY", str(build / "lib.so"))
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    assert _build.build()["built"]
    calls = [line.split() for line in log.read_text().splitlines()]
    compiles, link = calls[:2], calls[2]
    assert sorted(c[-1] for c in compiles) == [str(csrc / "a.cu"),
                                               str(csrc / "b.cu")]
    assert all("-c" in c and "-shared" not in c for c in compiles)
    assert "-shared" in link
    assert sorted(link[-2:]) == sorted(c[c.index("-o") + 1]
                                       for c in compiles)
    assert os.listdir(build) == ["lib.so"]
    assert not _build.build()["built"]
    later = time.time() + 100
    os.utime(csrc / "common.cuh", (later, later))
    assert _build.build()["built"]
    assert len(log.read_text().splitlines()) == 6
